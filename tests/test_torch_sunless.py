"""Scenes without a sun or without media, demo.py's texture-noise frame, and
what the port still refuses, against the JAX package on the CPU:

  * frames of VolumetricRenderer(device="cpu") against the JAX
    render_frame under jax.jit, FULL_CONFIG at a 16x15x16 grid and 128x120
    pixels on JAX's G-buffer, 2 frames with a moving camera, on
    benchmark_scene (4 local lights, procedural noise): without its sun
    (the staged route JAX takes, as its fused kernel needs a sun: no K5 or
    K7, a shadow volume of ones blended on K10's twin, K1 and K6 with no
    sun term, K3) and without media (K5, the visibility bake K9, K6 baked x
    planes over zero material volumes, K3);
  * demo.py --noise's frame: DEMO_CONFIG on demo_scene(with_noise=True)
    with an 8^3 perlin_texture_3d and the terrain cut to 4 steps of 1
    octave (tests/test_torch_xla_scatter.py's cut), at a 16x11x12 grid and
    128x90 pixels, on JAX's G-buffer and shadow maps, JAX run op by op
    (jax.disable_jit) as that file runs it, 2 frames;
  * what check_supported refused: 5 suns and 5 noise media baked at the
    low rate render on the whole grid; five texture media, and five suns
    without media, render in H-sharded slabs, their interior rows the
    port's whole-grid frame; the gather reprojection in a slab still
    raises NotImplementedError by name.

Tolerance tests/torch_tolerance.assert_boundary_close, a mean absolute
image error of at most 1e-5 of the image maximum, and for demo_scene's sun
shadow the gather sampler's class of tests/test_torch_xla_scatter.py (at
most 5e-3 of the froxels past 1e-5 absolute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import DEMO_CONFIG as J_DEMO
from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo
from volumetricrenderer_tpu.ops import noise as j_noise
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.convert import (scene_from_numpy,
                                                  shadow_data_from_numpy)
from volumetricrenderer_tpu_torch.ops.noise import perlin_texture_3d
from volumetricrenderer_tpu_torch.parallel import shard_render as t_sr
from volumetricrenderer_tpu_torch.parallel.shard_render import Slab
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
ASPECT = 128 / 120
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def cut(lights):
    """A light set (either package's) with every light removed."""
    return dataclasses.replace(lights, **{
        f.name: getattr(lights, f.name)[:0]
        for f in dataclasses.fields(lights)})


def sampler_close(got, want, msg, share=5e-3, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), msg
    past = (np.abs(got - want) > atol).mean()
    assert past <= share, (msg, past, np.abs(got - want).max())


# --------------------------------------------------------------------------
# scenes without a sun or without media
# --------------------------------------------------------------------------

SCENES = {
    "sunless": lambda s: dataclasses.replace(s, dir_lights=cut(s.dir_lights)),
    "no_media": lambda s: dataclasses.replace(s, media=()),
}


@pytest.fixture(scope="module", params=list(SCENES))
def frames(request):
    base = SCENES[request.param](j_bench(aspect=ASPECT, num_local_lights=4,
                                         noise_mode="procedural"))
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=ASPECT)) for p, f in CAMERAS]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL))
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                               device="cpu")
    gbuf = jax.jit(jr.render_scene_inputs)

    def jstep(s, sc, t, c, d):
        img, aux, s = jr.render_frame(s, sc, t, scene_color=c, view_depth=d)
        return img, aux["scatter"], aux["shadow"], s

    jstep = jax.jit(jstep)
    nd = base.dir_lights.count
    st, ts = jr.init_state(nd), tr.init_state(nd)
    out = []
    for i, sc in enumerate(scenes):
        c, d = (np.array(a) for a in gbuf(sc))
        jimg, jsc, jsh, st = jstep(st, sc, jnp.float32(0.1 * i), c, d)
        timg, taux, ts = tr.render_frame(
            ts, scene_from_numpy(sc, "cpu"), np.float32(0.1 * i), t_(c),
            t_(d))
        out.append((np.asarray(jimg), np.asarray(jsc), np.asarray(jsh),
                    timg.numpy(), taux))
    t_scene = scene_from_numpy(scenes[0], "cpu")
    return (request.param, tr, t_scene, out, st, ts, jr.config.grid_dhw)


def test_frames_match_jax(frames):
    name, tr, t_scene, out, st, ts, dhw = frames
    assert not tr.fuses_frame(t_scene)
    for i, (jimg, jsc, jsh, timg, taux) in enumerate(out):
        assert timg.shape == jimg.shape == (120, 128, 4)
        assert_boundary_close(timg, jimg, f"{name} image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
        assert_boundary_close(taux["scatter"].permute(1, 2, 3, 0).numpy(),
                              jsc, f"{name} scatter {i}")
        assert taux["shadow"].shape == jsh.shape == (1, 16, 15, 16)
        assert_boundary_close(taux["shadow"].numpy(), jsh,
                              f"{name} shadow {i}")
    assert ts.frame_count == 2
    assert_boundary_close(t_packed(ts.prev_accumulation).numpy(),
                          np.asarray(packed_accumulation(st.prev_accumulation,
                                                         dhw)),
                          f"{name} accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          f"{name} shadow history")
    assert out[-1][3][..., :3].std() > 1e-3


def test_routes(frames):
    """The tables and passes each scene takes: no sun packs no sun table
    and its shadow volume is ones (no shadow ray); no media bakes the
    per-light visibility (a light schedule, no noise channel) and scatters
    over zero material volumes, with no extinction."""
    name, tr, t_scene, out, _, ts, _ = frames
    t, _, _ = tr.frame_tables(tr.init_state(1), t_scene, 0.0)
    taux = out[-1][4]
    if name == "sunless":
        assert t.n_dir == 0 and t.slights is None and t.dirs is None
        assert t.local_source == "radiance" and t.n_noise == 1
        assert tr.bakes_noise(t_scene)
        # no sun adds no extinction (the JAX pass adds it once per sun)
        assert float(taux["scatter"][3].abs().max()) == 0.0
    else:
        assert t.n_dir == 1 and t.med is None and t.n_noise == 0
        assert t.local_source == "baked" and not tr.bakes_noise(t_scene)
        assert float(taux["material_a"].abs().max()) == 0.0
        assert float(taux["scatter"][:3].abs().max()) == 0.0


# --------------------------------------------------------------------------
# demo.py --noise: DEMO_CONFIG on demo_scene(with_noise=True)
# --------------------------------------------------------------------------

FRAME = dict(volume_width=16, volume_height=11, volume_depth=12,
             image_width=128, image_height=90, shadow_map_size=64)


def test_demo_noise_frames_match_jax():
    jr = JRenderer(dataclasses.replace(J_DEMO, **FRAME))
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.DEMO_CONFIG, **FRAME),
                               device="cpu")
    base = j_demo(aspect=128 / 90, with_noise=True,
                  noise_tex=jnp.asarray(j_noise.perlin_texture_3d(8)))
    base = dataclasses.replace(base, geometry=dataclasses.replace(
        base.geometry, hf_steps=4, hf_octaves=1))
    # the port's demo_scene carries the same texture
    t_demo = vt.demo_scene(aspect=128 / 90, with_noise=True,
                           noise_tex=perlin_texture_3d(8), device="cpu")
    np.testing.assert_array_equal(t_demo.media[0].noise_tex.numpy(),
                                  np.asarray(base.media[0].noise_tex))
    maps = jax.jit(jr.bake_shadow_data)(base)
    t_maps = shadow_data_from_numpy(maps, "cpu")
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=128 / 90)) for p, f in CAMERAS]
    gbuf = jax.jit(jr.render_scene_inputs)
    st, ts = jr.init_state(1), tr.init_state(1)
    for i, sc in enumerate(scenes):
        c, d = (np.array(a) for a in gbuf(sc))
        with jax.disable_jit():
            jimg, jaux, st = jr.render_frame(
                st, sc, jnp.float32(0.1 * i), scene_color=c, view_depth=d,
                shadow_data=maps)
        timg, taux, ts = tr.render_frame(
            ts, scene_from_numpy(sc, "cpu"), np.float32(0.1 * i), t_(c),
            t_(d), shadow_data=t_maps)
        jimg, timg = np.asarray(jimg), timg.numpy()
        assert timg.shape == jimg.shape == (90, 128, 4)
        assert_boundary_close(timg, jimg, f"demo noise image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
        assert_boundary_close(taux["material_a"].permute(1, 2, 3, 0).numpy(),
                              jaux["material_a"], f"material {i}")
        sampler_close(taux["shadow"].numpy(), jaux["shadow"], f"shadow {i}")
    # the texture varies the fog's density
    assert float(taux["material_a"][3].std()) > 1e-6
    assert_boundary_close(
        t_packed(ts.prev_accumulation).numpy(),
        np.asarray(packed_accumulation(st.prev_accumulation, (12, 11, 16))),
        "demo noise accumulation history")


# --------------------------------------------------------------------------
# what the port still refuses, and the scenes it refused before
# --------------------------------------------------------------------------

def _bench(**kw):
    return vt.benchmark_scene(aspect=ASPECT, num_local_lights=4,
                              device="cpu", **kw)


def _five_suns(scene):
    dl = scene.dir_lights
    return dataclasses.replace(scene, dir_lights=dataclasses.replace(
        dl, **{f.name: torch.cat([getattr(dl, f.name)] * 5)
               for f in dataclasses.fields(dl)}))


# The slab cases' grid: 24 froxel rows (whole rows of the radiance bake's
# low grid at ss = 4) at 4 image rows a froxel row, in 3 slabs of 8 rows
# with a halo of 5 rows
SLAB = dict(volume_width=16, volume_height=24, volume_depth=16,
            image_width=128, image_height=96)
SLAB_N, SLAB_HALO = 3, 5


def _unported(name):
    """(scene, config changes, where it renders): "slab" for a scene that
    renders in slabs since the slab forms were ported, "grid" for one that
    renders on the whole grid since any number of suns and noise media
    does, None for what the port still refuses."""
    scene = _bench(noise_mode="procedural")
    if name == "texture_slab":
        tex = _bench(noise_tex=perlin_texture_3d(8))
        return dataclasses.replace(tex, media=(tex.media[0],) * 5), {}, \
            "slab"
    if name == "sunless_slab":
        sunless = dataclasses.replace(scene,
                                      dir_lights=cut(scene.dir_lights))
        return sunless, dict(reproj_impl="gather"), None
    if name == "no_media_slab":
        no_media = dataclasses.replace(scene, media=())
        return _five_suns(no_media), {}, "slab"
    if name == "five_suns":
        return _five_suns(scene), {}, "grid"
    fog = scene.media[0]
    return dataclasses.replace(scene, media=(fog,) * 5), {}, "grid"


def _interior_rows(cfg):
    """The image rows whose composite reads froxel rows 3 .. H - 4 alone:
    there a slab's frame is the whole grid's (at the grid's top and bottom
    a slab's low-rate bake clamps against its own halo rows, the JAX
    package's slab semantics)."""
    h, ih = cfg.volume_height, cfg.image_height
    return [r for r in range(ih)
            if 3 <= (r + 0.5) * h / ih - 0.5 <= h - 4]


@pytest.mark.parametrize("name, match", [
    ("texture_slab", "5 noise media"),
    ("sunless_slab", "reproj_impl='gather' in a slab"),
    ("no_media_slab", "5 directional lights"),
    ("five_suns", "5 directional lights"),
    ("five_noise_media", "5 noise media"),
], ids=["texture_slab-texture-noise media in a slab",
        "sunless_slab-without a sun in a slab",
        "no_media_slab-without media or without a sun in a slab",
        "five_suns-5 directional lights", "five_noise_media-5 noise media"])
def test_unported_scenes_raise(name, match):
    """What the port refused, and what it still refuses: in a slab what the
    JAX package refuses there (the gather reprojection) raises
    NotImplementedError by name. The ids name the refusals each case held
    before: five suns and five noise media baked at the low rate (the
    fused frame's tables: five fBm channels) render on the whole grid since
    the kernels take any number of suns and noise media, with as many
    shadow channels and noise channels; five texture media, and five suns
    without media, render in slabs (make_multislab_render, 3 slabs, 2
    frames with a moving camera), their interior rows the port's
    whole-grid frame at rtol 1e-4 / atol 1e-5 (tests/test_torch_slab.py's
    class for slabs against the whole grid) and every row within 2e-2 of
    the image maximum (the slab edge's class). `match` is the message of
    the refusal each case held (the one that stays raises it)."""
    scene, kw, renders = _unported(name)
    if renders is None:
        r = vt.VolumetricRenderer(dataclasses.replace(
            vt.FULL_CONFIG, **SMALL, **kw), device="cpu")
        slab = Slab(0.0, 0, (16, 15, 16), 120)
        with pytest.raises(NotImplementedError, match=match):
            r.check_supported(scene, slab)
        with pytest.raises(NotImplementedError, match=match):
            r.render_frame(r.init_state(1), scene, 0.0, slab=slab)
        return
    nd = scene.dir_lights.count
    cfg = dataclasses.replace(vt.FULL_CONFIG,
                              **(SLAB if renders == "slab" else SMALL), **kw)
    r = vt.VolumetricRenderer(cfg, device="cpu")
    r.check_supported(scene)
    scenes = [dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, position=scene.camera.position
        + torch.tensor([0.1, 0.05, 0.3]) * i)) for i in range(2)]
    st = r.init_state(nd)
    if renders == "grid":
        for i, s in enumerate(scenes):
            img, aux, st = r.render_frame(st, s, 0.1 * i)
        t, _, _ = r.frame_tables(st, scene, 0.0)
        assert r.fuses_frame(scene) and t.local_source == "radiance"
        assert (t.n_dir, t.n_noise) == ((5, 1) if name == "five_suns"
                                        else (1, 5))
        assert aux["shadow"].shape == st.prev_shadow.shape == (nd, 16, 15,
                                                               16)
        assert bool(torch.isfinite(img).all())
        assert float(img[..., :3].std()) > 1e-3
        return
    r.check_supported(scene, Slab(0.0, 0, (16, 24, 16), 96))
    fn = t_sr.make_multislab_render(r, SLAB_N, SLAB_HALO)
    carry = fn.init_carry(nd)
    rows = _interior_rows(cfg)
    assert len(rows) > cfg.image_height // 2
    for i, s in enumerate(scenes):
        sc, vd = r.render_scene_inputs(s)
        want, _, st = r.render_frame(st, s, 0.1 * i, sc, vd)
        bands, carry = fn(carry, s, 0.1 * i, list(sc.chunk(SLAB_N)),
                          list(vd.chunk(SLAB_N)))
        got = torch.cat(bands)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got[rows], want[rows], rtol=1e-4,
                                   atol=1e-5, msg=f"{name} frame {i}")
        assert float((got - want).abs().max()) \
            <= 2e-2 * float(want.abs().max())
    assert float(want[..., :3].std()) > 1e-3
