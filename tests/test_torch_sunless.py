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
  * check_supported: 5 suns and 5 noise media baked at the low rate raise
    NotImplementedError by name, on the whole grid and in an H-sharded
    slab, as does the gather reprojection in a slab; texture media and
    scenes without a sun or media render in a slab.

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
# what the port still refuses
# --------------------------------------------------------------------------

def _bench(**kw):
    return vt.benchmark_scene(aspect=ASPECT, num_local_lights=4,
                              device="cpu", **kw)


def _five_suns(scene):
    dl = scene.dir_lights
    return dataclasses.replace(scene, dir_lights=dataclasses.replace(
        dl, **{f.name: torch.cat([getattr(dl, f.name)] * 5)
               for f in dataclasses.fields(dl)}))


def _refused(name):
    """(scene, config changes, the scene it is made from where a slab
    renders that one): a slab case is a scene that renders in a slab since
    the slab forms were ported, with one part that a slab still refuses."""
    scene = _bench(noise_mode="procedural")
    if name == "texture_slab":
        tex = _bench(noise_tex=perlin_texture_3d(8))
        return dataclasses.replace(tex, media=(tex.media[0],) * 5), {}, tex
    if name == "sunless_slab":
        sunless = dataclasses.replace(scene,
                                      dir_lights=cut(scene.dir_lights))
        return sunless, dict(reproj_impl="gather"), sunless
    if name == "no_media_slab":
        no_media = dataclasses.replace(scene, media=())
        return _five_suns(no_media), {}, no_media
    if name == "five_suns":
        return _five_suns(scene), {}, None
    fog = scene.media[0]
    return dataclasses.replace(scene, media=(fog,) * 5), {}, None


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
    """What the port still refuses: five suns, five noise media baked at
    the low rate, and in a slab what the JAX package refuses there (the
    gather reprojection). Texture media and scenes without a sun or media
    render in slabs since the slab forms were ported (their ids name the
    refusals they held before): each slab case's scene renders in a slab
    once its refused part is taken away."""
    scene, kw, renders = _refused(name)
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG,
                                                  **SMALL, **kw),
                              device="cpu")
    slab = Slab(0.0, 0, (16, 15, 16), 120) if renders is not None else None
    with pytest.raises(NotImplementedError, match=match):
        r.check_supported(scene, slab)
    with pytest.raises(NotImplementedError, match=match):
        r.render_frame(r.init_state(1), scene, 0.0, slab=slab)
    if renders is None:
        return
    # the scene it is made from renders in a slab (of the whole grid)
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                              device="cpu")
    sc, vd = r.render_scene_inputs(renders)
    img, _, _ = r.render_frame(r.init_state(1), renders, 0.0, sc, vd,
                               slab=slab)
    assert bool(torch.isfinite(img).all())
