"""Texture-noise media in the port against the JAX package on the CPU:

  * ops/noise.perlin_texture_3d against JAX's numpy bake at sizes 8 and 32,
    bit for bit;
  * ops/sampling.trilinear_sample_3d(wrap=True) against JAX's on the
    random texture and positions of tests/test_texture_fold.py (an
    8x16x32 texture, positions in [-40, 40)): rtol 1e-5 / atol 1e-6;
  * ops/visibility.bake_noise_channels on mixed media (a texture medium,
    a procedural one and one without noise: the channel order) against
    JAX's bake_noise_channels_xla with its selection-matmul sampler at
    precision="highest", rtol 1e-5 / atol 1e-6; and against JAX's default
    sampler, whose operands are bf16, at that sampler's own bound in
    tests/test_texture_fold.py (rtol 0.02, atol 0.01): the gap is JAX's
    (ROADMAP, "Known reference behaviour"), not a tolerance of the port;
  * pipeline.write_material_volumes with a texture medium at
    texture_noise_subsample 1 and 2 (the low-rate sample, tent-upsampled):
    rtol 1e-5 / atol 1e-6;
  * the fused texture frame's tables: K1 is launched with no noise channel,
    K2 reads one per noise-bearing medium (pure Python);
  * frames of VolumetricRenderer(device="cpu") against the JAX
    render_frame under jax.jit at a 16x15x16 grid and 128x120 pixels, on
    JAX's G-buffer, 2 frames with a moving camera: FULL_CONFIG on the mixed
    media (the fused frame: K1's radiance, the noise channels from
    bake_noise_channels, K2, K3, K4's twins; JAX's sampler at
    "highest"), and FULL_CONFIG with frame_fused=False and
    texture_noise_subsample=2 on benchmark_scene's texture fog (the staged
    frame: plain material volumes, K5, K1, K6 radiance x planes, K3).
    Tolerance tests/torch_tolerance.assert_boundary_close, and a mean
    absolute image error of at most 1e-5 of the image maximum.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.media import Medium as JMedium
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops import noise as j_noise
from volumetricrenderer_tpu.ops import sampling as j_sampling
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as tpipeline
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import noise as t_noise
from volumetricrenderer_tpu_torch.ops import sampling as t_sampling
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
GRID = (16, 15, 16)
ASPECT = 128 / 120
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
TIME_X = 0.3
SS = 4
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def mixed_scene():
    """benchmark_scene (4 local lights) with three media: the fog sampling
    an 8^3 noise texture, a procedural-noise box, and the ground fog
    without noise."""
    base = j_bench(aspect=ASPECT, num_local_lights=4,
                   noise_tex=jnp.asarray(j_noise.perlin_texture_3d(8)),
                   noise_mode="texture")
    proc = JMedium.create(
        scattering_color=(0.6, 0.7, 0.9), absorption=0.4, phase_g=0.2,
        noise_mode="procedural", noise_tiling=(0.05, 0.04, 0.05),
        noise_scroll=(2.0, 0.0, 1.0), volume_type="box",
        blend_type="additive", box_min=(-20.0, 0.0, -10.0),
        box_max=(20.0, 8.0, 30.0), box_softness=2.0)
    fog, ground = base.media
    return dataclasses.replace(base, media=(fog, proc, ground))


@functools.lru_cache(maxsize=1)
def _geometry():
    js = mixed_scene()
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    ts = scene_from_numpy(js, "cpu")
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    return js, ts, jp, tp


def cfgs(**kw):
    return (dataclasses.replace(J_FULL, **SMALL, **kw),
            dataclasses.replace(vt.FULL_CONFIG, **SMALL, **kw))


# --------------------------------------------------------------------------
# the texture, its sampler and the noise channels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", [8, 32])
def test_perlin_texture_3d_matches_jax(size):
    want = j_noise.perlin_texture_3d(size)
    got = t_noise.perlin_texture_3d(size)
    assert got.shape == want.shape == (size,) * 3
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_trilinear_matches_jax():
    rng = np.random.RandomState(11)
    tex = rng.rand(8, 16, 32).astype(np.float32)
    pos = rng.rand(7, 9, 3).astype(np.float32) * 80.0 - 40.0
    want = np.asarray(j_sampling.trilinear_sample_3d(
        jnp.asarray(tex), jnp.asarray(pos), wrap=True))
    p = torch.as_tensor(pos)
    got = t_sampling.trilinear_sample_3d(torch.as_tensor(tex)[None],
                                         p[..., 0], p[..., 1], p[..., 2],
                                         wrap=True)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the clamp mode is what it was: the edge texel past the border
    clamped = t_sampling.trilinear_sample_3d(
        torch.as_tensor(tex)[None], torch.full((1,), 40.0),
        torch.full((1,), -3.0), torch.full((1,), 9.5))[0]
    assert float(clamped[0]) == float(tex[7, 0, 31])


def test_bake_noise_channels_matches_jax(monkeypatch):
    js, ts, jp, tp = _geometry()
    jcfg, tcfg = cfgs()
    args = lambda s, p: (p, s.camera.view_to_world())

    def jax_bake():
        return np.asarray(jax.jit(lambda m: j_vis.bake_noise_channels_xla(
            jcfg, *args(js, jp), jnp.asarray(JIT), m, TIME_X, SS))(
                js.media))

    got = t_vis.bake_noise_channels(tcfg, *args(ts, tp), t_(JIT), ts.media,
                                    TIME_X, SS).numpy()
    assert got.shape == (2, 4, 4, 4)         # the texture, the procedural
    bf16 = jax_bake()
    orig = j_vis.sample_tex_selection
    monkeypatch.setattr(j_vis, "sample_tex_selection",
                        functools.partial(orig, precision="highest"))
    exact = jax_bake()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, bf16, rtol=0.02, atol=0.01)
    # the channels are not flat, and the texture's differs from the fBm's
    assert got[0].std() > 1e-3 and got[1].std() > 1e-3
    assert np.abs(got[0] - got[1]).max() > 1e-2


@pytest.mark.parametrize("sub", [1, 2])
def test_write_material_volumes_texture_matches_jax(sub):
    js, ts, jp, tp = _geometry()
    jcfg, tcfg = cfgs(texture_noise_subsample=sub)
    ja, jb = jax.jit(lambda m: jpipeline.write_material_volumes(
        jcfg, jp, js.camera.view_to_world(), jnp.asarray(JIT), TIME_X, m))(
            js.media)
    ta, tb = tpipeline.write_material_volumes(
        tcfg, tp, ts.camera.view_to_world(), t_(JIT), TIME_X, ts.media)
    np.testing.assert_allclose(ta.permute(1, 2, 3, 0).numpy(), ja,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb)[..., 0],
                               rtol=1e-5, atol=1e-6)
    assert float(ta[3].std()) > 1e-6


def test_fused_texture_frame_tables():
    """The fused texture frame packs a noise channel per noise-bearing
    medium for K2 and hands K1 tables without any (ops/frame_fused
    k1_tables), so that K1 writes the radiance alone; the staged frame
    bakes none, and a wrong noise volume is refused."""
    _, ts, _, _ = _geometry()
    _, tcfg = cfgs()
    r = vt.VolumetricRenderer(tcfg, device="cpu")
    assert r.fuses_frame(ts) and r.bakes_noise(ts)
    t, _, _ = r.frame_tables(r.init_state(1), ts, 0.0)
    assert t.texture_noise and t.n_noise == 2
    k1 = t_ff.k1_tables(t)
    assert k1.n_noise == 0 and k1.c_struct().n_noise == 0
    assert t.c_struct().n_noise == 2
    assert t_ff.k1_geometry(4, k1.n_noise, t.low_dims) \
        == t_ff.k1_geometry(4, 0, t.low_dims)
    with pytest.raises(ValueError, match="noise channels"):
        t_ff.bake_radiance(t)
    with pytest.raises(ValueError, match="noise channels"):
        t_ff.bake_radiance(t, torch.zeros((1,) + t.low_dims[::-1]))
    noise = torch.rand((2,) + t.low_dims[::-1])
    bake = t_ff.bake_radiance(t, noise)
    assert bake.shape == (5,) + t.low_dims[::-1]
    torch.testing.assert_close(bake[3:], noise, rtol=0, atol=0)
    torch.testing.assert_close(bake[:3], t_ff.bake_radiance_plain(k1),
                               rtol=0, atol=0)
    # with a texture the fused frame bakes every noise medium's channel,
    # bake_procedural_noise or not (the JAX frame does)
    r_off = vt.VolumetricRenderer(cfgs(bake_procedural_noise=False)[1],
                                  device="cpu")
    assert r_off.frame_tables(r_off.init_state(1), ts, 0.0)[0].n_noise == 2
    staged = vt.VolumetricRenderer(cfgs(frame_fused=False)[1], device="cpu")
    assert not staged.fuses_frame(ts) and not staged.bakes_noise(ts)
    t2, _, _ = staged.frame_tables(staged.init_state(1), ts, 0.0)
    assert t2.n_noise == 0 and t_ff.k1_tables(t2).n_noise == 0
    # the texture folds into the fused frame only on the radiance bake
    for kw in (dict(scatter_bake="vis"), dict(raycast_shadow_subsample=1)):
        assert not vt.VolumetricRenderer(cfgs(**kw)[1],
                                         device="cpu").fuses_frame(ts)


# --------------------------------------------------------------------------
# frames against JAX render_frame
# --------------------------------------------------------------------------

FRAMES = {
    # the fused frame on the mixed media, JAX's sampler exact
    "fused": (dict(), "mixed"),
    # the staged frame on benchmark_scene's texture fog, the texture sampled
    # at half rate in the material volumes
    "staged": (dict(frame_fused=False, texture_noise_subsample=2), "fog"),
}


@pytest.fixture(scope="module", params=list(FRAMES))
def frames(request):
    kw, which = FRAMES[request.param]
    if which == "mixed":
        base = mixed_scene()
    else:
        base = j_bench(aspect=ASPECT, num_local_lights=4,
                       noise_tex=jnp.asarray(j_noise.perlin_texture_3d(8)),
                       noise_mode="texture")
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=ASPECT)) for p, f in CAMERAS]
    jcfg, tcfg = cfgs(**kw)
    jr = JRenderer(jcfg)
    tr = vt.VolumetricRenderer(tcfg, device="cpu")
    gbuf = jax.jit(jr.render_scene_inputs)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_vis, "sample_tex_selection", functools.partial(
            j_vis.sample_tex_selection, precision="highest"))
        step = jax.jit(lambda s, sc, t, c, d: jr.render_frame(
            s, sc, t, scene_color=c, view_depth=d)[::2])
        st, ts = jr.init_state(1), tr.init_state(1)
        for i, sc in enumerate(scenes):
            c, d = (np.array(a) for a in gbuf(sc))
            jimg, st = step(st, sc, jnp.float32(0.1 * i), c, d)
            timg, _, ts = tr.render_frame(
                ts, scene_from_numpy(sc, "cpu"), np.float32(0.1 * i), t_(c),
                t_(d))
            out.append((np.asarray(jimg), timg.numpy()))
    fused = tr.fuses_frame(scene_from_numpy(scenes[0], "cpu"))
    return request.param, fused, out, st, ts, jr.config.grid_dhw


def test_texture_frames_match_jax(frames):
    name, fused, out, st, ts, dhw = frames
    assert fused == (name == "fused")
    for i, (jimg, timg) in enumerate(out):
        assert timg.shape == jimg.shape == (120, 128, 4)
        assert_boundary_close(timg, jimg, f"{name} image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
    assert ts.frame_count == 2
    assert_boundary_close(t_packed(ts.prev_accumulation).numpy(),
                          np.asarray(packed_accumulation(st.prev_accumulation,
                                                         dhw)),
                          f"{name} accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          f"{name} shadow history")
    assert out[-1][1][..., :3].std() > 1e-3
