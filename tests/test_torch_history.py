"""The port's history frame (material, scatter and standalone blends; the
per-light visibility bake) against the JAX package, Pallas in interpret
mode, on the CPU, where each kernel wrapper takes its plain-torch twin:

  * the twins of kernels K9 (bake_visibility), K10 (temporal_blend, both
    modes) and K11 (windowed_warp) and of K6's new modes (baked visibility,
    material volumes) against the JAX functions they stand for, on
    benchmark_scene (4 local lights, procedural noise) at a 16x15x16 grid
    with a moved previous camera and numpy-seeded volumes;
  * the plain passes (write_material_volumes, shift_sample_3d,
    accumulate_blocked, perlin_3d, the four temporal_blend_*) against their
    JAX functions under jax.jit;
  * the slice as a whole: VolumetricRenderer(device="cpu") against the JAX
    render_frame over frames with a moving camera for the `history`
    configuration (FULL_CONFIG with frame_fused=False, scatter_bake="vis"
    and the material and scatter blends on), `vis_bake` (the first two
    changes only) and `xla_shadow` (history with dir_shadow_impl="xla"), at
    128x120 pixels: images, all four histories and aux;
  * the two identities the kernels are built on, at twin level: shadow then
    weight blend = fused shadow blend, integrate then alpha blend = fused
    integrate blend.

Tolerance where not stated at the test (torch_tolerance.
assert_boundary_close): rtol 1e-5 / atol 1e-6 per element, except for at
most 5e-3 of the elements, which may also sit beyond 1e-3 relative: shadow
rays that pass within ulps of a primitive edge may flip, and a reprojection
target within ulps of a cell boundary may pick the neighbouring tap pair
(equal in value, not in rounding)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipe
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops import noise as j_noise
from volumetricrenderer_tpu.ops import sampling as j_sampling
from volumetricrenderer_tpu.ops import scatter_scan as j_scan
from volumetricrenderer_tpu.ops import warp as j_warp
from volumetricrenderer_tpu.ops.pallas import scatter as j_scatter
from volumetricrenderer_tpu.ops.pallas import temporal as j_temporal
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.ops.pallas import warp as j_pwarp
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as tpipe
from volumetricrenderer_tpu_torch.convert import (scene_from_numpy,
                                                  state_from_numpy)
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_dir_shadow
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import integrate as t_integrate
from volumetricrenderer_tpu_torch.ops import noise as t_noise
from volumetricrenderer_tpu_torch.ops import sampling as t_sampling
from volumetricrenderer_tpu_torch.ops import scatter as t_scatter
from volumetricrenderer_tpu_torch.ops import scatter_scan as t_scan
from volumetricrenderer_tpu_torch.ops import shadow_blend as t_sb
from volumetricrenderer_tpu_torch.ops import temporal as t_temporal
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import warp as t_warp

from torch_tolerance import assert_boundary_close

GRID = (16, 15, 16)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
ALPHA = np.float32(0.7)
TIME_X = 0.3
K = 4
SS = 4


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def planes_first(a):
    """[D, H, W, C] -> torch [C, D, H, W]."""
    return t_(a).permute(3, 0, 1, 2).contiguous()


@pytest.fixture(scope="module")
def frame():
    js = j_bench(aspect=128 / 120, num_local_lights=4,
                 noise_mode="procedural")
    ts = scene_from_numpy(js, "cpu")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        jnp.asarray([-0.1, 1.8, -15.5]), jnp.asarray([0.05, -0.02, 1.0]),
        jnp.asarray([0.0, 1.0, 0.0])))
    rng = np.random.default_rng(23)
    w, h, d = GRID
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    prev_acc = u(0, 1, d, h, w, 4)
    prev_acc[2:5, 3:9, :, 3] = 0.0          # T = 0: no history there
    mat_b = np.zeros((d, h, w, 4), np.float32)
    mat_b[..., 0] = u(-0.3, 0.6, d, h, w)
    scatter = u(0, 0.2, d, h, w, 4)
    scatter[:, :, : w // 2, 3] *= 40.0      # past the integral's Taylor guard
    return dict(js=js, ts=ts, jp=jp, tp=tp, jprev=jprev,
                prev_sh=u(0, 1, 1, d, h, w), shadow=u(0, 1, 1, d, h, w),
                prev_acc=prev_acc, acc=u(0, 1, d, h, w, 4), scatter=scatter,
                prev_vol=u(0, 1, d, h, w, 4), mat_a=u(0, 0.01, d, h, w, 4),
                mat_b=mat_b)


def port_tables(f, vis_ss, **kw):
    ts = f["ts"]
    return t_ff.frame_tables(
        f["tp"], ts.camera.view_to_world(), t_(f["jprev"]), JIT, ALPHA,
        ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, GRID, K, vis_ss,
        bake_noise=False, **kw)


# --------------------------------------------------------------------------
# the kernels' twins against the JAX kernels
# --------------------------------------------------------------------------

def j_bake_vis(f):
    js = f["js"]
    return j_vis.bake_visibility_pallas(
        f["jp"], js.camera.view_to_world(), js.camera.position,
        jnp.asarray(JIT), js.point_lights, js.spot_lights, js.geometry, GRID,
        SS, interpret=True)


def test_bake_visibility_matches_jax(frame):
    """K9's twin; visibilities are 0 or 1 (every light casts shadows), so
    only any-hit flips can differ."""
    ts = frame["ts"]
    want = np.asarray(j_bake_vis(frame))
    got = t_vis.bake_visibility_fused(
        frame["tp"], ts.camera.view_to_world(), ts.camera.position, JIT,
        ts.point_lights, ts.spot_lights, ts.geometry, GRID, SS, device="cpu")
    assert got.shape == want.shape == (4, 4, 4, 4)
    assert 0.02 < float((got < 1.0).float().mean()) < 0.98
    assert_boundary_close(got.numpy(), want, "bake_visibility")
    # the frame's full tables give the same volume as the wrapper's own
    torch.testing.assert_close(
        t_vis.bake_visibility(port_tables(frame, SS, light_schedule=True)),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("local,fused", [
    ("baked", True), ("baked", False), ("radiance", False), ("ray", False)])
def test_scatter_new_modes_match_jax(frame, local, fused):
    """K6's twin in its further modes: the local lights from the
    baked per-light visibility, and the material read from volumes."""
    js, ts = frame["js"], frame["ts"]
    if local == "baked":
        vis = j_bake_vis(frame)
    elif local == "radiance":
        vis = j_vis.bake_radiance_pallas(
            frame["jp"], js.camera.view_to_world(), js.camera.position,
            jnp.asarray(JIT), js.point_lights, js.spot_lights, js.geometry,
            js.media, TIME_X, GRID, SS, interpret=True, bake_noise=False)
    else:
        vis = None
    want = j_scatter.scatter_local_pallas(
        frame["jp"], js.camera.view_to_world(), js.camera.position,
        jnp.asarray(JIT), jnp.asarray(frame["mat_a"]),
        jnp.asarray(frame["mat_b"]), js.point_lights, js.spot_lights,
        js.geometry, GRID, dir_lights=js.dir_lights,
        shadow_volume=jnp.asarray(frame["shadow"]), interpret=True,
        return_planes=True, media=js.media if fused else None,
        time_x=TIME_X, vis=vis, vis_ss=SS if vis is not None else 1,
        vis_radiance=local == "radiance")
    material = None if fused else (planes_first(frame["mat_a"]),
                                   planes_first(frame["mat_b"])[:1])
    got = t_scatter.scatter_local_fused(
        frame["tp"], ts.camera.view_to_world(), ts.camera.position, JIT,
        ts.point_lights, ts.spot_lights, ts.geometry, GRID, ts.dir_lights,
        t_(frame["shadow"]), ts.media if fused else None, TIME_X,
        vis=None if vis is None else t_(vis), vis_ss=SS,
        vis_radiance=local == "radiance", material=material)
    assert got.shape == ((4 if fused else 3),) + GRID[::-1] and len(want) \
        == got.shape[0]
    for c in range(got.shape[0]):
        assert_boundary_close(got[c].numpy(), want[c],
                              f"scatter {local} fused={fused} c={c}")


@pytest.mark.parametrize("mode", ["weight", "alpha"])
def test_temporal_blend_matches_jax(frame, mode):
    """K10's twin against fused_temporal_blend: the shadow blend (one
    channel, jitter, eps 1e-4) and the accumulation blend (4 channels)."""
    js, ts = frame["js"], frame["ts"]
    if mode == "weight":
        prev, cur, eps = frame["prev_sh"], frame["shadow"], 1e-4
    else:
        prev = np.moveaxis(frame["prev_acc"], -1, 0)
        cur, eps = np.moveaxis(frame["acc"], -1, 0), 0.0
    want = j_temporal.fused_temporal_blend(
        frame["jp"], js.camera.view_to_world(), frame["jprev"],
        jnp.asarray(JIT), jnp.float32(ALPHA),
        tuple(jnp.asarray(p) for p in prev),
        tuple(jnp.asarray(p) for p in cur), GRID, K, mode, uvw_epsilon=eps,
        interpret=True)
    got = t_temporal.fused_temporal_blend(
        frame["tp"], ts.camera.view_to_world(), t_(frame["jprev"]), JIT,
        ALPHA, t_(prev), t_(cur), GRID, K, mode, uvw_epsilon=eps)
    assert got.shape == cur.shape
    for c in range(len(want)):
        assert_boundary_close(got[c].numpy(), want[c], f"{mode} c={c}")
    # the blend moved the volume, and in alpha mode kept it where T = 0
    assert float((got - t_(cur)).abs().max()) > 0.1
    if mode == "alpha":
        assert float((got - t_(cur))[:, 3, 5:7, 3:-3].abs().max()) == 0.0


@pytest.mark.parametrize("channels", [4, 1])
def test_windowed_warp_matches_jax(frame, channels):
    """K11's twin against the Pallas passes and the plain JAX warp, targets
    up to 5.5 cells away (past the +-4 window) and past the volume's edge.
    The same taps in the same order: rtol 1e-5 / atol 1e-6 everywhere (an
    XLA fusion may contract a multiply-add)."""
    w, h, d = GRID
    rng = np.random.default_rng(5)
    zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                             indexing="ij")
    tx, ty, tz = (g.astype(np.float32)
                  + rng.uniform(-5.5, 5.5, g.shape).astype(np.float32)
                  for g in (xx, yy, zz))
    vol = frame["prev_vol"][..., :channels]
    got = t_warp.windowed_warp(planes_first(vol), t_(tx), t_(ty), t_(tz), K)
    got = got.permute(1, 2, 3, 0).numpy()
    for name, fn in (("pallas", lambda *a: j_pwarp.windowed_warp_pallas(
            *a, interpret=True)), ("plain", j_warp.windowed_warp_sample_3d)):
        want = np.asarray(jax.jit(fn, static_argnums=4)(
            jnp.asarray(vol), jnp.asarray(tx), jnp.asarray(ty),
            jnp.asarray(tz), K))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    with pytest.raises(ValueError):
        t_warp.windowed_warp(planes_first(vol), t_(tx)[1:], t_(ty), t_(tz))


def test_kernel_identities_hold_for_the_twins(frame):
    """shadow then weight blend = fused shadow blend; integrate then alpha
    blend = fused integrate blend: bit for bit, since each pair shares its
    functions (on the card K7 + K10 = K5 and K8 + K10 = K3 likewise)."""
    t = port_tables(frame, SS)
    prev_sh = t_(frame["prev_sh"])
    two_step = t_temporal.temporal_blend(
        t.sbpar, prev_sh, t_dir_shadow.dir_shadow(t), GRID, t.h_glob, K,
        "weight")
    assert torch.equal(two_step, t_sb.dir_shadow_blend(t, prev_sh))
    scatter, prev_acc = (planes_first(frame[k])
                         for k in ("scatter", "prev_acc"))
    two_step = t_temporal.temporal_blend(
        t.abpar, prev_acc, t_integrate.accumulate(t, scatter), GRID,
        t.h_glob, K, "alpha")
    assert torch.equal(two_step, t_ff.integrate_blend(t, scatter, prev_acc))
    with pytest.raises(ValueError, match="mode"):
        t_temporal.temporal_blend(t.abpar, prev_acc, prev_acc, GRID,
                                  t.h_glob, K, "lerp")
    with pytest.raises(ValueError):
        t_temporal.temporal_blend(t.abpar, prev_acc, prev_acc[:3], GRID,
                                  t.h_glob, K, "alpha")


def test_tables_pack_schedule_and_low_grid_together(frame):
    """The baked per-light scatter reads the full-rate schedule and the low
    grid; the struct handed to the kernels carries both."""
    t = port_tables(frame, SS, light_schedule=True)
    assert t.active is not None and t.tent_x is not None
    assert t.order.shape == (GRID[2], 4) and t.n_noise == 0
    cs = t.c_struct()
    assert cs.order == t.order.data_ptr() and cs.active == t.active.data_ptr()
    assert (cs.wl, cs.hl, cs.dl, cs.ss) == (4, 4, 4, SS)
    vis = t_vis.bake_visibility(t)
    shadow = t_(frame["shadow"])
    with pytest.raises(ValueError, match="not both"):
        t_scatter.scatter_local(t, shadow, vis, vis)
    with pytest.raises(ValueError, match="bake volume"):
        t_scatter.scatter_local(t, shadow, None, vis[:3])
    with pytest.raises(ValueError, match="material"):
        t_scatter.scatter_local(t, shadow, None, vis,
                                (shadow, shadow))
    with pytest.raises(ValueError, match="low grid"):
        t_vis.bake_visibility(port_tables(frame, 1))


# --------------------------------------------------------------------------
# the plain passes against their JAX functions
# --------------------------------------------------------------------------

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
J_CFG = dataclasses.replace(J_FULL, **SMALL, volume_distance=60.0,
                            depth_distribution=2.0)
T_CFG = dataclasses.replace(vt.FULL_CONFIG, **SMALL, volume_distance=60.0,
                            depth_distribution=2.0)


def test_perlin_3d_matches_jax():
    """One hash for both of the JAX package's Perlin forms: the port's
    perlin_3d against ops/noise.perlin_3d, negative and large coordinates
    included. atol 2e-6 on values in [0, 1] (sums of 24 lattice terms)."""
    rng = np.random.default_rng(3)
    uvw = rng.uniform(-7.0, 9.0, (5, 11, 13, 3)).astype(np.float32)
    for octaves, period, seed in ((3, 4, 7), (2, 3, 11)):
        want = j_noise.perlin_3d(uvw, octaves, period, seed, xp=np)
        got = t_noise.perlin_3d(t_(uvw), octaves, period, seed).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
        assert 0.1 < want.std()


def test_write_material_volumes_matches_jax(frame):
    """A noisy constant medium with height falloff under an additive soft
    box medium; rtol 1e-4 of values ~1e-3 (the world position goes through
    pow() here and there, and the fBm amplifies its last ulps)."""
    js = frame["js"]
    from volumetricrenderer_tpu.models.media import Medium as JMedium
    media = js.media + (JMedium.create(
        scattering_color=(0.9, 0.3, 0.2), absorption=0.2, phase_g=0.5,
        volume_type="box", blend_type="additive", box_min=(-6.0, 0.0, -4.0),
        box_max=(5.0, 4.0, 9.0), box_softness=1.5, height_falloff=0.2,
        height_base=0.5),)
    ja, jb = jax.jit(lambda v, j, t: jpipe.write_material_volumes(
        J_CFG, frame["jp"], v, j, t, media))(
            js.camera.view_to_world(), jnp.asarray(JIT), jnp.float32(TIME_X))
    ts = scene_from_numpy(dataclasses.replace(js, media=media), "cpu")
    ta, tb = tpipe.write_material_volumes(
        T_CFG, frame["tp"], ts.camera.view_to_world(), t_(JIT), TIME_X,
        ts.media)
    assert ta.shape == (4, 16, 15, 16) and tb.shape == (1, 16, 15, 16)
    np.testing.assert_allclose(ta.permute(1, 2, 3, 0).numpy(), ja, rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb)[..., 0],
                               rtol=1e-4, atol=1e-9)
    assert float(np.abs(np.asarray(jb)[..., 1:]).max()) == 0.0
    assert float(ta.std()) > 1e-4


@pytest.mark.parametrize("offset", [(0.25, -0.3, 0.4), (-0.49, 0.0, 0.49),
                                    (0.0, 0.0, 0.0)])
def test_shift_sample_matches_jax(frame, offset):
    """The same 8 taps and weight products in the same order: rtol 1e-6."""
    want = jax.jit(j_sampling.shift_sample_3d)(
        jnp.asarray(frame["scatter"]), jnp.asarray(offset, jnp.float32))
    got = t_sampling.shift_sample_3d(planes_first(frame["scatter"]), offset)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_trilinear_sample_matches_jax(frame):
    rng = np.random.default_rng(9)
    pos = rng.uniform(-2.0, 18.0, (7, 9, 3)).astype(np.float32)
    want = j_sampling.trilinear_sample_3d(jnp.asarray(frame["prev_vol"]),
                                          jnp.asarray(pos))
    got = t_sampling.trilinear_sample_3d(
        planes_first(frame["prev_vol"]), t_(pos[..., 0]), t_(pos[..., 1]),
        t_(pos[..., 2]))
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("depth", [16, 12])
def test_accumulate_blocked_matches_jax(frame, depth):
    """The two-level scan (16 slices: two blocks) and its one-level
    fallback (12 slices), combining in jax.lax.associative_scan's order:
    rtol 2e-6 (exp and expm1 differ by an ulp between the libraries)."""
    sc = frame["scatter"][:depth]
    steps = np.linspace(0.3, 2.5, depth).astype(np.float32)
    want = jax.jit(j_scan.accumulate_blocked)(
        jnp.asarray(sc[..., :3]), jnp.asarray(sc[..., 3]),
        jnp.asarray(steps))
    tsc = planes_first(sc)
    got = t_scan.accumulate_blocked(tsc[:3], tsc[3], t_(steps))
    assert got.shape == (4, depth, 15, 16)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want,
                               rtol=2e-6, atol=1e-7)
    assert float(got[3].min()) < 0.5 < float(got[3].max())


def _geo(frame):
    ts = frame["ts"]
    return tpipe.FrameGeometry(
        params=frame["tp"], view_to_world=ts.camera.view_to_world(),
        prev_world_to_view=t_(frame["jprev"]), jitter=t_(JIT),
        alpha=float(ALPHA))


def test_step_lengths_match_jax(frame):
    np.testing.assert_allclose(
        tpipe.step_lengths(T_CFG, frame["tp"]).numpy(),
        jpipe.step_lengths(J_CFG, frame["jp"]), rtol=2e-6)


@pytest.mark.parametrize("impl", ["pallas", "windowed", "gather"])
def test_temporal_blend_passes_match_jax(frame, impl):
    """The four temporal_blend_* passes under each reproj_impl. The
    reprojection goes through world space (pow, a matrix product per axis):
    targets agree to ~1e-5 of a cell, so blended values to ~1e-5 absolute
    on histories in [0, 1]; the boundary class covers taps and success
    tests that flip."""
    jc = dataclasses.replace(J_CFG, reproj_impl=impl)
    tc = dataclasses.replace(T_CFG, reproj_impl=impl)
    js = frame["js"]
    v2w, prev, alpha = js.camera.view_to_world(), frame["jprev"], \
        jnp.float32(ALPHA)
    geo = _geo(frame)
    tables = port_tables(frame, SS)

    def close(got, want, msg):
        got, want = np.asarray(got), np.asarray(want)
        err = np.abs(got - want)
        assert (err > 5e-5 + 1e-4 * np.abs(want)).mean() <= 5e-3, \
            (msg, err.max())

    want = jax.jit(lambda a, b: jpipe.temporal_blend_shadow(
        jc, frame["jp"], v2w, prev, jnp.asarray(JIT), a, b, alpha))(
            jnp.asarray(frame["shadow"]), jnp.asarray(frame["prev_sh"]))
    got = tpipe.temporal_blend_shadow(tc, tables, geo, t_(frame["shadow"]),
                                      t_(frame["prev_sh"]))
    close(got.numpy(), want, f"shadow {impl}")

    for name in ("scatter", "material"):
        jfn = getattr(jpipe, f"temporal_blend_{name}")
        tfn = getattr(tpipe, f"temporal_blend_{name}")
        want = jax.jit(lambda a, b: jfn(jc, frame["jp"], v2w, prev, a, b,
                                        alpha))(
            jnp.asarray(frame["acc"]), jnp.asarray(frame["prev_vol"]))
        got = tfn(tc, geo, planes_first(frame["acc"]),
                  planes_first(frame["prev_vol"]))
        close(got.permute(1, 2, 3, 0).numpy(), want, f"{name} {impl}")

    want = jax.jit(lambda a, b: jpipe.temporal_blend_accumulation(
        jc, frame["jp"], v2w, prev, a, b, alpha))(
            jnp.asarray(frame["acc"]), jnp.asarray(frame["prev_acc"]))
    got = tpipe.temporal_blend_accumulation(
        tc, tables, geo, planes_first(frame["acc"]),
        planes_first(frame["prev_acc"]))
    close(got.permute(1, 2, 3, 0).numpy(), want, f"accumulation {impl}")


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0)),
           ((0.3, 2.1, -14.7), (0.08, -0.03, 1.0))]
VIS_BAKE = dict(frame_fused=False, scatter_bake="vis")
HISTORY = dict(VIS_BAKE, temporal_blend_material=True,
               temporal_blend_scatter=True)
# name -> (config changes, frames)
VARIANTS = {
    "history": (HISTORY, 3),
    "vis_bake": (VIS_BAKE, 3),
    "xla_shadow": (dict(HISTORY, dir_shadow_impl="xla"), 2),
}


@pytest.fixture(scope="module")
def scenes():
    base = j_bench(aspect=128 / 120, num_local_lights=4,
                   noise_mode="procedural")
    scs = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=128 / 120)) for p, f in CAMERAS]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL))
    gbuffers = [tuple(np.array(a) for a in
                      jax.jit(jr.render_scene_inputs)(sc)) for sc in scs]
    return scs, gbuffers


@pytest.fixture(scope="module", params=list(VARIANTS))
def both(request, scenes):
    kw, n = VARIANTS[request.param]
    scs, gbuffers = scenes
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL, **kw))
    step = jax.jit(lambda s, sc, t, c, d: jr.render_frame(
        s, sc, t, scene_color=c, view_depth=d))
    tr = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **SMALL, **kw), device="cpu")
    st, ts = jr.init_state(1), tr.init_state(1)
    j_imgs, t_imgs = [], []
    for i in range(n):
        c, d = gbuffers[i]
        img, j_aux, st = step(st, scs[i], jnp.float32(0.1 * i), c, d)
        j_imgs.append(np.asarray(img))
        img, t_aux, ts = tr.render_frame(ts, scene_from_numpy(scs[i], "cpu"),
                                         np.float32(0.1 * i), t_(c), t_(d))
        t_imgs.append(img.numpy())
    return request.param, kw, n, (j_imgs, j_aux, st), (t_imgs, t_aux, ts)


def test_history_frames_match_jax(both):
    name, kw, n, (j_imgs, j_aux, st), (t_imgs, t_aux, ts) = both
    for i in range(n):
        a, b = t_imgs[i], j_imgs[i]
        assert a.shape == b.shape == (120, 128, 4)
        assert_boundary_close(a, b, f"{name} image {i}")
        assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()
    assert ts.frame_count == n
    last = lambda v: v.permute(1, 2, 3, 0).numpy()
    assert_boundary_close(
        last(ts.prev_accumulation),
        packed_accumulation(st.prev_accumulation, (16, 15, 16)),
        f"{name} accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          f"{name} shadow history")
    blends = kw.get("temporal_blend_material", False)
    if blends:
        assert_boundary_close(last(ts.prev_material_a), st.prev_material_a,
                              f"{name} material history")
        assert_boundary_close(last(ts.prev_scatter), st.prev_scatter,
                              f"{name} scatter history")
        # the histories are the blended volumes
        assert torch.equal(ts.prev_scatter, t_aux["scatter"])
        assert torch.equal(ts.prev_material_a, t_aux["material_a"])
        assert_boundary_close(last(t_aux["material_a"]),
                              j_aux["material_a"], f"{name} aux material_a")
        assert_boundary_close(t_aux["material_b"][0].numpy(),
                              np.asarray(j_aux["material_b"])[..., 0],
                              f"{name} aux material_b")
    else:
        assert ts.prev_material_a is None and ts.prev_scatter is None
        assert st.prev_material_a is None and "material_a" not in t_aux
    for key in ("scatter", "accumulation"):
        assert_boundary_close(last(t_aux[key]), j_aux[key],
                              f"{name} aux {key}")
    assert_boundary_close(t_aux["shadow"].numpy(), j_aux["shadow"],
                          f"{name} aux shadow")


def test_history_state_crosses_from_numpy(both):
    """convert.state_from_numpy carries all four histories of a JAX state
    across: the port's next frame from it matches the port's own."""
    name, kw, n, (_, _, st), (_, _, ts) = both
    got = state_from_numpy(
        packed_accumulation(st.prev_accumulation, (16, 15, 16)),
        st.prev_shadow, st.prev_world_to_view, int(st.frame_count), "cpu",
        prev_material_a=st.prev_material_a, prev_scatter=st.prev_scatter)
    assert got.frame_count == ts.frame_count
    for field in ("prev_material_a", "prev_scatter"):
        a, b = getattr(got, field), getattr(ts, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.shape == b.shape == (4, 16, 15, 16)
            assert_boundary_close(a.numpy(), b.numpy(), f"{name} {field}")


def test_history_state_starts_at_zero_and_needs_its_blend():
    cfg = dataclasses.replace(vt.FULL_CONFIG, **SMALL, **HISTORY)
    st = vt.VolumetricRenderer(cfg, device="cpu").init_state(1)
    for v in (st.prev_material_a, st.prev_scatter):
        assert v.shape == (4, 16, 15, 16) and float(v.abs().max()) == 0.0
    plain = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **SMALL), device="cpu")
    st = plain.init_state(1)
    assert st.prev_material_a is None and st.prev_scatter is None
