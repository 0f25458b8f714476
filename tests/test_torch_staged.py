"""The port's staged frame (the plain-torch twins of kernels K5-K8, and of
K1 and K3 under their staged names) against the JAX package, Pallas in
interpret mode:

  * each module that holds a kernel against the JAX function it stands
    for, on the inputs of a second frame: benchmark_scene (4 local lights,
    procedural noise) at a 16x15x16 grid, a moved previous camera and
    numpy-seeded histories;
  * the slice as a whole: VolumetricRenderer(device="cpu") against the JAX
    render_frame under jax.jit over frames with a moving camera, for the
    staged configuration (FULL_CONFIG with frame_fused=False), the exact one
    (also scatter_bake="vis", raycast_shadow_subsample=1) and the two
    variants with one temporal blend off, at 128x120 pixels;
  * the port's staged frame against its fused frame, and a state made by
    one branch fed to the other.

Tolerance (torch_tolerance.assert_boundary_close): rtol 1e-5 / atol 1e-6 per
element, except for at most 5e-3 of the elements, which may also sit beyond
1e-3 relative: shadow rays that pass within ulps of a primitive edge may
flip (the any-hit boundary class). Images also hold a mean absolute error of
at most 1e-5 of the image maximum. The light schedule is compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import dir_shadow as j_dir_shadow
from volumetricrenderer_tpu.ops.pallas import integrate as j_integrate
from volumetricrenderer_tpu.ops.pallas import integrate_blend as j_ib
from volumetricrenderer_tpu.ops.pallas import scatter as j_scatter
from volumetricrenderer_tpu.ops.pallas import shadow_blend as j_sb
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_dir_shadow
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import integrate as t_integrate
from volumetricrenderer_tpu_torch.ops import scatter as t_scatter
from volumetricrenderer_tpu_torch.ops import shadow_blend as t_sb
from volumetricrenderer_tpu_torch.ops import visibility as t_vis

from torch_tolerance import assert_boundary_close

GRID = (16, 15, 16)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
ALPHA = np.float32(0.7)
TIME_X = 0.3
K = 4
SS = 4


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


# --------------------------------------------------------------------------
# each module against the JAX function it stands for
# --------------------------------------------------------------------------

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
    rng = np.random.default_rng(11)
    w, h, d = GRID
    prev_sh = rng.uniform(0, 1, (1, d, h, w)).astype(np.float32)
    prev_acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    shadow = rng.uniform(0, 1, (1, d, h, w)).astype(np.float32)
    scatter = rng.uniform(0, 0.2, (4, d, h, w)).astype(np.float32)
    # a thick medium in part of the volume takes the slice integral past
    # its Taylor branch
    scatter[3, :, :, : w // 2] *= 40.0
    return dict(js=js, ts=ts, jp=jp, tp=tp, jprev=jprev, prev_sh=prev_sh,
                prev_acc=prev_acc, shadow=shadow, scatter=scatter)


def port_tables(f, vis_ss, **kw):
    ts = f["ts"]
    return t_ff.frame_tables(
        f["tp"], ts.camera.view_to_world(), t_(f["jprev"]), JIT, ALPHA,
        ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, GRID, K, vis_ss,
        bake_noise=True, **kw)


def test_dir_shadow_blend_matches_jax(frame):
    js, ts = frame["js"], frame["ts"]
    want = j_sb.dir_shadow_blend_fused(
        frame["jp"], js.camera.view_to_world(), frame["jprev"],
        jnp.asarray(JIT), jnp.float32(ALPHA), js.dir_lights, js.geometry,
        jnp.asarray(frame["prev_sh"]), GRID, K, interpret=True)
    got = t_sb.dir_shadow_blend_fused(
        frame["tp"], ts.camera.view_to_world(), t_(frame["jprev"]), JIT,
        ALPHA, ts.dir_lights, ts.geometry, t_(frame["prev_sh"]), GRID, K)
    assert_boundary_close(got.numpy(), want, "dir_shadow_blend")
    # the frame's full tables give the same volume as the wrapper's own
    tables = port_tables(frame, SS)
    torch.testing.assert_close(
        t_sb.dir_shadow_blend(tables, t_(frame["prev_sh"])), got, rtol=0,
        atol=0)


def test_dir_shadow_matches_jax(frame):
    js = frame["js"]
    want = j_dir_shadow.dir_shadow_pallas(
        frame["jp"], js.camera.view_to_world(), jnp.asarray(JIT),
        js.dir_lights, js.geometry, GRID, interpret=True)
    got = t_dir_shadow.dir_shadow(port_tables(frame, SS))
    assert got.shape == (1,) + GRID[::-1]
    assert 0.02 < float((got < 1.0).float().mean()) < 0.98
    assert_boundary_close(got.numpy(), want, "dir_shadow")


def j_bake(frame, bake_noise=True):
    js = frame["js"]
    return j_vis.bake_radiance_pallas(
        frame["jp"], js.camera.view_to_world(), js.camera.position,
        jnp.asarray(JIT), js.point_lights, js.spot_lights, js.geometry,
        js.media, TIME_X, GRID, SS, interpret=True, bake_noise=bake_noise)


@pytest.mark.parametrize("bake_noise", [True, False])
def test_bake_radiance_matches_jax(frame, bake_noise):
    ts = frame["ts"]
    want = np.asarray(j_bake(frame, bake_noise))
    got = t_vis.bake_radiance_fused(
        frame["tp"], ts.camera.view_to_world(), ts.camera.position, JIT,
        ts.point_lights, ts.spot_lights, ts.geometry, ts.media, TIME_X, GRID,
        SS, bake_noise=bake_noise, device="cpu")
    assert got.shape == want.shape == (3 + int(bake_noise), 4, 4, 4)
    assert_boundary_close(got.numpy(), want, f"bake noise={bake_noise}")


@pytest.mark.parametrize("mode,jitter_dir", [
    ("radiance", False), ("radiance", True), ("per_light", False),
    ("per_light", True)])
def test_scatter_local_matches_jax(frame, mode, jitter_dir):
    """K6's twin in both modes against scatter_local_pallas with the
    material folded in; the radiance mode reads the JAX bake (with its fBm
    channel) on both sides."""
    js, ts = frame["js"], frame["ts"]
    vis = j_bake(frame) if mode == "radiance" else None
    want = j_scatter.scatter_local_pallas(
        frame["jp"], js.camera.view_to_world(), js.camera.position,
        jnp.asarray(JIT), None, None, js.point_lights, js.spot_lights,
        js.geometry, GRID, dir_lights=js.dir_lights,
        shadow_volume=jnp.asarray(frame["shadow"]), jitter_dir=jitter_dir,
        interpret=True, return_planes=True, media=js.media, time_x=TIME_X,
        vis=vis, vis_ss=SS if vis is not None else 1,
        vis_radiance=vis is not None)
    got = t_scatter.scatter_local_fused(
        frame["tp"], ts.camera.view_to_world(), ts.camera.position, JIT,
        ts.point_lights, ts.spot_lights, ts.geometry, GRID, ts.dir_lights,
        t_(frame["shadow"]), ts.media, TIME_X, jitter_dir=jitter_dir,
        vis=None if vis is None else t_(vis), vis_ss=SS)
    assert got.shape == (4,) + GRID[::-1]
    for c in range(4):
        assert_boundary_close(got[c].numpy(), want[c],
                              f"scatter {mode} jitter_dir={jitter_dir} c={c}")


def test_slice_light_order_matches_jax(frame):
    """The per-slice light schedule, exact; a short-range light set so that
    slices differ in their active lights."""
    js, ts = frame["js"], frame["ts"]
    pos = jnp.concatenate([js.point_lights.position, js.spot_lights.position])
    rng = jnp.concatenate([js.point_lights.range, js.spot_lights.range])
    for scale in (1.0, 0.25):
        j_order, j_count = j_scatter.slice_light_order(
            frame["jp"], js.camera.view_to_world(), pos, rng * scale, GRID)
        order, count = t_scatter.slice_light_order(
            frame["tp"], ts.camera.view_to_world(), t_(pos), t_(rng) * scale,
            GRID)
        assert order.dtype == count.dtype == torch.int32
        np.testing.assert_array_equal(order.numpy(),
                                      np.asarray(j_order)[:, 0, :])
        np.testing.assert_array_equal(count.numpy(),
                                      np.asarray(j_count)[:, 0, 0])
    assert len(torch.unique(count)) > 2     # the slices' schedules differ
    mask = t_scatter.schedule_mask(order, count)
    np.testing.assert_array_equal(mask.sum(1).numpy(), count.numpy())


def test_accumulate_matches_jax(frame):
    want = j_integrate.accumulate_fused_pallas(
        tuple(jnp.asarray(p) for p in frame["scatter"]), jnp.asarray(JIT),
        frame["jp"], GRID, interpret=True, return_planes=True)
    got = t_integrate.accumulate(port_tables(frame, SS), t_(frame["scatter"]))
    for c in range(4):
        assert_boundary_close(got[c].numpy(), want[c], f"accumulate c={c}")
    assert float(got[3].min()) < 0.5 < float(got[3].max())


def test_integrate_blend_matches_jax(frame):
    js, ts = frame["js"], frame["ts"]
    want = j_ib.integrate_blend_fused(
        tuple(jnp.asarray(p) for p in frame["scatter"]),
        tuple(jnp.asarray(p) for p in frame["prev_acc"]), jnp.asarray(JIT),
        frame["jp"], js.camera.view_to_world(), frame["jprev"],
        jnp.float32(ALPHA), GRID, K, interpret=True)
    got = t_integrate.integrate_blend_fused(
        t_(frame["scatter"]), t_(frame["prev_acc"]), JIT, frame["tp"],
        ts.camera.view_to_world(), t_(frame["jprev"]), ALPHA, GRID, K)
    for c in range(4):
        assert_boundary_close(got[c].numpy(), want[c],
                              f"integrate_blend c={c}")


def test_staged_wrappers_take_the_twin_on_cpu(frame):
    """On CPU tensors each new wrapper returns its twin's result exactly,
    and refuses inputs its kernel would not take."""
    low, full = port_tables(frame, SS), port_tables(frame, 1)
    prev_sh, shadow = t_(frame["prev_sh"]), t_(frame["shadow"])
    scatter = t_(frame["scatter"])
    same = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=0)
    same(t_sb.dir_shadow_blend(low, prev_sh),
         t_sb.dir_shadow_blend_plain(low, prev_sh))
    same(t_dir_shadow.dir_shadow(low), t_dir_shadow.dir_shadow_plain(low))
    bake = t_ff.bake_radiance(low)
    same(t_scatter.scatter_local(low, shadow, bake),
         t_scatter.scatter_local_plain(low, shadow, bake))
    same(t_scatter.scatter_local(full, shadow),
         t_scatter.scatter_local_plain(full, shadow))
    same(t_integrate.accumulate(low, scatter),
         t_integrate.accumulate_plain(low, scatter))
    with pytest.raises(ValueError, match="schedule"):
        t_scatter.scatter_local(low, shadow)          # no bake, no schedule
    with pytest.raises(ValueError, match="bake volume"):
        t_scatter.scatter_local(full, shadow, bake)   # no low grid at ss=1
    with pytest.raises(ValueError):
        t_scatter.scatter_local(low, shadow[:, :-1], bake)
    with pytest.raises(ValueError):
        t_sb.dir_shadow_blend(low, prev_sh[:, :-1])
    with pytest.raises(ValueError):
        t_integrate.accumulate(low, scatter[:3])


def test_tables_pack_only_what_the_mode_reads(frame):
    """ss > 1 packs the low grid and no light schedule; ss = 1 the schedule
    and no low grid, nor baked fBm channels; the struct handed to the
    kernels carries null pointers and zero low dims for what is absent, and
    the tables still move as one buffer."""
    low, full = port_tables(frame, SS), port_tables(frame, 1)
    assert low.order is None and low.count is None
    assert low.active is not None and low.n_noise == 1
    assert full.active is None and full.tent_x is None and full.tent_y is None
    assert full.order.shape == (GRID[2], 4) and full.count.shape == (GRID[2],)
    assert full.n_noise == 0 and full.low_dims == (0, 0, 0)
    cs = full.c_struct()
    assert cs.active is None and cs.tent_xk is None and cs.tent_yw is None
    assert cs.order == full.order.data_ptr()
    assert (cs.wl, cs.hl, cs.dl, cs.ss, cs.n_lights) == (0, 0, 0, 1, 4)
    cs = low.c_struct()
    assert cs.order is None and cs.count is None
    assert (cs.wl, cs.hl, cs.dl) == low.low_dims == (4, 4, 4)
    moved = full.to("cpu")
    torch.testing.assert_close(moved.order, full.order, rtol=0, atol=0)
    assert moved.active is None and moved.order.dtype == torch.int32


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0)),
           ((0.3, 2.1, -14.7), (0.08, -0.03, 1.0))]
STAGED = dict(frame_fused=False)
EXACT = dict(frame_fused=False, scatter_bake="vis",
             raycast_shadow_subsample=1)
# name -> (config changes, frames)
VARIANTS = {
    "staged": (STAGED, 3),
    "exact": (EXACT, 3),
    "no_shadow_blend": (dict(STAGED, temporal_blend_shadow=False), 2),
    "no_accumulation_blend": (dict(STAGED, temporal_blend_accumulation=False),
                              2),
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


def render_port(kw, scenes, n, state=None, first=0):
    """Frames first .. n-1 of the camera path through the port on the CPU;
    returns (images, last aux, last state)."""
    scs, gbuffers = scenes
    tr = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **SMALL, **kw), device="cpu")
    ts = tr.init_state(1) if state is None else state
    imgs, aux = [], None
    for i in range(first, n):
        c, d = gbuffers[i]
        img, aux, ts = tr.render_frame(ts, scene_from_numpy(scs[i], "cpu"),
                                       np.float32(0.1 * i), t_(c), t_(d))
        imgs.append(img.numpy())
    return imgs, aux, ts


@pytest.fixture(scope="module", params=list(VARIANTS))
def both(request, scenes):
    kw, n = VARIANTS[request.param]
    scs, gbuffers = scenes
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL, **kw))

    def step(s, sc, t, c, d):
        img, aux, s = jr.render_frame(s, sc, t, scene_color=c, view_depth=d)
        return img, aux["scatter"], s

    step = jax.jit(step)
    st = jr.init_state(1)
    j_imgs = []
    for i in range(n):
        c, d = gbuffers[i]
        img, j_scat, st = step(st, scs[i], jnp.float32(0.1 * i), c, d)
        j_imgs.append(np.asarray(img))
    j_out = dict(
        imgs=j_imgs, scatter=np.asarray(j_scat),
        acc=np.asarray(packed_accumulation(st.prev_accumulation,
                                           jr.config.grid_dhw)),
        shadow=np.asarray(st.prev_shadow))
    t_imgs, aux, ts = render_port(kw, scenes, n)
    return request.param, n, j_out, t_imgs, aux, ts


def test_staged_frames_match_jax(both):
    name, n, j, t_imgs, aux, ts = both
    for i in range(n):
        a, b = t_imgs[i], j["imgs"][i]
        assert a.shape == b.shape == (120, 128, 4)
        assert_boundary_close(a, b, f"{name} image {i}")
        assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()
    assert ts.frame_count == n
    assert_boundary_close(ts.prev_accumulation.permute(1, 2, 3, 0).numpy(),
                          j["acc"], f"{name} accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), j["shadow"],
                          f"{name} shadow history")
    assert aux["scatter"].shape == (4, 16, 15, 16)
    assert_boundary_close(aux["scatter"].permute(1, 2, 3, 0).numpy(),
                          j["scatter"], f"{name} aux scatter")


def test_blend_off_state_holds_the_unblended_volumes(scenes):
    """With temporal_blend_shadow off the state still stores the shadow
    volume, unblended: after two frames every value is one of the ray's two
    visibility levels."""
    _, aux, ts = render_port(VARIANTS["no_shadow_blend"][0], scenes, 2)
    torch.testing.assert_close(ts.prev_shadow, aux["shadow"], rtol=0, atol=0)
    assert 0.0 < float((ts.prev_shadow < 1.0).float().mean()) < 1.0
    assert len(torch.unique(ts.prev_shadow)) == 2


def test_staged_matches_fused_in_the_port(scenes):
    """The staged frame against the fused production frame of the port
    (the JAX package pins this pair in tests/test_frame_fused.py), and a
    state made by one branch fed to the other."""
    f_imgs, f_aux, f_state = render_port({}, scenes, 3)
    s_imgs, s_aux, s_state = render_port(STAGED, scenes, 3)
    assert "scatter" not in f_aux and "scatter" in s_aux
    for i in range(3):
        assert_boundary_close(s_imgs[i], f_imgs[i], f"staged vs fused {i}")
    assert_boundary_close(s_state.prev_shadow.numpy(),
                          f_state.prev_shadow.numpy(), "shadow history")
    assert_boundary_close(s_state.prev_accumulation.numpy(),
                          f_state.prev_accumulation.numpy(), "acc history")
    # two frames on one branch, the third on the other
    _, _, f2 = render_port({}, scenes, 2)
    _, _, s2 = render_port(STAGED, scenes, 2)
    cross_s, _, _ = render_port(STAGED, scenes, 3, state=f2, first=2)
    cross_f, _, _ = render_port({}, scenes, 3, state=s2, first=2)
    assert_boundary_close(cross_s[0], f_imgs[2], "fused state -> staged")
    assert_boundary_close(cross_f[0], s_imgs[2], "staged state -> fused")
