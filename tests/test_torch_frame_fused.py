"""The port's volume phase (the plain-torch twins of kernels K1-K3 chained
by ops/frame_fused.frame_volume_fused) against the JAX megakernel
`frame_volume_fused` in interpret mode on its production path (inline
radiance + fBm bake), with random previous histories and a moved previous
camera.

Tolerance: rtol 1e-5 / atol 1e-6 per element, except for at most 5e-3 of
the froxels, which may also sit beyond 1e-3 relative: shadow rays that pass
within ulps of a primitive edge may flip (the any-hit boundary class of
tests/test_frame_fused.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas.frame_fused import \
    frame_volume_fused as j_frame_volume_fused

from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff

from torch_tolerance import assert_boundary_close

GRID = (24, 16, 12)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
ALPHA = np.float32(0.7)
TIME_X = 0.3


@pytest.fixture(scope="module")
def frame():
    js = j_bench(aspect=1.5, num_local_lights=4, noise_mode="procedural")
    ts = scene_from_numpy(js, "cpu")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        jnp.asarray([-0.1, 1.8, -15.5]), jnp.asarray([0.05, -0.02, 1.0]),
        jnp.asarray([0.0, 1.0, 0.0])))
    rng = np.random.default_rng(5)
    w, h, d = GRID
    prev_sh = rng.uniform(0, 1, (1, d, h, w)).astype(np.float32)
    prev_acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    return js, ts, jp, tp, jprev, prev_sh, prev_acc


def run_both(frame, ss, k, jitter_dir=False, bake_noise=True):
    js, ts, jp, tp, jprev, prev_sh, prev_acc = frame
    j_sh, j_acc = j_frame_volume_fused(
        jp, js.camera.view_to_world(), jprev, jnp.asarray(JIT),
        jnp.float32(ALPHA), js.dir_lights, js.point_lights, js.spot_lights,
        js.geometry, js.media, TIME_X, js.camera.position,
        jnp.asarray(prev_sh), tuple(jnp.asarray(p) for p in prev_acc), GRID,
        k, vis_ss=ss, vis_radiance=True, bake_noise=bake_noise,
        inline_vis_bake=True, jitter_dir=jitter_dir, interpret=True)
    t_sh, t_acc = t_ff.frame_volume_fused(
        tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)), JIT,
        ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, torch.as_tensor(prev_sh),
        torch.as_tensor(prev_acc), GRID, k, vis_ss=ss, vis_radiance=True,
        bake_noise=bake_noise, inline_vis_bake=True, jitter_dir=jitter_dir)
    return (np.asarray(j_sh), np.stack([np.asarray(a) for a in j_acc])), \
        (t_sh.numpy(), t_acc.numpy())


@pytest.mark.parametrize("ss,k,jitter_dir,bake_noise", [
    (2, 1, False, True), (2, 4, False, True), (4, 1, False, True),
    (4, 4, False, True),
    # the two non-production knobs the fused branch accepts: the jittered
    # sun scatter, and the fBm evaluated per froxel instead of baked
    (2, 1, True, False)])
def test_volume_phase_matches_megakernel(frame, ss, k, jitter_dir,
                                         bake_noise):
    (j_sh, j_acc), (t_sh, t_acc) = run_both(frame, ss, k, jitter_dir,
                                            bake_noise)
    tag = f"ss={ss} k={k} jitter_dir={jitter_dir} bake_noise={bake_noise}"
    assert_boundary_close(t_sh, j_sh, f"shadow {tag}")
    for c in range(4):
        assert_boundary_close(t_acc[c], j_acc[c], f"acc {tag} c={c}")


def test_wrappers_take_the_twin_on_cpu(frame):
    """On CPU tensors each wrapper returns its twin's result exactly."""
    js, ts, jp, tp, jprev, prev_sh, prev_acc = frame
    tables = t_ff.frame_tables(
        tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)), JIT,
        ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, GRID, 2, 4, bake_noise=True)
    bake = t_ff.bake_radiance(tables)
    torch.testing.assert_close(bake, t_ff.bake_radiance_plain(tables),
                               rtol=0, atol=0)
    assert bake.shape == (4,) + tuple(reversed(tables.low_dims))
    sh, sc = t_ff.shadow_scatter(tables, torch.as_tensor(prev_sh), bake)
    sh_p, sc_p = t_ff.shadow_scatter_plain(tables, torch.as_tensor(prev_sh),
                                           bake)
    torch.testing.assert_close(sh, sh_p, rtol=0, atol=0)
    torch.testing.assert_close(sc, sc_p, rtol=0, atol=0)
    acc = t_ff.integrate_blend(tables, sc, torch.as_tensor(prev_acc))
    torch.testing.assert_close(
        acc, t_ff.integrate_blend_plain(tables, sc, torch.as_tensor(prev_acc)),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_ff.integrate_blend(tables, sc[:3], torch.as_tensor(prev_acc))


def test_tables_move_as_one_buffer(frame):
    """FrameTables.to packs every tensor into one buffer per dtype and
    splits it back: each field keeps its value, shape and dtype."""
    js, ts, jp, tp, jprev, prev_sh, prev_acc = frame
    tables = t_ff.frame_tables(
        tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)), JIT,
        ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, GRID, 2, 4, bake_noise=True)
    moved = tables.to("cpu")
    for f in dataclasses.fields(tables):
        a, b = getattr(tables, f.name), getattr(moved, f.name)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                torch.testing.assert_close(y, x, rtol=0, atol=0)
            else:
                assert np.array_equal(x, y), f.name


def test_tables_are_packed_on_the_host(frame):
    """frame_tables refuses a scene description that is not on the CPU
    (the renderer hands it a host copy of the scene)."""
    js, ts, jp, tp, jprev, prev_sh, prev_acc = frame
    with pytest.raises(ValueError, match="host"):
        t_ff.frame_tables(
            tp, ts.camera.view_to_world().to("meta"),
            torch.as_tensor(np.array(jprev)), JIT, ALPHA, ts.dir_lights,
            ts.point_lights, ts.spot_lights, ts.geometry, ts.media, TIME_X,
            ts.camera.position, GRID, 2, 4, bake_noise=True)
