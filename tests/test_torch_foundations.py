"""The port's foundations (volumetricrenderer_tpu_torch) against the JAX
package: config presets, froxel params and transforms, the jitter sequence,
every pack_* table, low_slice_active, the scene converter and the G-buffer
stand-in. Inputs come from numpy seeds; both sides run in float32 on the CPU.

Tolerance: rtol 1e-6 / atol 1e-6 unless a test states otherwise -- both
sides evaluate the same float32 formulas, so only libm ulps (tan, exp, log,
pow) differ."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import config as jconfig
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline
from volumetricrenderer_tpu.jitter import jitter_sequence as j_jitter
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import dir_shadow as j_dir_shadow
from volumetricrenderer_tpu.ops.pallas import material as j_material
from volumetricrenderer_tpu.ops.pallas import occlude as j_occlude
from volumetricrenderer_tpu.ops.pallas import scatter as j_scatter
from volumetricrenderer_tpu.ops.pallas import temporal as j_temporal
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.renderer import VolumetricRenderer as JRenderer

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import config as tconfig
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.convert import (scene_from_numpy,
                                                  state_from_numpy)
from volumetricrenderer_tpu_torch.jitter import jitter_sequence as t_jitter
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_dir_shadow
from volumetricrenderer_tpu_torch.ops import material as t_material
from volumetricrenderer_tpu_torch.ops import occlude as t_occlude
from volumetricrenderer_tpu_torch.ops import scatter as t_scatter
from volumetricrenderer_tpu_torch.ops import temporal as t_temporal
from volumetricrenderer_tpu_torch.ops import visibility as t_vis

RTOL = ATOL = 1e-6
GRID = (24, 16, 12)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.fixture(scope="module")
def scenes():
    """(JAX benchmark scene, its conversion, the port's own preset)."""
    js = j_bench(aspect=1.5, num_local_lights=6, noise_mode="procedural")
    return (js, scene_from_numpy(js, "cpu"),
            vt.benchmark_scene(aspect=1.5, num_local_lights=6,
                               noise_mode="procedural", device="cpu"))


@pytest.fixture(scope="module")
def cams():
    """(JAX params, v2w, prev w2v) and the port's, for a moved camera."""
    js = j_bench(aspect=1.5, num_local_lights=6, noise_mode="procedural")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    jv2w = cam.view_to_world()
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        jnp.asarray([-0.1, 1.8, -15.5]), jnp.asarray([0.05, -0.02, 1.0]),
        jnp.asarray([0.0, 1.0, 0.0])))
    ts = scene_from_numpy(js, "cpu")
    tc = ts.camera
    tp = tfroxel.make_froxel_params(tc.fov_y, tc.aspect, tc.near, 60.0, 2.0,
                                    GRID)
    return (jp, jv2w, jprev), (tp, tc.view_to_world(),
                               torch.as_tensor(np.array(jprev)))


@pytest.mark.parametrize("name", ["DEMO_CONFIG", "FULL_CONFIG",
                                  "UHD_CONFIG"])
def test_config_presets(name):
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    for f in dataclasses.fields(jc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.grid == jc.grid and tc.grid_dhw == jc.grid_dhw
    assert tc.dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(), dict(composite_impl="tentmm"), dict(image_width=960),
    dict(image_width=3840, image_height=2160), dict(volume_height=136),
    dict(image_width=960, image_height=540)])
def test_composite_eligible_matches_zgather_eligible(kw):
    jc = dataclasses.replace(jconfig.FULL_CONFIG, **kw)
    tc = dataclasses.replace(tconfig.FULL_CONFIG, **kw)
    assert tconfig.composite_eligible(tc) == jpipeline.zgather_eligible(jc)


def test_froxel_params_and_transforms(cams):
    (jp, jv2w, jprev), (tp, tv2w, tprev) = cams
    for f in ("x", "y", "z", "w", "near"):
        close(getattr(tp, f), getattr(jp, f), msg=f)
    close(tv2w, jv2w)
    close(tfroxel.invert_rigid(tv2w), jfroxel.invert_rigid(jv2w))
    rng = np.random.default_rng(0)
    w, h, d = GRID
    fro = (rng.uniform(0, 1, (64, 3)) * [w, h, d]).astype(np.float32)
    jv = jfroxel.froxel_to_view(jp, jnp.asarray(fro))
    tv = tfroxel.froxel_to_view(tp, torch.as_tensor(fro))
    close(tv, jv, rtol=1e-5, msg="froxel_to_view (pow ulps)")
    close(tfroxel.view_to_froxel(tp, torch.as_tensor(np.array(jv))),
          jfroxel.view_to_froxel(jp, jv), rtol=1e-5, atol=1e-5,
          msg="view_to_froxel (log ulps)")
    close(tfroxel.froxel_to_world(tp, tv2w, torch.as_tensor(fro)),
          jfroxel.froxel_to_world(jp, jv2w, jnp.asarray(fro)), rtol=1e-5,
          atol=1e-5)
    depth = rng.uniform(-1.0, 150.0, (50,)).astype(np.float32)
    close(tfroxel.depth_to_froxel_z(tp, torch.as_tensor(depth)),
          jfroxel.depth_to_froxel_z(jp, jnp.asarray(depth)), rtol=1e-5,
          atol=1e-5, msg="depth_to_froxel_z (log ulps)")


def test_jitter_sequence_is_bit_exact():
    np.testing.assert_array_equal(t_jitter(), j_jitter())


def test_pack_tables(scenes, cams):
    js, ts, _ = scenes
    (jp, jv2w, jprev), (tp, tv2w, tprev) = cams
    jit = np.asarray([0.25, -0.3, 0.4], np.float32)
    close(t_scatter.pack_params(tp, tv2w, ts.camera.position, jit),
          j_scatter.pack_params(jp, jv2w, js.camera.position,
                                jnp.asarray(jit)))
    for eps in (1e-4, 0.0):
        close(t_temporal.pack_blend_params(tp, tv2w, tprev, jit, 0.7, eps),
              j_temporal.pack_blend_params(jp, jv2w, jprev, jnp.asarray(jit),
                                           jnp.float32(0.7), eps),
              msg=f"pack_blend_params eps={eps}")
    close(t_scatter.pack_lights(ts.point_lights, ts.spot_lights),
          j_scatter.pack_lights(js.point_lights, js.spot_lights))
    close(t_scatter.pack_dir_lights(ts.dir_lights),
          j_scatter.pack_dir_lights(js.dir_lights))
    close(t_dir_shadow.pack_dir_lights(ts.dir_lights),
          j_dir_shadow.pack_dir_lights(js.dir_lights))
    close(t_occlude.pack_boxes(ts.geometry), j_occlude.pack_boxes(js.geometry))
    tm, tstat = t_material.pack_media(ts.media, 0.3)
    jm, jstat = j_material.pack_media(js.media, 0.3)
    close(tm, jm)
    assert tstat == jstat
    assert t_material.media_foldable(ts.media) \
        == j_material.media_foldable(js.media)
    assert [t_material.noise_src(m) for m in ts.media] \
        == [j_material.noise_src(m) for m in js.media]


@pytest.mark.parametrize("ss", [2, 4])
def test_low_res_grid(scenes, cams, ss):
    js, ts, _ = scenes
    (jp, jv2w, _), (tp, tv2w, _) = cams
    w, h, d = GRID
    assert t_vis.low_res_dims(GRID, ss) == j_vis.low_res_dims(GRID, ss)
    wl, hl, dl = t_vis.low_res_dims(GRID, ss)
    for n, nl in ((w, wl), (h, hl)):
        a = t_vis.upsample_mats(n, nl, ss)
        np.testing.assert_array_equal(a, j_vis.upsample_mats(n, nl, ss))
        k0, wt = t_vis.tent_taps(n, nl, ss)
        rebuilt = np.zeros_like(a)
        np.add.at(rebuilt, (np.arange(n), k0), wt[0])
        np.add.at(rebuilt, (np.arange(n), np.minimum(k0 + 1, nl - 1)), wt[1])
        np.testing.assert_array_equal(rebuilt, a)
    jpos = jnp.concatenate([js.point_lights.position,
                            js.spot_lights.position])
    jrng = jnp.concatenate([js.point_lights.range, js.spot_lights.range])
    tpos = torch.cat([ts.point_lights.position, ts.spot_lights.position])
    trng = torch.cat([ts.point_lights.range, ts.spot_lights.range])
    np.testing.assert_array_equal(
        t_vis.low_slice_active(tp, tv2w, tpos, trng, GRID, ss).numpy(),
        np.asarray(j_vis.low_slice_active(jp, jv2w, jpos, jrng, GRID, ss)))


def _leaves(obj, prefix=""):
    """(name, value) of every array/static field of a scene, recursively."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), f"{prefix}.{f.name}")
    elif isinstance(obj, (tuple, list)):
        for i, o in enumerate(obj):
            yield from _leaves(o, f"{prefix}[{i}]")
    else:
        yield prefix, obj


def test_converter_matches_port_benchmark_scene(scenes):
    """The port's benchmark_scene == scene_from_numpy(JAX benchmark_scene),
    field by field (statics equal, arrays rtol/atol 1e-6: the JAX preset
    takes cos/sin of float32 angles, the port of float64 ones)."""
    _, converted, own = scenes
    a, b = dict(_leaves(own)), dict(_leaves(converted))
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, name
            close(x.to(torch.float32), y.to(torch.float32), msg=name)
        else:
            assert x == y, name


def test_state_from_numpy_layout():
    rng = np.random.default_rng(1)
    acc = rng.uniform(0, 1, (3, 4, 5, 4)).astype(np.float32)
    sh = rng.uniform(0, 1, (1, 3, 4, 5)).astype(np.float32)
    st = state_from_numpy(acc, sh, np.eye(4), 2, "cpu")
    np.testing.assert_array_equal(st.prev_accumulation.numpy(),
                                  acc.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(st.prev_shadow.numpy(), sh)
    assert st.frame_count == 2


def test_gbuffer_matches_jax(scenes):
    """render_scene_inputs: view depth within rel 1e-4 everywhere and
    colour within 2e-3 abs everywhere, 1e-5 on >= 98% of pixels. Ground-plane
    and sphere hits at grazing angles amplify last-ulp differences of the
    ray directions (tan, FMA order) into the hit distance."""
    kw = dict(volume_width=16, volume_height=15, volume_depth=16,
              image_width=128, image_height=120)
    js = j_bench(aspect=128 / 120, num_local_lights=4,
                 noise_mode="procedural")
    jr = JRenderer(dataclasses.replace(jconfig.FULL_CONFIG, **kw))
    tr = vt.VolumetricRenderer(dataclasses.replace(tconfig.FULL_CONFIG, **kw),
                               device="cpu")
    jc, jd = jax.jit(jr.render_scene_inputs)(js)
    tc, td = tr.render_scene_inputs(scene_from_numpy(js, "cpu"))
    jc, jd = np.asarray(jc), np.asarray(jd)
    close(td, jd, rtol=1e-4, atol=0.0, msg="depth")
    err = np.abs(tc.numpy() - jc)
    assert err.max() <= 2e-3, err.max()
    assert (err <= 1e-5).mean() >= 0.98, (err <= 1e-5).mean()
