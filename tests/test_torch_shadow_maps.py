"""The port's shadow-map frames (shadow_mode="map_dir" / "map", both sun
samplers) and composite_impl="pallas" against the JAX package on the CPU,
where each kernel wrapper takes its plain-torch twin:

  * shadow.py: fit_cascades, _light_basis, the three bakes and the three
    samplers, and the two low-grid map bakes of ops/visibility.py;
  * ops/pcf_shadow.py: `schedule` against `_schedule`, and the twin of
    kernel K12 against `pcf_dir_shadow_pallas` in interpret mode (called
    twice: at full rate, and on the low-rate grid) and against the gather
    sampler at other jitters;
  * pipeline.write_shadow_volume_dir in its three map routes;
  * K4's twin against `composite_pallas` (interpret mode);
  * frames of VolumetricRenderer(device="cpu") against the JAX render_frame
    on JAX's G-buffer and JAX's shadow bake, converted: map_dir over two
    frames with a moving camera, map, map_gather and pallas_composite over
    one each; the routing of every map config; the bake render_frame makes
    when it is given no shadow data.

Sizes are those of tests/test_pcf_pallas.py: a 20x12x16 grid and
shadow_map_size=64 (a 128x128 atlas per sun); frames at 160x96 pixels, the
8x8 cells K4 takes, on benchmark_scene (4 local lights, procedural noise).

Tolerances are stated at each test. Two classes recur:
  * knife-edge compares: `floor(u)` and `ref <= stored` flip for a
    coordinate within ulps of a texel edge or of a stored depth, and then
    the value moves by up to a full compare weight. The affine coefficients
    agree with JAX's to a few ulp (its einsums run at HIGHEST precision in
    another summation order), so at most 5e-3 of the samples may flip
    (tests/test_pcf_pallas.py's bound for its two samplers);
  * the frames: tests/torch_tolerance.assert_boundary_close."""

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
from volumetricrenderer_tpu import shadow as jshadow
from volumetricrenderer_tpu.jitter import JITTER_SEQUENCE
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import composite as j_composite
from volumetricrenderer_tpu.ops.pallas import pcf_shadow as j_pcf
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as tpipe
from volumetricrenderer_tpu_torch import renderer as trenderer
from volumetricrenderer_tpu_torch import shadow as tshadow
from volumetricrenderer_tpu_torch.convert import (dir_shadow_from_numpy,
                                                  scene_from_numpy,
                                                  shadow_data_from_numpy)
from volumetricrenderer_tpu_torch.ops import pcf_shadow as t_pcf
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import zg_composite as t_zg

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=20, volume_height=12, volume_depth=16,
             image_width=160, image_height=96, shadow_map_size=64)
ASPECT = 160 / 96
GRID = (20, 12, 16)
CAMERAS = [((-0.4, 1.9, -15.8), (0.1, -0.05, 1.0)),
           ((-0.1, 2.0, -15.2), (0.14, -0.06, 1.0))]
FLIPS = 5e-3        # the knife-edge share, see the module docstring
# name -> (config changes from FULL_CONFIG, frames)
PATHS = {
    "map_dir": (dict(shadow_mode="map_dir"), 2),
    "map": (dict(shadow_mode="map"), 1),
    "map_gather": (dict(shadow_mode="map", dir_shadow_impl="xla"), 1),
    "pallas_composite": (dict(composite_impl="pallas"), 1),
}
J_CFG = dataclasses.replace(J_FULL, **SMALL)
T_CFG = dataclasses.replace(vt.FULL_CONFIG, **SMALL)


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def close(got, want, rtol=1e-6, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def flips_at_most(got, want, share, msg, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    assert np.isfinite(got).all(), msg
    past = (np.abs(got - want) > atol).mean()
    assert past <= share, (msg, past, np.abs(got - want).max())


@pytest.fixture(scope="module")
def scenes():
    base = j_bench(aspect=ASPECT, num_local_lights=4,
                   noise_mode="procedural")
    return [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=ASPECT)) for p, f in CAMERAS]


def _params(js):
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near,
                                    J_CFG.volume_distance,
                                    J_CFG.depth_distribution, GRID)
    ts = scene_from_numpy(js, "cpu")
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, T_CFG.volume_distance,
                                    T_CFG.depth_distribution, GRID)
    return jp, tp, ts


@pytest.fixture(scope="module")
def bake(scenes):
    """JAX's map-mode bake of the first camera (aligned sun cascades, cube
    and spot maps), its unaligned sun bake, and the port's counterparts."""
    js = scenes[0]
    jp, tp, ts = _params(js)
    jr = JRenderer(dataclasses.replace(J_CFG, shadow_mode="map"))
    jd = jr.bake_shadow_data(js)
    ju = JRenderer(dataclasses.replace(J_CFG, shadow_mode="map",
                                       dir_shadow_impl="xla")
                   ).bake_shadow_data(js)[0]
    tr = vt.VolumetricRenderer(dataclasses.replace(T_CFG, shadow_mode="map"),
                               device="cpu")
    return dict(js=js, ts=ts, jp=jp, tp=tp, jd=jd, ju=ju,
                td=shadow_data_from_numpy(jd, "cpu"),
                tu=dir_shadow_from_numpy(ju, "cpu"),
                own=tr.bake_shadow_data(ts))


# --------------------------------------------------------------------------
# shadow.py
# --------------------------------------------------------------------------

def test_fit_cascades_and_light_basis_match_jax(scenes):
    """Cascade spheres and the light bases, aligned (incl. the degenerate
    light along the camera up) and not (incl. the polar fallback): 1e-6."""
    js = scenes[0]
    ts = scene_from_numpy(js, "cpu")
    jc, tc = js.camera, ts.camera
    want = jshadow.fit_cascades(jc.position, jc.forward, jc.fov_y, jc.aspect,
                                jc.near, J_CFG.shadow_distance,
                                J_CFG.cascade_splits)
    got = tshadow.fit_cascades(tc.position, tc.forward, tc.fov_y, tc.aspect,
                               tc.near, T_CFG.shadow_distance,
                               T_CFG.cascade_splits)
    for g, w in zip(got, want):
        close(g, w)
    up = np.asarray(jc.view_to_world()[:3, 1])
    for d in ((0.3, -0.7, 0.5), (0.0, -1.0, 0.05), tuple(-up),
              tuple(np.asarray(js.dir_lights.direction[0]))):
        d = np.asarray(d, np.float32)
        for align in (None, up):
            want = jshadow._light_basis(
                jnp.asarray(d), None if align is None else jnp.asarray(align))
            got = tshadow._light_basis(
                t_(d), None if align is None else t_(align))
            for g, w in zip(got, want):
                close(g, w, msg=f"{d} {align is not None}")


def test_bakes_match_jax(bake):
    """The port's bake_shadow_data against JAX's on the same scene: tables
    to 1e-6; the maps to 1e-5, except at most 0.5% of the texels, where a
    grazing bake ray's hit distance amplifies last-ulp direction
    differences (ROADMAP Queue C, G-buffer conditioning)."""
    jd, own = bake["jd"], bake["own"]
    assert own[0].aligned and jd[0].aligned
    for name in ("world_to_uv", "split_spheres", "split_sq_radii",
                 "strength_r", "bias"):
        close(getattr(own[0], name), getattr(jd[0], name), rtol=2e-6,
              msg=name)
    for name in ("light_pos", "range", "strength_r", "bias"):
        close(getattr(own[1], name), getattr(jd[1], name), msg=name)
    for name in ("light_pos", "axes", "tan_half_angle", "range"):
        close(getattr(own[2], name), getattr(jd[2], name), msg=name)
    for got, want in ((own[0].atlas, jd[0].atlas), (own[1].faces,
                                                    jd[1].faces),
                      (own[2].maps, jd[2].maps)):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        assert (np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)).mean() \
            <= 5e-3
        assert want.min() < 0.9 and want.max() <= 1.0      # occluders seen
    unaligned = vt.VolumetricRenderer(dataclasses.replace(
        T_CFG, shadow_mode="map", dir_shadow_impl="xla"),
        device="cpu").bake_shadow_data(bake["ts"])[0]
    assert not unaligned.aligned
    close(unaligned.world_to_uv, bake["ju"].world_to_uv, rtol=2e-6)


def _world_points(n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-12.0, 0.0, -12.0]), np.array([12.0, 8.0, 30.0])
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def test_samplers_match_jax(bake):
    """sample_dir_shadow (aligned and unaligned bakes), sample_cube_shadow
    and sample_spot_shadow on JAX's converted bake at 4096 seeded world
    points: compare flips only (FLIPS), everything else to 1e-6."""
    pts = _world_points(4096, 5)
    jd, td = bake["jd"], bake["td"]
    n_pt, n_sp = td[1].light_pos.shape[0], td[2].light_pos.shape[0]

    @jax.jit
    def jax_samples(p, d, u):
        out = [jshadow.sample_dir_shadow(d[0], 0, p),
               jshadow.sample_dir_shadow(u, 0, p)]
        out += [jshadow.sample_cube_shadow(d[1], i, p - d[1].light_pos[i])
                for i in range(n_pt)]
        return out + [jshadow.sample_spot_shadow(d[2], i, p)
                      for i in range(n_sp)]

    tp = t_(pts)
    got = [tshadow.sample_dir_shadow(td[0], 0, tp),
           tshadow.sample_dir_shadow(bake["tu"], 0, tp)]
    got += [tshadow.sample_cube_shadow(td[1], i, tp - td[1].light_pos[i])
            for i in range(n_pt)]
    got += [tshadow.sample_spot_shadow(td[2], i, tp) for i in range(n_sp)]
    names = ["dir", "dir unaligned"] + [f"cube {i}" for i in range(n_pt)] \
        + [f"spot {i}" for i in range(n_sp)]
    cases = zip(names, jax_samples(jnp.asarray(pts), jd, bake["ju"]), got)
    for name, want, got in cases:
        want = np.asarray(want)
        flips_at_most(got.numpy(), want, FLIPS, name, atol=1e-6)
        assert want.min() < want.max(), name        # shadowed and lit


@pytest.mark.parametrize("radiance", [True, False],
                         ids=["radiance", "visibility"])
def test_map_bakes_match_jax(bake, radiance):
    """bake_radiance_from_maps (with the fBm channels) and
    bake_visibility_from_maps at ss=2 on JAX's converted maps: the map
    compares may flip (FLIPS of the samples); radiance to rtol 1e-5."""
    js, ts = bake["js"], bake["ts"]
    jit = np.asarray(JITTER_SEQUENCE[3])
    jv2w = js.camera.view_to_world()
    tv2w = ts.camera.view_to_world()
    jd, td = bake["jd"], bake["td"]
    if radiance:
        want = jax.jit(lambda d: j_vis.bake_radiance_from_maps(
            J_CFG, bake["jp"], jv2w, js.camera.position, jnp.asarray(jit),
            js.point_lights, js.spot_lights, d[1], d[2], js.media, 0.3, 2,
            bake_noise=True))(jd)
        got = t_vis.bake_radiance_from_maps(
            T_CFG, bake["tp"], tv2w, ts.camera.position, t_(jit),
            ts.point_lights, ts.spot_lights, td[1], td[2], ts.media, 0.3, 2,
            bake_noise=True)
    else:
        want = j_vis.bake_visibility_from_maps(
            J_CFG, bake["jp"], jv2w, jnp.asarray(jit), js.point_lights,
            js.spot_lights, jd[1], jd[2], 2)
        got = t_vis.bake_visibility_from_maps(
            T_CFG, bake["tp"], tv2w, t_(jit), ts.point_lights,
            ts.spot_lights, td[1], td[2], 2)
    want = np.asarray(want)
    assert got.shape == want.shape == (4, 8, 6, 10)   # rgb + fBm; 4 lights
    err = np.abs(got.numpy() - want)
    assert (err > 1e-6 + 1e-5 * np.abs(want)).mean() <= FLIPS
    assert want[:3].max() > 0.0


# --------------------------------------------------------------------------
# ops/pcf_shadow.py
# --------------------------------------------------------------------------

def _pcf_args(bake, jitter_idx, low: bool):
    """(JAX args, port args) of pcf_dir_shadow(_pallas) for the first
    camera: full rate, or the low-rate grid of dir_shadow_subsample=2."""
    js, ts = bake["js"], bake["ts"]
    jit = np.asarray(JITTER_SEQUENCE[jitter_idx], np.float32)
    w, h, d = GRID
    grid = (w // 2, h, d // 2) if low else GRID
    jp, tp = bake["jp"], bake["tp"]
    if low:
        jit = jit * np.asarray([0.5, 1.0, 0.5], np.float32)
        jp = dataclasses.replace(jp, grid=(w, h, d // 2))
        tp = dataclasses.replace(tp, grid=(w, h, d // 2))
    return ((jp, js.camera.view_to_world(), jnp.asarray(jit), js.dir_lights,
             bake["jd"][0], grid),
            (tp, ts.camera.view_to_world(), jit, ts.dir_lights, bake["td"][0],
             grid))


@pytest.fixture(scope="module")
def pallas_pcf(bake):
    """pcf_dir_shadow_pallas in interpret mode, the only two direct calls:
    full rate at jitter 0, the low-rate grid at jitter 2."""
    out = {}
    for key, ji, low in (("full", 0, False), ("low", 2, True)):
        ja, ta = _pcf_args(bake, ji, low)
        out[key] = (np.asarray(j_pcf.pcf_dir_shadow_pallas(
            *ja, interpret=True)), ta)
    return out


@pytest.mark.parametrize("low", [False, True], ids=["full", "low"])
def test_schedule_matches_jax(bake, low):
    """schedule against _schedule on the aligned bake: coef to 2 ulp of its
    magnitude (explicit sums against HIGHEST einsums), order, count and the
    (clear) overflow flag exactly."""
    ja, ta = _pcf_args(bake, 1, low)
    want = jax.jit(lambda jit, data: j_pcf._schedule(
        ja[0], ja[1], jit, data, 0, ja[5], 128))(ja[2], ja[4])
    got = t_pcf.schedule(ta[0], ta[1], ta[2], ta[4], 0, ta[5], 128)
    par, coef, winb, order, count, spheres, overflow = got
    jcoef = np.asarray(want[1])
    close(coef, jcoef, rtol=0, atol=3e-7 * np.abs(jcoef).max())
    close(par[:22], np.asarray(want[0])[0, :22], rtol=1e-6)
    np.testing.assert_array_equal(order.numpy(), np.asarray(want[3])[:, 0])
    np.testing.assert_array_equal(count.numpy(), np.asarray(want[4])[:, 0,
                                                                      0])
    np.testing.assert_array_equal(winb.numpy(), np.asarray(want[2]))
    close(spheres, want[5])
    assert overflow is False and not bool(want[6])
    assert 0 < int(count.max()) <= 4 and int(count.min()) >= 0


def test_schedule_overflow_flag_matches_jax(bake):
    """With a 128-texel window on a 512-texel atlas (the window smaller
    than a cascade's quadrant) JAX flags a footprint that leaves its window,
    and so does the port; the flag then poisons the twin's output with NaN
    where the light casts shadows."""
    ja, ta = _pcf_args(bake, 0, False)
    jbig = dataclasses.replace(ja[4], atlas=jnp.zeros((1, 512, 512)))
    tbig = dataclasses.replace(ta[4], atlas=torch.zeros((1, 512, 512)))
    flags = []
    for win in (128, 512):
        want = jax.jit(lambda jit, data: j_pcf._schedule(
            ja[0], ja[1], jit, data, 0, ja[5], win))(ja[2], jbig)
        got = t_pcf.schedule(ta[0], ta[1], ta[2], tbig, 0, ta[5], win)
        assert got[6] == bool(want[6])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        flags.append(got[6])
    assert flags == [True, False]
    t = t_pcf.pack_tables(*ta[:4], tbig, ta[5], win=128)
    assert float(t.par[0, 23]) == 1.0
    out = t_pcf.pcf_shadow(t, tbig.atlas)
    assert torch.isnan(out).all()
    ungated = dataclasses.replace(ta[3], has_shadow=torch.tensor([False]))
    t = t_pcf.pack_tables(*ta[:3], ungated, tbig, ta[5], win=128)
    assert float(t.par[0, 23]) == 0.0
    assert bool((t_pcf.pcf_shadow(t, tbig.atlas) == 1.0).all())


@pytest.mark.parametrize("key", ["full", "low"])
def test_pcf_twin_matches_pallas(pallas_pcf, key):
    """K12's twin against pcf_dir_shadow_pallas (interpret mode) on the
    aligned bake: equal except for compare flips (at most FLIPS of the
    froxels past 1e-5); shadowed and lit froxels both present."""
    want, ta = pallas_pcf[key]
    got = t_pcf.pcf_dir_shadow(*ta)
    flips_at_most(got.numpy(), want, FLIPS, key)
    assert want.min() < 0.5 and want.max() == 1.0
    got_w = tpipe.write_shadow_volume_dir(
        dataclasses.replace(T_CFG, shadow_mode="map_dir",
                            dir_shadow_subsample=1),
        None, dir_lights=ta[3], dir_shadow=ta[4],
        pcf=t_pcf.pack_tables(*ta)) if key == "full" else got
    assert torch.equal(got_w, got)


@pytest.mark.parametrize("jitter_idx", [1, 4, 6])
def test_pcf_low_grid_matches_gather_sampler(bake, jitter_idx):
    """The twin on the low-rate grid at other jitters against the gather
    sampler at the low-rate continuous positions (full coordinates
    2i + 1/2, y at full rate), as tests/test_pcf_pallas.py holds the TPU
    kernel: at most FLIPS of the samples past 1e-4."""
    _, ta = _pcf_args(bake, jitter_idx, True)
    low = t_pcf.pcf_dir_shadow(*ta)
    jit = np.asarray(JITTER_SEQUENCE[jitter_idx])
    w, h, d = GRID
    fz = 2 * np.arange(d // 2) + 0.5 + 0.5
    fy = np.arange(h) + 0.5
    fx = 2 * np.arange(w // 2) + 0.5 + 0.5
    zz, yy, xx = np.meshgrid(fz, fy, fx, indexing="ij")
    fro = (np.stack([xx, yy, zz], -1) + jit).astype(np.float32)
    js = bake["js"]
    world = jfroxel.transform_points(js.camera.view_to_world(),
                                     jfroxel.froxel_to_view(bake["jp"],
                                                            jnp.asarray(fro)))
    vis = np.asarray(jshadow.sample_dir_shadow(bake["jd"][0], 0, world))
    flips_at_most(low.numpy(), (vis * vis)[None], FLIPS, jitter_idx,
                  atol=1e-4)


def test_write_shadow_volume_dir_map_routes(bake, pallas_pcf, monkeypatch):
    """The three map routes of write_shadow_volume_dir against the JAX pass:
    the gather sampler on the unaligned bake (compare flips only); the
    low-rate PCF route, upsampled, on the aligned bake (JAX's pass runs on
    the cached interpret-mode low volume of the fixture, so the upsample is
    JAX's own: flips as above, the tent to 1e-6); the full-rate route is
    held in test_pcf_twin_matches_pallas."""
    js, ts = bake["js"], bake["ts"]
    jit = JITTER_SEQUENCE[2]
    jcfg = dataclasses.replace(J_CFG, shadow_mode="map")
    tcfg = dataclasses.replace(T_CFG, shadow_mode="map")
    geo = tpipe.FrameGeometry(params=bake["tp"],
                              view_to_world=ts.camera.view_to_world(),
                              prev_world_to_view=torch.eye(4),
                              jitter=t_(jit), alpha=0.0)
    want = jpipe.write_shadow_volume_dir(
        dataclasses.replace(jcfg, dir_shadow_impl="xla"), bake["jp"],
        js.camera.view_to_world(), jit, js.dir_lights, bake["ju"],
        js.geometry)
    got = tpipe.write_shadow_volume_dir(
        dataclasses.replace(tcfg, dir_shadow_impl="xla"), None, geo,
        ts.dir_lights, ts.geometry, bake["tu"])
    flips_at_most(got.numpy(), want, FLIPS, "gather")

    low_want, ta = pallas_pcf["low"]
    monkeypatch.setattr(j_pcf, "pcf_dir_shadow_pallas",
                        lambda *a, **k: jnp.asarray(low_want))
    want = np.asarray(jpipe.write_shadow_volume_dir(
        jcfg, bake["jp"], js.camera.view_to_world(), jit, js.dir_lights,
        bake["jd"][0], js.geometry))
    assert tpipe.uses_pcf_kernel(tcfg, bake["td"][0], 1)
    assert tpipe.pcf_rate(tcfg) == 2
    pcf = tpipe.pack_pcf_tables(tcfg, bake["tp"], ts.camera.view_to_world(),
                                jit, ts.dir_lights, bake["td"][0])
    assert pcf.grid_whd == (10, 12, 8)
    got = tpipe.write_shadow_volume_dir(tcfg, None, dir_shadow=bake["td"][0],
                                        pcf=pcf)
    assert got.shape == (1, 16, 12, 20)
    # the same low volume through the port's upsample: JAX's tent exactly
    close(tpipe.upsample_pcf(tcfg, t_(low_want)), want, rtol=1e-6, atol=1e-7)
    flips_at_most(got.numpy(), want, 4 * FLIPS, "low-rate route")


# --------------------------------------------------------------------------
# K4 for composite_impl="pallas"
# --------------------------------------------------------------------------

def test_composite_twin_matches_composite_pallas(bake):
    """K4's twin against composite_pallas (interpret mode) with view depths
    that put fz below 0 and past D - 1 as well as inside, on a seeded
    accumulation: the same clamped taps at the image borders and the same z
    clip; values to 2e-5 relative of the image (composite_pallas rebuilds
    the f32 volume from a hi/lo bf16 split, ~2^-17 relative)."""
    rng = np.random.default_rng(7)
    w, h, d = GRID
    acc = rng.uniform(0.0, 1.0, (d, h, w, 4)).astype(np.float32)
    scene = rng.uniform(0.0, 1.0, (96, 160, 3)).astype(np.float32)
    depth = rng.uniform(0.05, 140.0, (96, 160)).astype(np.float32)
    jp, tp = bake["jp"], bake["tp"]
    fz = jfroxel.depth_to_froxel_z(jp, jnp.asarray(depth)) - 0.5
    assert float(fz.min()) < 0.0 and float(fz.max()) > d - 1.0
    want = np.asarray(jax.jit(lambda a, s, z: j_composite.composite_pallas(
        a, s, z, GRID, interpret=True))(jnp.asarray(acc), jnp.asarray(scene),
                                        fz))
    got = t_zg.composite(t_(acc).permute(3, 0, 1, 2).contiguous(), t_(scene),
                         t_(depth), tp, GRID)
    close(got.numpy(), want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_k4_admits_what_composite_pallas_takes():
    """K4 takes every composite: its cells wherever JAX takes the zgather
    kernel, composite_pallas or tentmm (integer pixel/froxel ratios), its
    per-pixel form at any other ratio (rowmm, anyres) and for the "xla"
    gather, and its planes at the low resolution for the co-sited
    composite."""
    from volumetricrenderer_tpu_torch.config import composite_route
    full = vt.FULL_CONFIG
    assert composite_route(full) == "cells"
    assert composite_route(dataclasses.replace(
        full, composite_impl="pallas")) == "cells"
    assert composite_route(dataclasses.replace(
        full, composite_impl="pallas", volume_height=136,
        image_height=1088)) == "cells"
    assert composite_route(dataclasses.replace(
        full, composite_impl="pallas", image_width=1000)) == "pixels"
    assert composite_route(dataclasses.replace(
        full, composite_impl="tentmm")) == "cells"
    assert composite_route(dataclasses.replace(
        full, composite_impl="xla")) == "pixels"
    # UHD_CONFIG: K4 at the low resolution (the co-sited composite); with
    # the tentmm composite JAX composites the full 4K image (16x16 cells)
    assert composite_route(vt.UHD_CONFIG) == "cosited"
    assert composite_route(dataclasses.replace(
        vt.UHD_CONFIG, composite_impl="tentmm")) == "cells"


# --------------------------------------------------------------------------
# Frames against the JAX render_frame
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(scenes, bake):
    """Per camera: JAX's G-buffer; per path and camera: JAX's shadow bake
    (the first camera's from the `bake` fixture, which bakes what each
    mode bakes there)."""
    jr = JRenderer(J_CFG)
    gbuf = [tuple(np.array(a) for a in jax.jit(jr.render_scene_inputs)(sc))
            for sc in scenes]
    jd, ju = bake["jd"], bake["ju"]
    map_dir = JRenderer(dataclasses.replace(J_CFG, **PATHS["map_dir"][0]))
    bakes = {"map_dir": [(jd[0], None, None),
                         map_dir.bake_shadow_data(scenes[1])],
             "map": [jd], "map_gather": [(ju, jd[1], jd[2])],
             "pallas_composite": [(None, None, None)]}
    return gbuf, bakes


@pytest.fixture(scope="module", params=list(PATHS))
def both(request, scenes, inputs):
    name = request.param
    kw, n = PATHS[name]
    gbuf, bakes = inputs
    jr = JRenderer(dataclasses.replace(J_CFG, **kw))
    step = jax.jit(lambda s, sc, t, c, d, sd: jr.render_frame(
        s, sc, t, scene_color=c, view_depth=d, shadow_data=sd))
    tr = vt.VolumetricRenderer(dataclasses.replace(T_CFG, **kw),
                               device="cpu")
    st, ts = jr.init_state(1), tr.init_state(1)
    out = []
    for i in range(n):
        c, d = gbuf[i]
        sd = bakes[name][i]
        jimg, jaux, st = step(st, scenes[i], jnp.float32(0.1 * i), c, d, sd)
        timg, taux, ts = tr.render_frame(
            ts, scene_from_numpy(scenes[i], "cpu"), np.float32(0.1 * i),
            t_(c), t_(d), shadow_data=shadow_data_from_numpy(sd, "cpu"))
        out.append((np.asarray(jimg), jaux, timg.numpy(), taux))
    return name, n, out, st, ts


def test_map_frames_match_jax(both):
    """Images, aux shadow and accumulation of every frame, and the final
    histories: assert_boundary_close, and a mean image error of at most
    1e-5 of the image maximum."""
    name, n, out, st, ts = both
    for i, (jimg, jaux, timg, taux) in enumerate(out):
        assert timg.shape == jimg.shape == (96, 160, 4)
        assert_boundary_close(timg, jimg, f"{name} image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
        assert_boundary_close(taux["shadow"].numpy(), jaux["shadow"],
                              f"{name} aux shadow {i}")
        assert_boundary_close(
            taux["accumulation"].permute(1, 2, 3, 0).numpy(),
            jaux["accumulation"], f"{name} aux accumulation {i}")
    assert ts.frame_count == n
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          f"{name} shadow history")
    assert_boundary_close(
        ts.prev_accumulation.permute(1, 2, 3, 0).numpy(),
        packed_accumulation(st.prev_accumulation, (16, 12, 20)),
        f"{name} accumulation history")
    shadow = out[-1][3]["shadow"]
    assert float(shadow.min()) < 0.5 and float(shadow.max()) == 1.0


@pytest.mark.parametrize("kw", [dict(shadow_mode="map_dir"),
                                dict(shadow_mode="map"),
                                dict(shadow_mode="map",
                                     dir_shadow_impl="xla"),
                                dict(shadow_mode="map_dir",
                                     dir_shadow_subsample=1),
                                dict(shadow_mode="map", scatter_bake="vis",
                                     raycast_shadow_subsample=1)],
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_map_configs_leave_the_raycast_kernels(kw, monkeypatch):
    """No map config reaches the fused volume phase (K1-K3) or the raycast
    shadow + blend (K5): with both monkeypatched to raise, each renders,
    finite; and render_frame without shadow data bakes exactly what
    bake_shadow_data returns."""
    def boom(*a, **k):
        raise AssertionError("a raycast kernel ran in a map config")
    monkeypatch.setattr(trenderer, "volume_phase", boom)
    monkeypatch.setattr(trenderer, "dir_shadow_blend", boom)
    r = vt.VolumetricRenderer(dataclasses.replace(T_CFG, **kw), device="cpu")
    scene = vt.benchmark_scene(aspect=ASPECT, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    st = r.init_state(1)
    img, aux, _ = r.render_frame(st, scene, 0.0)
    assert bool(torch.isfinite(img).all())
    img2, _, _ = r.render_frame(st, scene, 0.0,
                                shadow_data=r.bake_shadow_data(scene))
    assert torch.equal(img, img2)
    assert not r.fuses_frame()


def test_bake_shadow_data_follows_jax(scenes):
    """Which maps each mode bakes, and whether the sun bake is aligned, as
    the JAX renderer's bake_shadow_data decides."""
    js = scenes[0]
    ts = scene_from_numpy(js, "cpu")
    for kw in (dict(), dict(shadow_mode="map"), dict(shadow_mode="map_dir"),
               dict(shadow_mode="map", dir_shadow_impl="xla"),
               dict(shadow_mode="map_dir", dir_shadow_impl="xla")):
        want = JRenderer(dataclasses.replace(J_CFG, **kw)).bake_shadow_data(js)
        got = vt.VolumetricRenderer(dataclasses.replace(T_CFG, **kw),
                                    device="cpu").bake_shadow_data(ts)
        assert [g is None for g in got] == [w is None for w in want], kw
        if want[0] is not None:
            assert got[0].aligned == want[0].aligned, kw
