"""The port's plain XLA scatter (pipeline.write_scatter_xla, the branch of
JAX pipeline.write_scatter_volume taken when `use_pallas_scatter` is False)
and the frames that only it serves, against the JAX package on the CPU:

  * ops/falloff and ops/phase.henyey_greenstein against JAX's, rtol and
    atol 1e-6 (the same float32 operations);
  * write_scatter_volume on benchmark_scene (4 local lights) at a 16x11x12
    grid: raycast local shadows at raycast_shadow_subsample 1 and 2, map
    mode with the cube and spot maps (JAX's bake, converted), and a scene
    with no local lights; JAX run op by op (jax.disable_jit), since under
    jit XLA's CPU backend contracts multiply-adds;
  * the routing: uses_scatter_kernel and fuses_frame(scene) against the
    JAX conditions, and the map-mode frame without local maps;
  * frames of VolumetricRenderer(device="cpu") against JAX render_frame,
    also run op by op, over 2 frames with a moving camera: DEMO_CONFIG on
    demo_scene (map mode, the gather sun sampler, the XLA scatter and
    plain scan, per-pixel composite) with the terrain cut to 4 steps of 1
    octave as tests/test_torch_terrain.py cuts it, at a 16x11x12 grid and
    128x90 pixels, and RenderConfig() on benchmark_scene; both on JAX's
    G-buffer and JAX's shadow maps of the first camera, baked once and
    converted, as a caller passes shadow_data. Under jit the JAX frame's
    shadow sampler moves by up to 2e-5 from the op-by-op one on 0.3% of
    the froxels: the multiply-adds XLA contracts.

Tolerance: tests/torch_tolerance.assert_boundary_close (shadow rays and
shadow-map compares within ulps of an edge may flip), and for the images
a mean absolute error of at most 1e-5 of the image maximum. The frames'
sun shadow volumes come from the gather sampler shadow.sample_dir_shadow,
whose cascade coordinates agree with JAX's to a few ulp (JAX's einsums
sum in another order): they are held to that sampler's class in
tests/test_torch_shadow_maps.py, at most 5e-3 of the froxels past 1e-5
absolute (the demo frame's second shadow volume: 0.57% of the froxels
past rtol 1e-5, by at most 1.3e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import DEMO_CONFIG as J_DEMO
from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import RenderConfig as JRenderConfig
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo
from volumetricrenderer_tpu.ops import falloff as j_falloff
from volumetricrenderer_tpu.ops import phase as j_phase
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as tpipeline
from volumetricrenderer_tpu_torch.convert import (scene_from_numpy,
                                                  shadow_data_from_numpy)
from volumetricrenderer_tpu_torch.ops import falloff as t_falloff
from volumetricrenderer_tpu_torch.ops import phase as t_phase
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

# a 16x11 grid at 128x90 pixels: 90/11 is no integer, as 720/88 at the
# demo grid (JAX: composite_rowmm; the port: K4's per-pixel form)
FRAME = dict(volume_width=16, volume_height=11, volume_depth=12,
             image_width=128, image_height=90, shadow_map_size=64)
SCATTER = dict(FRAME, scatter_impl="xla")
GRID = (16, 11, 12)
ASPECT = 128 / 90
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def sampler_close(got, want, msg, share=5e-3, atol=1e-5):
    """The gather sampler's class (tests/test_torch_shadow_maps.py
    flips_at_most): finite, and at most `share` of the elements past
    `atol`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), msg
    past = (np.abs(got - want) > atol).mean()
    assert past <= share, (msg, past, np.abs(got - want).max())


def no_local_lights(scene):
    """The scene (either package's) with its point and spot lights cut to
    none."""
    def cut(lights):
        return dataclasses.replace(lights, **{
            f.name: getattr(lights, f.name)[:0]
            for f in dataclasses.fields(lights)})
    return dataclasses.replace(scene, point_lights=cut(scene.point_lights),
                               spot_lights=cut(scene.spot_lights))


# --------------------------------------------------------------------------
# falloff and phase
# --------------------------------------------------------------------------

def test_falloffs_and_phase_match_jax():
    rng = np.random.default_rng(0)
    n = 4096
    dist = rng.uniform(0.0, 40.0, n).astype(np.float32)
    rng_ = rng.uniform(5.0, 35.0, n).astype(np.float32)
    mult = rng.uniform(0.5, 2.0, n).astype(np.float32)
    cos_a = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    cos_out = rng.uniform(0.3, 0.9, n).astype(np.float32)
    inner_rcp = (1.0 / rng.uniform(0.9, 1.0, n)).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, n).astype(np.float32)
    x = rng.uniform(0.0, 1.5, n).astype(np.float32)
    pairs = [
        (t_falloff.attenuation_lut(t_(x)), j_falloff.attenuation_lut(x)),
        (t_falloff.point_light_falloff(t_(dist), t_(rng_), t_(mult)),
         j_falloff.point_light_falloff(dist, rng_, mult)),
        (t_falloff.spot_light_falloff(t_(dist), t_(cos_a), t_(rng_),
                                      t_(cos_out), t_(inner_rcp), t_(mult)),
         j_falloff.spot_light_falloff(dist, cos_a, rng_, cos_out, inner_rcp,
                                      mult)),
        (t_phase.henyey_greenstein(t_(g), t_(cos_a)),
         j_phase.henyey_greenstein(g, cos_a))]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))


# --------------------------------------------------------------------------
# write_scatter_volume's XLA branch
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_maps():
    """benchmark_scene (4 local lights) and JAX's map-mode bake of it at
    its first camera (sun cascades, cube and spot maps)."""
    js = j_bench(aspect=ASPECT, num_local_lights=4, noise_mode="procedural")
    return js, JRenderer(JRenderConfig(**FRAME)).bake_shadow_data(js)


@pytest.fixture(scope="module")
def scatter_inputs(bench_maps):
    """benchmark_scene, random material and shadow volumes from one seed,
    and JAX's cube and spot maps."""
    js, (_, cube, spot) = bench_maps
    rng = np.random.default_rng(1)
    d, h, w = GRID[2], GRID[1], GRID[0]
    mat_a = np.concatenate([rng.uniform(0.0, 0.08, (d, h, w, 3)),
                            rng.uniform(0.0, 0.03, (d, h, w, 1))],
                           -1).astype(np.float32)
    mat_b = np.zeros((d, h, w, 4), np.float32)
    mat_b[..., 0] = rng.uniform(-0.5, 0.8, (d, h, w))
    shadow = rng.uniform(0.0, 1.0, (1, d, h, w)).astype(np.float32)
    return dict(js=js, mat_a=mat_a, mat_b=mat_b, shadow=shadow, cube=cube,
                spot=spot)


def run_scatter(inp, js, cfg_kw, maps):
    """JAX write_scatter_volume op by op and the port's
    write_scatter_volume (its XLA branch) on the same inputs; both
    [D, H, W, 4]."""
    jcfg = JRenderConfig(**{**SCATTER, **cfg_kw})
    tcfg = vt.RenderConfig(**{**SCATTER, **cfg_kw})
    cam = js.camera
    ts = scene_from_numpy(js, "cpu")
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near,
                                    jcfg.volume_distance,
                                    jcfg.depth_distribution, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, tcfg.volume_distance,
                                    tcfg.depth_distribution, GRID)
    cube, spot = (inp["cube"], inp["spot"]) if maps else (None, None)
    with jax.disable_jit():
        want = jpipeline.write_scatter_volume(
            jcfg, jp, cam.view_to_world(), cam.position, jnp.asarray(JIT),
            jnp.asarray(inp["mat_a"]), jnp.asarray(inp["mat_b"]),
            jnp.asarray(inp["shadow"]), js.dir_lights, js.point_lights,
            js.spot_lights, cube, spot, js.geometry)
    v2w = ts.camera.view_to_world()
    geo = tpipeline.FrameGeometry(params=tp, view_to_world=v2w,
                                  prev_world_to_view=tfroxel.invert_rigid(
                                      v2w), jitter=t_(JIT), alpha=0.0,
                                  grid=GRID)
    t_maps = shadow_data_from_numpy((None, cube, spot), "cpu")[1:]
    material = (t_(inp["mat_a"]).permute(3, 0, 1, 2).contiguous(),
                t_(inp["mat_b"][..., :1]).permute(3, 0, 1, 2).contiguous())
    got = tpipeline.write_scatter_volume(tcfg, None, t_(inp["shadow"]),
                                         material, geo, ts, t_maps)
    return got.permute(1, 2, 3, 0).numpy(), np.asarray(want)


@pytest.mark.parametrize("case", ["raycast_ss1", "raycast_ss2", "map_maps",
                                  "no_local_lights"])
def test_write_scatter_xla_matches_jax(scatter_inputs, case):
    inp = scatter_inputs
    js = inp["js"]
    kw, maps = {
        "raycast_ss1": (dict(shadow_mode="raycast"), False),
        "raycast_ss2": (dict(shadow_mode="raycast",
                             raycast_shadow_subsample=2), False),
        "map_maps": (dict(shadow_mode="map"), True),
        "no_local_lights": (dict(shadow_mode="raycast",
                                 scatter_impl="pallas"), False)}[case]
    if case == "no_local_lights":
        js = no_local_lights(js)
    got, want = run_scatter(inp, js, kw, maps)
    assert got.shape == want.shape == (12, 11, 16, 4)
    assert np.isfinite(got).all()
    assert_boundary_close(got, want, case)
    # every term is there: the suns' extinction, and light in r, g, b
    assert (got[..., 3] > 0).all() and (got[..., :3] > 0).any()


def test_scatter_routes_follow_jax():
    """uses_scatter_kernel is JAX's use_pallas_scatter for a scene with
    geometry; fuses_frame(scene) needs local lights and media, as JAX's
    fuse_frame does; a map-mode frame whose shadow data has no local maps
    takes the XLA scatter."""
    k = tpipeline.uses_scatter_kernel
    full = vt.FULL_CONFIG
    xla = dataclasses.replace(full, scatter_impl="xla")
    mp = dataclasses.replace(full, shadow_mode="map")
    assert k(full, 4) and k(full, 4, (None, None))
    assert not k(full, 0) and not k(xla, 4)
    assert k(mp, 4) and k(mp, 4, ("cube", None)) and k(mp, 4, (None, "s"))
    assert not k(mp, 4, (None, None)) and not k(mp, 0)
    assert k(dataclasses.replace(full, shadow_mode="map_dir"), 4,
             (None, None))
    scene = vt.benchmark_scene(aspect=ASPECT, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    r = vt.VolumetricRenderer(full, device="cpu")
    assert r.fuses_frame() and r.fuses_frame(scene)
    assert not r.fuses_frame(dataclasses.replace(scene, media=()))
    bare = no_local_lights(scene)
    assert not r.fuses_frame(bare) and not r.scatter_kernel(bare)
    assert not vt.VolumetricRenderer(xla, device="cpu").fuses_frame()
    assert not tpipeline.fuses_material(full, scene.media, False)
    assert tpipeline.fuses_material(full, scene.media, True)


# --------------------------------------------------------------------------
# Frames against JAX render_frame
# --------------------------------------------------------------------------

def cheap_terrain(js):
    return dataclasses.replace(js, geometry=dataclasses.replace(
        js.geometry, hf_steps=4, hf_octaves=1))


# name -> (JAX config, the port's)
FRAMES = {
    # DEMO_CONFIG on demo_scene: demo.py's frame
    "demo": (dataclasses.replace(J_DEMO, **FRAME),
             dataclasses.replace(vt.DEMO_CONFIG, **FRAME)),
    # RenderConfig() on benchmark_scene
    "default": (JRenderConfig(**FRAME), vt.RenderConfig(**FRAME)),
}


@pytest.fixture(scope="module", params=list(FRAMES))
def frames(request, bench_maps):
    jcfg, tcfg = FRAMES[request.param]
    jr = JRenderer(jcfg)
    if request.param == "demo":
        base = cheap_terrain(j_demo(aspect=ASPECT))
        maps = jr.bake_shadow_data(base)
    else:
        base, maps = bench_maps
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=ASPECT)) for p, f in CAMERAS]
    tr = vt.VolumetricRenderer(tcfg, device="cpu")
    gbuf = jax.jit(jr.render_scene_inputs)
    nd = base.dir_lights.count
    st, ts = jr.init_state(nd), tr.init_state(nd)
    t_maps = shadow_data_from_numpy(maps, "cpu")
    out = []
    for i, sc in enumerate(scenes):
        c, d = (np.array(a) for a in gbuf(sc))
        with jax.disable_jit():
            jimg, jaux, st = jr.render_frame(
                st, sc, jnp.float32(0.1 * i), scene_color=c, view_depth=d,
                shadow_data=maps)
        timg, taux, ts = tr.render_frame(
            ts, scene_from_numpy(sc, "cpu"), np.float32(0.1 * i), t_(c),
            t_(d), shadow_data=t_maps)
        out.append((np.asarray(jimg), jaux, timg.numpy(), taux))
    return request.param, tr, out, st, ts


def test_xla_scatter_frames_match_jax(frames):
    """Images, aux scatter and shadow of both frames, and the histories."""
    name, tr, out, st, ts = frames
    assert not tr.fuses_frame()
    for i, (jimg, jaux, timg, taux) in enumerate(out):
        assert timg.shape == jimg.shape == (90, 128, 4)
        assert_boundary_close(timg, jimg, f"{name} image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
        assert_boundary_close(taux["scatter"].permute(1, 2, 3, 0).numpy(),
                              jaux["scatter"], f"{name} scatter {i}")
        sampler_close(taux["shadow"].numpy(), jaux["shadow"],
                      f"{name} shadow {i}")
    assert ts.frame_count == 2
    sampler_close(ts.prev_shadow.numpy(), st.prev_shadow,
                  f"{name} shadow history")
    assert_boundary_close(
        t_packed(ts.prev_accumulation).numpy(),
        packed_accumulation(st.prev_accumulation, (12, 11, 16)),
        f"{name} accumulation history")
    assert out[-1][2][..., :3].std() > 1e-3
