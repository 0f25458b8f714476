"""Scenes with more suns and more noise media than the kernels' fixed forms
keep in their arrays (ops/scatter.MAX_DIR, MAX_NOISE: 4 each), against the
JAX package on the CPU:

  * the fused frame through VolumetricRenderer(device="cpu") against the
    JAX render_frame under jax.jit (one compilation, a module fixture):
    FULL_CONFIG at a 16x15x16 grid and 128x120 pixels on JAX's G-buffer,
    benchmark_scene (4 local lights, procedural noise) with 6 distinct suns
    and 6 procedural noise media (seeds 7-12, one of 5 octaves), 2 frames
    with a moving camera: the image, scatter, shadow and both histories;
    its tables (6 suns, 6 noise channels) and its route (fused, K1's
    radiance bake);
  * each module that holds a kernel with a general form against its JAX
    function, Pallas in interpret mode, on the inputs of that second frame
    (JAX's params, jitter, previous view and histories after frame 1), as
    tests/test_torch_staged.py holds them: K5's and K7's twins, K1's (6
    fBm channels), K6's (radiance, fused material, on JAX's shadow and
    bake; the fused frame's own scatter planes against the same planes:
    JAX's fused frame keeps them inside its megakernel) and K10's in weight
    mode on 6 channels;
  * in pure Python: K10's channel groups, the general forms' choice and
    shared memory, and the forms past a block's shared memory (K2's, K5's
    and K7's gen_global at and past each edge, K1's chunked form and its
    chunk plan), with the wrappers going on to refuse only meta tensors.

Tolerance tests/torch_tolerance.assert_boundary_close; images also hold a
mean absolute error of at most 1e-5 of the image maximum.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.lights import DirectionalLights as JSuns
from volumetricrenderer_tpu.models.media import Medium as JMedium
from volumetricrenderer_tpu.jitter import JITTER_SEQUENCE
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import dir_shadow as j_dir_shadow
from volumetricrenderer_tpu.ops.pallas import scatter as j_scatter
from volumetricrenderer_tpu.ops.pallas import shadow_blend as j_sb
from volumetricrenderer_tpu.ops.pallas import temporal as j_temporal
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_ds
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import scatter as t_sca
from volumetricrenderer_tpu_torch.ops import shadow_blend as t_sb
from volumetricrenderer_tpu_torch.ops import temporal as t_tmp
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
ASPECT = 128 / 120
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]
N_SUNS = N_NOISE = 6
GRID = (16, 15, 16)
K = 4


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def _forward(pitch_deg, yaw_deg):
    p, y = math.radians(pitch_deg), math.radians(yaw_deg)
    return (math.cos(p) * math.sin(y), -math.sin(p), math.cos(p) * math.cos(y))


def many_suns(scene, n_suns, n_noise):
    """scene (the JAX package's benchmark_scene) with its sun and n_suns - 1
    more, of distinct directions, colours and intensities (every third
    unshadowed, some of partial strength), and its media with n_noise - 1
    additive procedural noise media after them, of distinct seeds (8, 9,
    ...), absorptions, scrolls and octaves (2 to 5: K1 takes a channel of
    more than 4 octaves as one item), each of phase g 0 (additive media
    add their g, whose sum must stay below 1); chip_smoke.py's
    many_suns_scene is the port's form of the same scene."""
    sun = scene.dir_lights
    extra = JSuns.create(
        direction=[_forward(50.0 - 4.0 * i, -30.0 + 37.0 * i)
                   for i in range(1, n_suns)],
        color=[(0.9, 0.8 + 0.02 * i, 0.7) for i in range(1, n_suns)],
        intensity=[1.5 / (1.0 + 0.3 * i) for i in range(1, n_suns)],
        has_shadow=[i % 3 != 2 for i in range(1, n_suns)],
        shadow_strength=[1.0 - 0.1 * (i % 4) for i in range(1, n_suns)])
    suns = dataclasses.replace(sun, **{
        f.name: jnp.concatenate([getattr(sun, f.name), getattr(extra, f.name)])
        for f in dataclasses.fields(sun)})
    media = tuple(scene.media) + tuple(
        JMedium.create(scattering_color=(0.2, 0.25, 0.3),
                       absorption=0.05 + 0.02 * j, phase_g=0.0,
                       noise_mode="procedural",
                       noise_scroll=(2.0 * j, 0.0, 1.0),
                       noise_tiling=(0.02, 0.015, 0.02),
                       noise_octaves=2 + j % 4, noise_period=4,
                       noise_seed=7 + j, blend_type="additive")
        for j in range(1, n_noise))
    return dataclasses.replace(scene, dir_lights=suns, media=media)


def _base():
    return many_suns(j_bench(aspect=ASPECT, num_local_lights=4,
                             noise_mode="procedural"), N_SUNS, N_NOISE)


# --------------------------------------------------------------------------
# the fused frame against JAX render_frame
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def frames():
    """Two fused frames of each renderer, the states before each frame and
    after the last, and the port's scatter planes of each frame (the fused
    frame keeps them inside its volume phase: K1's and K2's twins on the
    frame's tables make them, and its shadow bit for bit)."""
    base = _base()
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=ASPECT)) for p, f in CAMERAS]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL))
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                               device="cpu")
    gbuf = jax.jit(jr.render_scene_inputs)

    def jstep(s, sc, t, c, d):
        img, aux, s = jr.render_frame(s, sc, t, scene_color=c, view_depth=d)
        return img, aux["shadow"], s

    jstep = jax.jit(jstep)
    j_states, t_states = [jr.init_state(N_SUNS)], [tr.init_state(N_SUNS)]
    out = []
    for i, sc in enumerate(scenes):
        c, d = (np.array(a) for a in gbuf(sc))
        jimg, jsh, st = jstep(j_states[-1], sc, jnp.float32(0.1 * i), c, d)
        t_sc = scene_from_numpy(sc, "cpu")
        tables, _, _ = tr.frame_tables(t_states[-1], t_sc, np.float32(0.1 * i))
        sh, scat = t_ff.shadow_scatter(tables, t_states[-1].prev_shadow,
                                       t_ff.bake_radiance(tables))
        timg, taux, ts = tr.render_frame(t_states[-1], t_sc,
                                         np.float32(0.1 * i), t_(c), t_(d))
        assert torch.equal(sh, taux["shadow"])
        j_states.append(st)
        t_states.append(ts)
        out.append((np.asarray(jimg), np.asarray(jsh), timg.numpy(),
                    taux["shadow"], scat))
    return dict(jr=jr, tr=tr, scenes=scenes,
                t_scenes=[scene_from_numpy(sc, "cpu") for sc in scenes],
                j_states=j_states, t_states=t_states, out=out)


def test_fused_frames_match_jax(frames):
    out, st, ts = frames["out"], frames["j_states"][-1], \
        frames["t_states"][-1]
    for i, (jimg, jsh, timg, tsh, _) in enumerate(out):
        assert timg.shape == jimg.shape == (120, 128, 4)
        assert_boundary_close(timg, jimg, f"image {i}")
        assert np.abs(timg - jimg).mean() <= 1e-5 * np.abs(jimg).max()
        assert tsh.shape == jsh.shape == (N_SUNS, 16, 15, 16)
        assert_boundary_close(tsh.numpy(), jsh, f"shadow {i}")
    assert ts.frame_count == 2
    assert_boundary_close(
        t_packed(ts.prev_accumulation).numpy(),
        np.asarray(packed_accumulation(st.prev_accumulation,
                                       frames["jr"].config.grid_dhw)),
        "accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          "shadow history")
    # every shadowed sun casts its own shadow: no two of their channels
    # are one volume; the unshadowed ones are ones
    sh = out[-1][3]
    cast = np.flatnonzero(frames["t_scenes"][0].dir_lights.has_shadow
                          .numpy()).tolist()
    assert 0 < len(cast) < N_SUNS
    assert all(not torch.equal(sh[a], sh[b]) for a in cast for b in cast
               if b < a)
    assert all(bool((sh[li] == 1.0).all()) for li in range(N_SUNS)
               if li not in cast)
    assert out[-1][2][..., :3].std() > 1e-3


def test_tables_and_route(frames):
    """Six suns and six noise channels ride the fused frame's tables: K1's
    radiance bake with the fBm channels, K2's general form."""
    tr, t_scene = frames["tr"], frames["t_scenes"][0]
    assert tr.fuses_frame(t_scene) and tr.bakes_noise(t_scene)
    t, _, _ = tr.frame_tables(tr.init_state(N_SUNS), t_scene, 0.0)
    assert t.n_dir == N_SUNS and t.n_noise == N_NOISE
    assert t.slights.shape == t.dirs.shape == (N_SUNS, 8)
    assert t.local_source == "radiance"
    assert t_sca.needs_general(t.n_dir, t.n_noise)
    geo = t_ff.k1_geometry(t.lights.shape[0], t.n_noise, t.low_dims)
    assert geo.groups == t_ff.K1_WARPS
    # octaves 3 (the fog) and 2 + j % 4 (j = 1 .. 5): one of 5
    assert sorted(st[1] for st in t.media_static if st[0]) == [2, 3, 3, 3, 4,
                                                               5]


# --------------------------------------------------------------------------
# each module against the JAX function it stands for, on the second frame
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def second(frames):
    """The inputs of the second frame on both sides: JAX's froxel params,
    jitter, alpha and previous view as its render_frame makes them from the
    state after frame 1, the port's tables from its own state, and JAX's
    low-rate radiance bake of that frame (bake_radiance_pallas, interpret
    mode)."""
    jr, tr = frames["jr"], frames["tr"]
    cfg = jr.config
    js, st = frames["scenes"][1], frames["j_states"][1]
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near,
                                    cfg.volume_distance,
                                    cfg.depth_distribution, cfg.grid)
    jitter = JITTER_SEQUENCE[int(st.frame_count) % 7]
    alpha = jnp.float32(cfg.temporal_blend_alpha)
    t_state = frames["t_states"][1]
    tables, _, _ = tr.frame_tables(t_state, frames["t_scenes"][1],
                                   np.float32(0.1))
    bake = j_vis.bake_radiance_pallas(
        jp, cam.view_to_world(), cam.position, jitter, js.point_lights,
        js.spot_lights, js.geometry, js.media, jnp.float32(0.1), cfg.grid,
        cfg.raycast_shadow_subsample, interpret=True, bake_noise=True)
    return dict(js=js, jp=jp, jitter=jitter, alpha=alpha,
                prev_w2v=st.prev_world_to_view, prev_sh=st.prev_shadow,
                k=cfg.reproj_window, grid=cfg.grid, tables=tables,
                t_prev_sh=t_state.prev_shadow, bake=np.asarray(bake),
                ss=cfg.raycast_shadow_subsample)


def test_dir_shadow_blend_matches_jax(second):
    """K5's twin on six suns against dir_shadow_blend_fused."""
    f, js = second, second["js"]
    want = j_sb.dir_shadow_blend_fused(
        f["jp"], js.camera.view_to_world(), f["prev_w2v"], f["jitter"],
        f["alpha"], js.dir_lights, js.geometry, f["prev_sh"], f["grid"],
        f["k"], interpret=True)
    got = t_sb.dir_shadow_blend_plain(f["tables"], t_(f["prev_sh"]))
    assert got.shape == (N_SUNS,) + GRID[::-1]
    assert_boundary_close(got.numpy(), want, "dir_shadow_blend")


def test_dir_shadow_matches_jax(second):
    """K7's twin on six suns against dir_shadow_pallas; an unshadowed sun
    is ones, each shadowed one has its own shadow."""
    f, js = second, second["js"]
    want = np.asarray(j_dir_shadow.dir_shadow_pallas(
        f["jp"], js.camera.view_to_world(), f["jitter"], js.dir_lights,
        js.geometry, f["grid"], interpret=True))
    got = t_ds.dir_shadow_plain(f["tables"])
    assert got.shape == want.shape == (N_SUNS,) + GRID[::-1]
    assert_boundary_close(got.numpy(), want, "dir_shadow")
    lit = [bool((got[li] < 1.0).any()) for li in range(N_SUNS)]
    assert lit == [bool(v) for v in np.asarray(js.dir_lights.has_shadow)]


def test_bake_radiance_matches_jax(second):
    """K1's twin with six fBm channels against bake_radiance_pallas."""
    want = second["bake"]
    got = t_ff.bake_radiance_plain(second["tables"])
    assert got.shape == want.shape == (3 + N_NOISE, 4, 4, 4)
    assert_boundary_close(got.numpy(), want, "bake_radiance")
    # the channels differ: each its own medium's seed and octaves
    assert all(not torch.equal(got[3 + a], got[3 + b])
               for a in range(N_NOISE) for b in range(a))


def test_scatter_local_matches_jax(frames, second):
    """K6's twin, radiance x fused material, on JAX's blended shadow of six
    suns and its bake with six fBm channels, against scatter_local_pallas;
    and the fused frame's own scatter planes (K1 then K2 on the port's
    shadow and bake) against the same planes."""
    f, js = second, second["js"]
    jsh = frames["out"][1][1]
    want = np.asarray(j_scatter.scatter_local_pallas(
        f["jp"], js.camera.view_to_world(), js.camera.position, f["jitter"],
        None, None, js.point_lights, js.spot_lights, js.geometry, f["grid"],
        dir_lights=js.dir_lights, shadow_volume=jnp.asarray(jsh),
        interpret=True, return_planes=True, media=js.media,
        time_x=jnp.float32(0.1), vis=jnp.asarray(f["bake"]),
        vis_ss=f["ss"], vis_radiance=True))
    got = t_sca.scatter_local_plain(f["tables"], t_(jsh), t_(f["bake"]))
    frame = frames["out"][1][4]
    assert got.shape == frame.shape == want.shape == (4,) + GRID[::-1]
    for c in range(4):
        assert_boundary_close(got[c].numpy(), want[c], f"scatter c={c}")
        assert_boundary_close(frame[c].numpy(), want[c],
                              f"frame 2 scatter c={c}")


def test_temporal_blend_matches_jax(second):
    """K10's twin in weight mode on six channels against
    fused_temporal_blend (jitter, eps 1e-4): the channels the card blends
    in two launches (channel_groups); the history is the frame's, the
    current volume a seeded one."""
    f, js = second, second["js"]
    prev = np.asarray(f["prev_sh"])
    cur = np.random.default_rng(29).uniform(
        0, 1, prev.shape).astype(np.float32)
    want = j_temporal.fused_temporal_blend(
        f["jp"], js.camera.view_to_world(), f["prev_w2v"], f["jitter"],
        f["alpha"], tuple(jnp.asarray(p) for p in prev),
        tuple(jnp.asarray(p) for p in cur), f["grid"], f["k"], "weight",
        uvw_epsilon=1e-4, interpret=True)
    got = t_tmp.temporal_blend_plain(f["tables"].sbpar, t_(prev), t_(cur),
                                     f["tables"].grid_whd,
                                     f["tables"].h_glob, f["k"], "weight")
    assert got.shape == cur.shape and len(want) == N_SUNS
    for c in range(N_SUNS):
        assert_boundary_close(got[c].numpy(), want[c], f"weight c={c}")
    assert float((got - t_(cur)).abs().max()) > 0.05


# --------------------------------------------------------------------------
# the schedules, the general forms' choice and the refusals that stay
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_ch,mode,want", [
    (1, "weight", [(0, 1)]), (4, "weight", [(0, 4)]),
    (6, "weight", [(0, 4), (4, 2)]), (9, "weight", [(0, 4), (4, 4), (8, 1)]),
    (4, "alpha", [(0, 4)]), (3, "alpha", [(0, 3)])])
def test_k10_channel_groups(n_ch, mode, want):
    """K10 blends the weight mode's channels in launches of up to 4, each
    channel once and in order; the alpha mode in one launch."""
    groups = t_tmp.channel_groups(n_ch, mode)
    assert groups == want
    assert [c for c0, nc in groups for c in range(c0, c0 + nc)] \
        == list(range(n_ch))


@pytest.mark.parametrize("n_ch,mode", [(5, "alpha"), (0, "weight"),
                                       (0, "alpha")])
def test_k10_refuses_channels_it_cannot_blend(n_ch, mode):
    """The alpha mode's weight reads the last channel: more than 4 channels
    cannot be split, and no channel is no blend. Refused before a launch."""
    with pytest.raises(ValueError, match="channels"):
        t_tmp.channel_groups(n_ch, mode)
    vol = torch.empty((n_ch, 16, 15, 16), device="meta")
    bpar = torch.empty((1, 24), device="meta")
    with pytest.raises(ValueError, match="channels"):
        t_tmp.temporal_blend(bpar, vol, vol, (16, 15, 16), 15, 4, mode)


@pytest.mark.parametrize("n_dir,n_noise,general", [
    (1, 1, False), (4, 4, False), (5, 0, True), (0, 5, True), (9, 9, True),
    (4, 5, True)])
def test_general_forms_past_the_fixed_counts(n_dir, n_noise, general):
    """The general forms are taken only past 4 suns or 4 fBm channels, and
    only they add the suns' inverse directions (12 bytes a sun) to K2's, K5's
    and K7's shared memory; K5 and K7 look at the suns alone."""
    assert t_sca.needs_general(n_dir, n_noise) is general
    region = t_tmp.region_shared_bytes(t_ff.K2_TILE, K)
    assert t_ff.k2_shared_bytes(K, n_dir, n_noise) \
        == region + (12 * n_dir if general else 0)
    suns = n_dir > t_sca.MAX_DIR
    assert t_sb.k5_shared_bytes(K, n_dir) == region + (12 * n_dir if suns
                                                       else 0)
    assert t_ds.k7_shared_bytes(n_dir) == (12 * n_dir if suns else 0)
    assert t_sb.k5_shared_bytes(K) == t_ff.k2_shared_bytes(K) == region


@pytest.mark.parametrize("n_lights,n_noise", [(16, 5), (16, 9), (0, 9),
                                              (40, 12)])
def test_k1_general_geometry(n_lights, n_noise):
    """Past 4 fBm channels K1's fBm items move to dynamic shared memory:
    K1_OCT items, a medium and an octave count (int32) a channel after the
    octaves; every channel is one light group's item once."""
    geo = t_ff.k1_geometry(n_lights, n_noise, (60, 34, 32))
    fixed = 4 * geo.samples * (t_ff.K1_TERMS + min(n_lights, t_ff.K1_PASS)
                               + n_noise * t_ff.K1_OCT)
    assert geo.groups == t_ff.K1_WARPS
    assert geo.shared_bytes == fixed + 4 * n_noise * (t_ff.K1_OCT + 2)
    small = t_ff.k1_geometry(n_lights, 4, (60, 34, 32))
    assert small.shared_bytes == 4 * small.samples * (
        t_ff.K1_TERMS + min(n_lights, t_ff.K1_PASS) + 4 * t_ff.K1_OCT)


def _meta_tables(base, n_dir, n_noise=0):
    """base's tables with n_dir suns and n_noise fBm channels, each table
    a meta tensor of its shape: the wrappers' checks run, and a launch is
    refused only for not being on CUDA."""
    rows = lambda n, c: torch.empty((n, c), device="meta")
    t = dataclasses.replace(
        base, slights=rows(n_dir, 8), dirs=rows(n_dir, 8), n_dir=n_dir,
        n_noise=n_noise, spar=torch.empty((1, 25), device="meta"))
    w, h, d = t.grid_whd
    return t, torch.empty((n_dir, d, h, w), device="meta")


@pytest.fixture(scope="module")
def tables(second):
    return second["tables"]


def test_k2_k5_k7_refuse_suns_past_shared_memory(tables):
    """Past ~18,400 suns their inverse directions no longer fit a block's
    shared memory beside K2's and K5's region, past ~19,300 K7's: there
    the mirror (ops/scatter.sun_form) names the gen_global form, the
    inverses in device memory, and no sun count is refused; at one sun
    fewer the general form. Either way each wrapper goes on to refuse only
    the meta tensors (not on CUDA)."""
    room = t_tmp.MAX_SHARED_BYTES - t_tmp.TILE_STATIC_SHARED
    big5 = (room - t_tmp.region_shared_bytes(t_sb.K5_TILE, K)) // 12 + 1
    big7 = room // 12 + 1
    assert (big5, big7) == (18436, 19286)
    for kernel, n_dir, fn, in (
            ("K5", big5, lambda t, p: t_sb.dir_shadow_blend(t, p)),
            ("K7", big7, lambda t, p: t_ds.dir_shadow(t))):
        for n, want in ((n_dir, "gen_global"), (n_dir - 1, "general")):
            assert t_sca.sun_form(kernel, n, 0, K) == want
            t, prev = _meta_tables(tables, n)
            with pytest.raises(ValueError, match="CUDA"):
                fn(t, prev)
    for n, want in ((big5, "gen_global"), (big5 - 1, "general")):
        assert t_sca.sun_form("K2", n, 0, K) == want
        t, prev = _meta_tables(tables, n)
        bake = torch.empty((3 + t.n_noise, *t.low_dims[::-1]), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            t_ff.shadow_scatter(t, prev, bake)


def test_k1_refuses_channels_past_shared_memory(tables):
    """K1's fBm octaves and items grow with the channels: past what a
    block's shared memory holds the mirror (ops/frame_fused.k1_plan) names
    the chunked form, whose staged channels fit, and the wrapper goes on to
    refuse only the meta tensors (not on CUDA), as one channel fewer does
    in the general form."""
    n_l = tables.lights.shape[0]
    fits = lambda n: 4 * 32 * (t_ff.K1_TERMS + min(n_l, t_ff.K1_PASS)
                               + n * t_ff.K1_OCT) + 4 * n * (t_ff.K1_OCT + 2) \
        + t_tmp.TILE_STATIC_SHARED <= t_tmp.MAX_SHARED_BYTES
    big = next(n for n in range(5, 5000) if not fits(n))
    assert big > 100
    for n, form in ((big, "chunked"), (big - 1, "general")):
        assert t_ff.k1_plan(n_l, n)[0] == form
        geo = t_ff.k1_geometry(n_l, n, tables.low_dims)
        assert geo.shared_bytes + t_tmp.TILE_STATIC_SHARED \
            <= t_tmp.MAX_SHARED_BYTES
        t = dataclasses.replace(tables, n_noise=n,
                                spar=torch.empty((1, 25), device="meta"))
        with pytest.raises(ValueError, match="CUDA"):
            t_ff.bake_radiance(t)


def _sun_edge(kernel, k, n_noise=0):
    """The least sun count whose inverse directions do not fit beside
    `kernel`'s region at window k (K7: no region): by the formula of
    csrc/common.cuh sun_form_of."""
    room = t_tmp.MAX_SHARED_BYTES - t_tmp.TILE_STATIC_SHARED
    region = 0 if kernel == "K7" else t_tmp.region_shared_bytes((16, 16), k)
    return (room - region) // 12 + 1


@pytest.mark.parametrize("kernel,k,edge", [
    ("K2", 4, 18436), ("K5", 4, 18436), ("K7", 4, 19286), ("K2", 0, None),
    ("K5", 8, None), ("K2", 25, None), ("K7", 51, 19286), ("K5", 51, None)])
def test_sun_form_at_its_edges(kernel, k, edge):
    """ops/scatter.sun_form names the general form up to the last sun count
    whose inverses fit beside the region, gen_global from the next: 18,436
    suns for K2 and K5 at k = 4, 19,286 for K7 at any k; the fixed form up
    to 4 suns (K2: and 4 fBm channels)."""
    first = _sun_edge(kernel, k)
    if edge is not None:
        assert first == edge
    assert t_sca.sun_form(kernel, first - 1, 0, k) == "general"
    assert t_sca.sun_form(kernel, first, 0, k) == "gen_global"
    assert t_sca.sun_form(kernel, first + 1000, 0, k) == "gen_global"
    assert t_sca.sun_form(kernel, 4, 0, k) == "fixed"
    assert t_sca.sun_form(kernel, 5, 0, k) == "general"
    # K2 takes its general form for the fBm channels alone; K5 and K7 not
    assert t_sca.sun_form(kernel, 1, 5, k) == (
        "general" if kernel == "K2" else "fixed")


@pytest.mark.parametrize("kernel", ["K2", "K5", "K7"])
def test_sun_form_forced(kernel):
    """gen_global can be forced at any count whose region fits; fixed and
    general only where the counts take them, and an unknown name is
    refused: each by name, before any launch. From the window whose region
    does not fit (k = 52) K2's and K5's region_global form reads the suns'
    inverse directions from device memory: gen_global at any count, fixed
    and general refused by name; at k = 51 the counts' form, as with
    region_global forced at k = 4 (gen_global) and region_shared forced
    past the edge (refused). K7 has no region."""
    edge = _sun_edge(kernel, K)
    assert t_sca.sun_form(kernel, 1, 0, K, "gen_global") == "gen_global"
    assert t_sca.sun_form(kernel, 9, 9, K, "general") == "general"
    with pytest.raises(ValueError, match=f"{kernel}'s fixed form"):
        t_sca.sun_form(kernel, 9, 0, K, "fixed")
    with pytest.raises(ValueError, match=f"{kernel}'s general form"):
        t_sca.sun_form(kernel, 1, 0, K, "general")
    with pytest.raises(ValueError, match="shared memory"):
        t_sca.sun_form(kernel, edge, 0, K, "general")
    with pytest.raises(ValueError, match="none of"):
        t_sca.sun_form(kernel, 9, 0, K, "narrow")
    if kernel == "K7":
        assert t_sca.sun_form(kernel, 9, 0, 60) == "general"
    else:
        for k in (52, 60):
            assert t_sca.sun_form(kernel, 9, 0, k) == "gen_global"
            assert t_sca.sun_form(kernel, 1, 0, k, "gen_global") \
                == "gen_global"
            with pytest.raises(ValueError, match=f"{kernel}'s general form "
                                                 "cannot take its "
                                                 "region_global form"):
                t_sca.sun_form(kernel, 9, 0, k, "general")
        assert t_sca.sun_form(kernel, 9, 0, 51) == "general"
        assert t_sca.sun_form(kernel, 1, 0, K, region="region_global") \
            == "gen_global"
        with pytest.raises(ValueError, match=f"{kernel}'s region does not "
                                             "fit"):
            t_sca.sun_form(kernel, 9, 0, 60, region="region_shared")


@pytest.mark.parametrize("n_lights,edge", [(16, 426), (32, 422), (40, 422),
                                           (0, 430), (4, 429)])
def test_k1_plan_at_its_edges(n_lights, edge):
    """K1 takes its general form up to the last channel count whose
    octaves and items fit a block's shared memory and its chunked form
    from the next (426 at 16 lights, 422 at 32 or more), staging the most
    channels that fit; the fixed form up to 4 channels."""
    assert t_ff.k1_plan(n_lights, edge - 1) == ("general", edge - 1)
    form, chunk = t_ff.k1_plan(n_lights, edge)
    assert form == "chunked" and chunk == edge - 1
    assert t_ff.k1_plan(n_lights, 4) == ("fixed", 4)
    assert t_ff.k1_plan(n_lights, 5) == ("general", 5)
    assert t_ff.k1_chunk_of(n_lights, 10 ** 6, 32) == edge - 1


@pytest.mark.parametrize("n_lights", [0, 1, 16, 40])
def test_k1_chunk_plan_covers_each_channel_once(n_lights):
    """At 1-2,000 channels the chunk plan covers every channel once, in
    order; the staged chunk's bytes fit a block's shared memory; a count
    that fits is one chunk; and a forced chunk plan does the same."""
    for n in range(1, 2001):
        plan = t_ff.k1_chunks(n_lights, n)
        assert [c for c0, nc in plan for c in range(c0, c0 + nc)] \
            == list(range(n))
        geo = t_ff.k1_geometry(n_lights, n, (60, 34, 32))
        assert geo.shared_bytes + t_tmp.TILE_STATIC_SHARED \
            <= t_tmp.MAX_SHARED_BYTES
        if t_ff.k1_plan(n_lights, n)[0] != "chunked":
            assert plan == ((0, n),)
        else:
            assert len(plan) == 2 and plan[0][1] >= 421
    plan = t_ff.k1_chunks(n_lights, 9, 4) if t_ff.k1_groups(n_lights, 9) > 1 \
        else None
    assert plan == ((0, 4), (4, 5))


def test_k1_forced_chunked_is_refused_where_it_cannot_run():
    """The chunked form spreads its items over light groups: one light
    group (no light and one fBm channel) cannot take it; nor a chunk past
    the channels or past what fits. Refused by name before any launch."""
    with pytest.raises(ValueError, match="K1's chunked form"):
        t_ff.k1_plan(0, 1, 0)
    with pytest.raises(ValueError, match="K1's chunked form"):
        t_ff.k1_plan(16, 9, 10)
    with pytest.raises(ValueError, match="K1's chunked form"):
        t_ff.k1_plan(16, 1000, 426)
    assert t_ff.k1_plan(16, 9, 0) == ("chunked", 0)
    assert t_ff.k1_geometry(16, 9, (60, 34, 32), 0).shared_bytes \
        == 4 * 32 * (t_ff.K1_TERMS + 16)
