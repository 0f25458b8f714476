"""The slab path of the port (parallel/shard_render.py, render_frame's slab)
against the JAX package's, on the CPU at small size.

1. `_edge_slices`, `_write_halo` and `crop_sharded_state` against JAX's on
   seeded arrays, and `convert.multislab_carry_from_numpy` on a JAX
   multislab carry (zgather padded planes): exact.
2. `y_phase` and the phased y tent (`upsample_mats_y`, and the frame
   tables' two taps of it) against JAX's, ss in {2, 4} and slab starts y0
   in {-6, -5, 21, 39, 75, 84}: exact; at phase 0 the tent of whole grids.
3. The slab `bake_world_planes` (the phase taken from the tables) and
   `low_slice_active` against JAX's at odd y0: rtol 1e-6 / atol 1e-6 (the
   exp/log of the z mapping may differ by an ulp); the active table exact.
   The slab's froxel centres against JAX's, rows off the grid clamped,
   also for a slab that starts at row 0: rtol 1e-6 / atol 1e-6.
4. K4's twin with a row offset against JAX `composite_zgather` in both slab
   forms (halo_rows, and prepadded at row_off), and its per-pixel form with
   a slab's row mapping against `composite_rowmm(fy=..., row_off=0)`:
   rtol 1e-6 / atol 1e-6 (the log() of the froxel z mapping).
5. `make_multislab_render` against JAX's over two frames with the camera
   moving, on the fused radiance frame of tests/test_shard_render.py's
   zgather case (16x24x8 froxels, 128x192 pixels, ss=2, n=2, halo 5: slab
   starts -5 and 7, odd), bands and cropped state
   (torch_tolerance.assert_boundary_close: rtol 1e-5 / atol 1e-6 except for
   at most 5e-3 of the elements, which may also sit beyond 1e-3 relative,
   the any-hit boundary class); and from the same mid-stream carry.
6. The same on the staged raycast frame of tests/test_shard_render.py's CFG
   at n=4 (K5, K6 with per-light rays, K3; the per-pixel slab composite),
   and with the windowed reprojection at n=2 on a 12-row grid, whose
   default halo is the whole slab: the last shard starts at row 0 and its
   halo runs past the grid.
7. Port only: seeded random n and halo against the port's unsharded frame,
   with JAX's fuzz bounds (rtol 1e-4, atol 1e-5).
8. The slab forms of the shadow maps, the XLA scatter and sun shadow,
   texture media and scenes without a sun or media against the port's
   unsharded frame (7.), and map_dir in slabs against JAX's
   make_multislab_render(n=2) over two frames, bands and cropped state
   (assert_boundary_close).
9. The configurations a slab does not take raise NotImplementedError.

The JAX references run once per module (Pallas in interpret mode, as JAX's
own tests run them); both renderers take JAX's G-buffer bands."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import Medium as JMedium
from volumetricrenderer_tpu import RenderConfig as JConfig
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import demo_scene as j_demo
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as j_pipeline
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.ops.pallas.scatter import \
    pack_params as j_pack_params
from volumetricrenderer_tpu.ops.pallas.zg_composite import (
    DLANES, WSTRIDE, composite_zgather, padded_dims)
from volumetricrenderer_tpu.ops.rowmm_composite import composite_rowmm
from volumetricrenderer_tpu.parallel import shard_render as j_sr
from volumetricrenderer_tpu.state import FrameState as JState
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as t_pipeline
from volumetricrenderer_tpu_torch.convert import (multislab_carry_from_numpy,
                                                  scene_from_numpy)
from volumetricrenderer_tpu_torch.models.camera import Camera as TCamera
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import zg_composite as t_zg
from volumetricrenderer_tpu_torch.ops.noise import perlin_texture_3d
from volumetricrenderer_tpu_torch.parallel import shard_render as t_sr

from torch_tolerance import assert_boundary_close

STAGED = dict(volume_width=16, volume_height=32, volume_depth=8,
              image_width=32, image_height=48, shadow_map_size=32,
              shadow_mode="raycast", scatter_impl="pallas",
              dir_shadow_impl="pallas", accumulate_impl="pallas",
              reproj_impl="pallas", temporal_blend_alpha=0.6)
FUSED = dict(STAGED, volume_height=24, image_width=128, image_height=192,
             material_impl="fused", composite_impl="zgather",
             raycast_shadow_subsample=2, scatter_bake="radiance",
             bake_procedural_noise=True)


def _scenes(cfg, fog: bool):
    base = j_demo(aspect=cfg.image_width / cfg.image_height)
    if fog:
        base = dataclasses.replace(base, media=(JMedium.create(
            scattering_color=(1.0, 0.9, 0.8), absorption=0.19, phase_g=0.3,
            noise_mode="procedural", noise_tiling=(0.05, 0.04, 0.05),
            noise_scroll=(3.0, 0.5, 0.0)),))
    cam = base.camera
    return [dataclasses.replace(base, camera=dataclasses.replace(
        cam, position=cam.position + jnp.asarray([0.4 * i, 0.0, 0.12 * i],
                                                 jnp.float32)))
            for i in range(2)]


def _bands(a, n):
    a = np.asarray(a)
    ihb = a.shape[0] // n
    return [a[j * ihb:(j + 1) * ihb] for j in range(n)]


def _slab_run(kw, n, halo, fog):
    """JAX's and the port's multislab frames over two frames, each from
    its init carry, and the port from JAX's carry after frame 1."""
    jr = JRenderer(JConfig(**kw))
    scenes = _scenes(jr.config, fog)
    gbuf = [tuple(np.asarray(a) for a in jax.jit(jr.render_scene_inputs)(s))
            for s in scenes]
    j_fn = j_sr.make_multislab_render(jr, n, halo)
    carry = j_fn.init_carry(1)
    j_imgs, j_carries = [], []
    for i, (s, (sc, vd)) in enumerate(zip(scenes, gbuf)):
        bands, carry = j_fn(carry, s, jnp.float32(0.1 * i),
                            [jnp.asarray(b) for b in _bands(sc, n)],
                            [jnp.asarray(b) for b in _bands(vd, n)])
        j_imgs.append(np.concatenate([np.asarray(b) for b in bands]))
        j_carries.append(jax.tree.map(np.asarray, carry))

    tr = vt.VolumetricRenderer(vt.RenderConfig(**kw), device="cpu")
    t_fn = t_sr.make_multislab_render(tr, n, halo)
    t_scenes = [scene_from_numpy(s, "cpu") for s in scenes]
    t_gbuf = [(_bands(sc, n), _bands(vd, n)) for sc, vd in gbuf]
    t_gbuf = [([torch.tensor(b) for b in sc], [torch.tensor(b) for b in vd])
              for sc, vd in t_gbuf]
    t_carry = t_fn.init_carry(1)
    t_imgs = []
    for i, s in enumerate(t_scenes):
        bands, t_carry = t_fn(t_carry, s, np.float32(0.1 * i), *t_gbuf[i])
        t_imgs.append(torch.cat(bands).numpy())
    # frame 2 again, from JAX's carry after frame 1
    conv = multislab_carry_from_numpy(j_carries[0], j_fn.halo, "cpu")
    resumed = torch.cat(t_fn(conv, t_scenes[1], np.float32(0.1),
                             *t_gbuf[1])[0]).numpy()
    return dict(j_fn=j_fn, t_fn=t_fn, j_imgs=j_imgs, t_imgs=t_imgs,
                j_carries=j_carries, t_carry=t_carry, conv=conv,
                resumed=resumed, kw=kw, tr=tr)


@pytest.fixture(scope="module")
def fused():
    return _slab_run(FUSED, 2, 5, True)


@pytest.fixture(scope="module")
def staged():
    return _slab_run(STAGED, 4, None, False)


def _cropped(run):
    """Both final states cropped to the global layout: (acc [D, H, W, 4],
    shadow [1, D, H, W]) each."""
    cfg = JConfig(**run["kw"])
    dhw = cfg.grid_dhw
    fn = run["j_fn"]
    js = run["j_carries"][-1][0]
    j_state = dataclasses.replace(
        js[0], prev_shadow=np.concatenate([s.prev_shadow for s in js], 2),
        prev_accumulation=tuple(
            np.concatenate([s.prev_accumulation[c] for s in js], 1)
            for c in range(4)))
    j_c = j_sr.crop_sharded_state(j_state, fn.n_shards, fn.halo, fn.h_global,
                                  grid_dhw=dhw)
    ts = run["t_carry"][0]
    t_state = dataclasses.replace(
        ts[0], prev_shadow=torch.cat([s.prev_shadow for s in ts], 2),
        prev_accumulation=torch.cat([s.prev_accumulation for s in ts], 2))
    t_c = t_sr.crop_sharded_state(t_state, fn.n_shards, fn.halo, fn.h_global)
    return ((np.asarray(packed_accumulation(j_c.prev_accumulation, dhw)),
             np.asarray(j_c.prev_shadow)),
            (t_c.prev_accumulation.permute(1, 2, 3, 0).numpy(),
             t_c.prev_shadow.numpy()))


# 1. halo bookkeeping ---------------------------------------------------------

@pytest.mark.parametrize("axis", [1, 2])
def test_edge_slices_and_write_halo_match_jax(axis):
    rng = np.random.default_rng(3)
    p, h_ext = 3, 11
    shape = [2, 5, 7]
    shape.insert(axis, h_ext)
    x = rng.standard_normal(shape).astype(np.float32)
    j_parts = j_sr._edge_slices(jnp.asarray(x), p, axis, h_ext)
    t_parts = t_sr._edge_slices(torch.as_tensor(x), p, axis, h_ext)
    for a, b in zip(t_parts, j_parts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    top = rng.standard_normal(j_parts[0].shape).astype(np.float32)
    bot = rng.standard_normal(j_parts[0].shape).astype(np.float32)
    want = j_sr._write_halo(jnp.asarray(x), jnp.asarray(top),
                            jnp.asarray(bot), p, axis, h_ext)
    got = t_sr._write_halo(torch.as_tensor(x), torch.as_tensor(top),
                           torch.as_tensor(bot), p, axis, h_ext)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_crop_sharded_state_matches_jax():
    rng = np.random.default_rng(4)
    n, halo, d, h_loc, w = 3, 2, 4, 5, 6
    rows = n * (h_loc + 2 * halo)
    sh = rng.standard_normal((1, d, rows, w)).astype(np.float32)
    acc = rng.standard_normal((d, rows, w, 4)).astype(np.float32)
    j_st = JState(prev_shadow=jnp.asarray(sh), prev_material_a=None,
                  prev_scatter=None, prev_accumulation=jnp.asarray(acc),
                  prev_world_to_view=jnp.eye(4), frame_count=jnp.int32(1))
    t_st = vt.FrameState(prev_shadow=torch.as_tensor(sh),
                         prev_accumulation=torch.as_tensor(acc).permute(
                             3, 0, 1, 2),
                         prev_world_to_view=torch.eye(4), frame_count=1)
    j_c = j_sr.crop_sharded_state(j_st, n, halo, n * h_loc)
    t_c = t_sr.crop_sharded_state(t_st, n, halo, n * h_loc)
    np.testing.assert_array_equal(t_c.prev_shadow.numpy(),
                                  np.asarray(j_c.prev_shadow))
    np.testing.assert_array_equal(
        t_c.prev_accumulation.permute(1, 2, 3, 0).numpy(),
        np.asarray(j_c.prev_accumulation))
    # a plain state passes through
    again = t_sr.crop_sharded_state(t_c, n, halo, n * h_loc)
    assert again.prev_shadow is t_c.prev_shadow
    # JAX padded planes: refused without grid_dhw, cropped with it
    hp = padded_dims(h_loc + 2 * halo)[0]
    planes = tuple(rng.standard_normal((DLANES, n * hp, WSTRIDE)).astype(
        np.float32) for _ in range(4))
    pad_j = dataclasses.replace(j_st, prev_accumulation=tuple(
        jnp.asarray(p) for p in planes))
    pad_t = dataclasses.replace(t_st, prev_accumulation=tuple(
        torch.as_tensor(p) for p in planes))
    for crop, st in ((j_sr.crop_sharded_state, pad_j),
                     (t_sr.crop_sharded_state, pad_t)):
        with pytest.raises(ValueError, match="padded"):
            crop(st, n, halo, n * h_loc)
    dhw = (d, n * h_loc, w)
    j_c = j_sr.crop_sharded_state(pad_j, n, halo, n * h_loc, grid_dhw=dhw)
    t_c = t_sr.crop_sharded_state(pad_t, n, halo, n * h_loc, grid_dhw=dhw)
    for a, b in zip(t_c.prev_accumulation, j_c.prev_accumulation):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_carry_conversion_strips_the_pads(fused):
    """A JAX carry (padded planes) converted: every state and edge packet
    equals JAX's own rows, pads stripped."""
    j_states, j_edges = fused["j_carries"][0]
    states, edges = fused["conv"]
    d, h_ext, w = states[0].prev_shadow.shape[1:]
    assert j_states[0].prev_accumulation[0].shape[0] == DLANES
    strip = lambda a: np.asarray(a)[:d, 1:h_ext + 1, 1:w + 1]
    for js, ts in zip(j_states, states):
        np.testing.assert_array_equal(ts.prev_shadow.numpy(),
                                      np.asarray(js.prev_shadow))
        np.testing.assert_array_equal(
            ts.prev_accumulation.numpy(),
            np.stack([strip(p) for p in js.prev_accumulation]))
        assert ts.frame_count == int(js.frame_count) == 1
    for je, te in zip(j_edges, edges):
        for jp, tp in zip(je, te):
            np.testing.assert_array_equal(tp["prev_shadow"].numpy(),
                                          np.asarray(jp.prev_shadow))
            np.testing.assert_array_equal(
                tp["prev_accumulation"].numpy(),
                np.stack([np.asarray(p)[:d, :, 1:w + 1]
                          for p in jp.prev_accumulation]))


# 2. the slab y phase -----------------------------------------------------------

@pytest.mark.parametrize("ss", [2, 4])
@pytest.mark.parametrize("y0", [-6, -5, 21, 39, 75, 84])
def test_phased_tent_matches_jax(ss, y0):
    n = 57
    nl = -(-n // ss)
    want = np.asarray(jax.jit(lambda y: j_vis.upsample_mats_y(n, nl, ss, y))(
        jnp.float32(y0)))
    assert float(t_vis.y_phase(y0, ss)) == float(
        j_vis.y_phase(jnp.float32(y0), ss))
    got = t_vis.upsample_mats_y(n, nl, ss, y0)
    np.testing.assert_array_equal(got, want)
    # the frame tables' two taps carry the same weights
    k0, wt = t_vis.tent_taps_y(n, nl, ss, y0)
    rebuilt = np.zeros_like(got)
    np.add.at(rebuilt, (np.arange(n), k0), wt[0])
    np.add.at(rebuilt, (np.arange(n), np.minimum(k0 + 1, nl - 1)), wt[1])
    np.testing.assert_array_equal(rebuilt, want)
    if float(t_vis.y_phase(y0, ss)) == 0.0:
        np.testing.assert_array_equal(got, t_vis.upsample_mats(n, nl, ss))


# 3. the slab bake's coordinates ------------------------------------------------

@pytest.mark.parametrize("y0", [-5, 7, 21])
def test_slab_bake_planes_and_cull_match_jax(y0):
    ss, grid_loc, grid_glob = 2, (16, 22, 8), (16, 24, 8)
    kw = dict(position=(0.3, 1.5, -6.0), forward=(0.1, -0.1, 1.0),
              aspect=128 / 192, near=0.3)
    jc, tc = JCamera.create(**kw), TCamera.create(**kw, device="cpu")
    jp = dataclasses.replace(jfroxel.make_froxel_params(
        jc.fov_y, jc.aspect, jc.near, 40.0, 0.5, grid_glob),
        y0=jnp.float32(y0))
    tp = dataclasses.replace(tfroxel.make_froxel_params(
        tc.fov_y, tc.aspect, tc.near, 40.0, 0.5, grid_glob), y0=float(y0))
    jit_ = np.asarray([0.25, -0.3, 0.1], np.float32)
    j_par = j_pack_params(jp, jc.view_to_world(), jc.position,
                          jnp.asarray(jit_))
    t_par = torch.cat([torch.tensor(np.asarray(j_par)), torch.tensor(
        [[t_vis.y_phase(y0, ss)]])], dim=1)
    dl = t_vis.low_res_dims(grid_loc, ss)[2]
    ms = np.arange(dl)[:, None, None]
    want = j_vis.bake_world_planes(j_par, jnp.asarray(ms), grid_loc, ss, 24)
    got = t_vis.bake_world_planes(t_par, torch.as_tensor(ms), grid_loc, ss,
                                  24)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    rng = np.random.default_rng(y0 + 10)
    pos = rng.uniform(-4, 4, (6, 3)).astype(np.float32)
    rng_ = rng.uniform(0.5, 3.0, 6).astype(np.float32)
    want = j_vis.low_slice_active(jp, jc.view_to_world(), jnp.asarray(pos),
                                  jnp.asarray(rng_), grid_loc, ss)
    got = t_vis.low_slice_active(tp, tc.view_to_world(),
                                 torch.as_tensor(pos), torch.as_tensor(rng_),
                                 grid_loc, ss)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))



@pytest.mark.parametrize("y0, h_loc", [(-6, 18), (0, 18), (0, 12), (6, 18)],
                         ids=["top", "row0_past_the_grid", "row0", "bottom"])
def test_slab_froxel_positions_match_jax(y0, h_loc):
    """The froxel centres of a slab of h_loc rows at global row y0 of a
    12-row grid, jittered, against JAX's (its y0 a traced float32, as
    make_multislab_render passes it): rows off the grid clamp to its edge
    rows, also where the slab starts at row 0. rtol 1e-6 / atol 1e-6 (the
    exp of the z mapping)."""
    grid_glob = (16, 12, 8)
    kw = dict(position=(0.3, 1.5, -6.0), forward=(0.1, -0.1, 1.0),
              aspect=128 / 192, near=0.3)
    jc, tc = JCamera.create(**kw), TCamera.create(**kw, device="cpu")
    jp = dataclasses.replace(jfroxel.make_froxel_params(
        jc.fov_y, jc.aspect, jc.near, 40.0, 0.5, grid_glob),
        y0=jnp.float32(y0))
    tp = dataclasses.replace(tfroxel.make_froxel_params(
        tc.fov_y, tc.aspect, tc.near, 40.0, 0.5, grid_glob), y0=float(y0))
    jit_ = np.asarray([0.25, -0.3, 0.1], np.float32)
    kw = dict(volume_width=16, volume_height=h_loc, volume_depth=8)
    want = j_pipeline.froxel_world_positions(
        JConfig(**kw), jp, jc.view_to_world(), jnp.asarray(jit_))
    got = t_pipeline.froxel_world_positions(
        vt.RenderConfig(**kw), tp, tc.view_to_world(), torch.tensor(jit_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    rows = np.clip(np.arange(h_loc) + y0, 0, 11)
    edge = got.numpy()[:, rows == 11]
    np.testing.assert_array_equal(edge, np.broadcast_to(
        edge[:, :1], edge.shape))

# 4. the slab composites --------------------------------------------------------

@pytest.fixture(scope="module")
def slab_acc():
    w, h_out, d, halo = 16, 12, 8, 5
    h_ext = h_out + 2 * halo
    ih, iw = 96, 128
    kw = dict(position=(0.0, 1.0, 0.0), forward=(0.0, 0.0, 1.0),
              aspect=iw / (2 * ih), near=0.3)
    jc, tc = JCamera.create(**kw), TCamera.create(**kw, device="cpu")
    grid_glob = (w, 2 * h_out, d)
    jp = jfroxel.make_froxel_params(jc.fov_y, jc.aspect, jc.near, 40.0, 2.0,
                                    grid_glob)
    tp = tfroxel.make_froxel_params(tc.fov_y, tc.aspect, tc.near, 40.0, 2.0,
                                    grid_glob)
    rng = np.random.default_rng(12)
    acc = rng.uniform(0, 1, (4, d, h_ext, w)).astype(np.float32)
    scene = rng.uniform(0, 1, (ih, iw, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 45.0, (ih, iw)).astype(np.float32)
    depth[::7, ::5] = 0.01
    depth[3::11, 2::9] = 500.0
    fz = jfroxel.depth_to_froxel_z(jp, jnp.asarray(depth)) - 0.5
    got = t_zg.composite(torch.as_tensor(acc), torch.as_tensor(scene),
                         torch.as_tensor(depth), tp, (w, h_out, d),
                         row_off=halo).numpy()
    return dict(acc=acc, scene=scene, depth=depth, fz=fz, tp=tp, got=got,
                halo=halo, h_out=h_out, grid_glob=grid_glob)


def test_row_offset_composite_matches_halo_rows_zgather(slab_acc):
    s = slab_acc
    w, _, d = s["grid_glob"]
    halo, h_out = s["halo"], s["h_out"]
    planes = tuple(jnp.asarray(p[:, halo - 1:halo + h_out + 1])
                   for p in s["acc"])
    want = composite_zgather(planes, jnp.asarray(s["scene"]), s["fz"],
                             (w, h_out, d), interpret=True, halo_rows=True)
    np.testing.assert_allclose(s["got"], np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_row_offset_composite_matches_prepadded_zgather(slab_acc):
    """The JAX kernel's halo-extended padded planes at row_off = halo:
    padded row or column r holds row clamp(r - 1); lanes past D repeat the
    last slice."""
    s = slab_acc
    w, _, d = s["grid_glob"]
    halo, h_out = s["halo"], s["h_out"]
    acc = s["acc"]
    h_ext = acc.shape[2]
    hp, ws = padded_dims(h_ext)
    rr = np.clip(np.arange(hp) - 1, 0, h_ext - 1)
    cc = np.clip(np.arange(ws) - 1, 0, w - 1)
    zz = np.minimum(np.arange(DLANES), d - 1)
    planes = tuple(jnp.asarray(p[zz][:, rr][:, :, cc]) for p in acc)
    want = composite_zgather(planes, jnp.asarray(s["scene"]), s["fz"],
                             (w, h_out, d), interpret=True, prepadded=True,
                             row_off=halo)
    np.testing.assert_allclose(s["got"], np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_slab_pixels_composite_matches_rowmm(slab_acc):
    """K4's per-pixel twin on a band of 48 rows at 1.5 pixels per froxel
    row (JAX's rowmm fallback of a slab): the slab's global row mapping
    (H_glob / IH_glob), halo rows down."""
    s = slab_acc
    w, _, d = s["grid_glob"]
    halo, acc = s["halo"], s["acc"]
    ih, h_glob, ih_glob = 36, 24, 72
    scene, depth = s["scene"][:ih], s["depth"][:ih]
    fz = s["fz"][:ih]
    fy = (np.arange(ih) + 0.5) * (h_glob / ih_glob) - 0.5 + halo
    want = composite_rowmm(jnp.asarray(np.moveaxis(acc, 0, -1)),
                           jnp.asarray(scene), fz, (w, h_glob, d), fy=fy,
                           row_off=0, precision="highest")
    got = t_zg.composite_pixels(torch.as_tensor(acc), torch.as_tensor(scene),
                                torch.as_tensor(depth), s["tp"],
                                (w, acc.shape[2], d), (h_glob, ih_glob, halo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# 5. and 6. the multislab frames against JAX's ---------------------------------

@pytest.mark.parametrize("i", [0, 1])
def test_fused_multislab_matches_jax(fused, i):
    assert fused["tr"].fuses_frame()
    a, b = fused["t_imgs"][i], fused["j_imgs"][i]
    assert a.shape == b.shape == (192, 128, 4)
    assert_boundary_close(a, b, f"fused bands, frame {i}")


def test_fused_multislab_state_matches_jax(fused):
    (j_acc, j_sh), (t_acc, t_sh) = _cropped(fused)
    assert t_acc.shape == (8, 24, 16, 4)
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")


def test_fused_multislab_resumes_from_a_jax_carry(fused):
    """Frame 2 from JAX's carry after frame 1, converted: the same bands
    as JAX's frame 2."""
    assert_boundary_close(fused["resumed"], fused["j_imgs"][1],
                          "resumed bands")


@pytest.mark.parametrize("i", [0, 1])
def test_staged_multislab_matches_jax(staged, i):
    assert not staged["tr"].fuses_frame()
    cfg = staged["tr"].config
    assert vt.config.slab_composite_route(dataclasses.replace(
        cfg, volume_height=8 + 12, image_height=12), 6) == "pixels"
    a, b = staged["t_imgs"][i], staged["j_imgs"][i]
    assert a.shape == b.shape == (48, 32, 4)
    assert_boundary_close(a, b, f"staged bands, frame {i}")


def test_staged_multislab_state_matches_jax(staged):
    (j_acc, j_sh), (t_acc, t_sh) = _cropped(staged)
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")
    assert_boundary_close(staged["resumed"], staged["j_imgs"][1],
                          "resumed bands")



# the slab as deep as its halo: n=2 on a 12-row grid, whose default halo is
# h_loc = 6 = reproj_window + 2, so the last shard starts at global row 0
# and its bottom halo rows lie past the grid (windowed reprojection: the
# plain froxel positions and reproject_texel)
WHOLE_HALO = dict(STAGED, volume_height=12, reproj_impl="windowed",
                  dir_shadow_impl="xla", accumulate_impl="xla")


@pytest.fixture(scope="module")
def whole_halo():
    return _slab_run(WHOLE_HALO, 2, None, False)


@pytest.mark.parametrize("i", [0, 1])
def test_whole_halo_multislab_matches_jax(whole_halo, i):
    assert whole_halo["t_fn"].halo == 6
    a, b = whole_halo["t_imgs"][i], whole_halo["j_imgs"][i]
    assert a.shape == b.shape == (48, 32, 4)
    assert_boundary_close(a, b, f"bands, frame {i}")


def test_whole_halo_multislab_state_matches_jax(whole_halo):
    (j_acc, j_sh), (t_acc, t_sh) = _cropped(whole_halo)
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")

# 7. any n and halo: the image of the whole grid --------------------------------

# RenderConfig()'s impl set (the XLA scatter and scan, the "windowed"
# reprojection, the tentmm composite) at the FUZZ grid
XLA = dict(volume_width=16, volume_height=36, volume_depth=8, image_width=32,
           image_height=48, shadow_map_size=32)
# name -> (config, scene): "demo" demo_scene, the others benchmark_scene
# with 4 local lights, its fog sampling an 8^3 noise texture ("texture"),
# without its sun ("sunless") or without media ("no_media")
FUZZ = {
    "staged": (dict(STAGED, volume_height=36), "demo"),
    "windowed": (dict(STAGED, volume_height=36, reproj_impl="windowed",
                      dir_shadow_impl="xla", accumulate_impl="xla"), "demo"),
    "fused_rays": (dict(STAGED, volume_height=36, material_impl="fused"),
                   "demo"),
    # the slab forms of the shadow maps, the XLA scatter and sun shadow,
    # texture media and scenes without a sun or media
    "xla": (dict(XLA, shadow_mode="raycast"), "bench"),
    "map": (dict(XLA, shadow_mode="map"), "bench"),
    "map_dir": (dict(STAGED, volume_height=36, shadow_mode="map_dir",
                     shadow_map_size=64), "bench"),
    "map_kernel": (dict(STAGED, volume_height=36, shadow_mode="map",
                        shadow_map_size=64), "bench"),
    "texture": (dict(STAGED, volume_height=36), "texture"),
    "sunless": (dict(XLA, shadow_mode="raycast"), "sunless"),
    "no_media": (dict(STAGED, volume_height=36), "no_media"),
}


def _fuzz_scene(kind, aspect):
    if kind == "demo":
        return vt.demo_scene(aspect=aspect, device="cpu")
    kw = dict(aspect=aspect, num_local_lights=4, device="cpu")
    if kind == "texture":
        return vt.benchmark_scene(noise_tex=perlin_texture_3d(8), **kw)
    scene = vt.benchmark_scene(noise_mode="procedural", **kw)
    if kind == "sunless":
        return dataclasses.replace(scene, dir_lights=dataclasses.replace(
            scene.dir_lights, **{f.name: getattr(scene.dir_lights, f.name)[:0]
                                 for f in dataclasses.fields(
                                     scene.dir_lights)}))
    if kind == "no_media":
        return dataclasses.replace(scene, media=())
    return scene


@pytest.mark.parametrize("name", list(FUZZ))
def test_multislab_matches_the_whole_grid(name):
    """Port only: a seeded random shard count n (dividing H=36 and IH=48)
    and halo in [3, min(reproj_window + 2, H/n)], random camera motion;
    the bands over two frames against the port's unsharded frames (JAX's
    bounds of test_multislab_fuzz_random_n_halo_motion_matches_unsharded,
    and of sharded against single device, tests/test_shard_render.py:69,
    :153, :230: rtol 1e-4, atol 1e-5). The shadow-map cases bake their
    maps in every shard's frame, as the JAX package's step does; map_dir
    and map_kernel sample the sun on K12's twin (a 128-texel atlas), and
    map_kernel bakes the local lights from their maps on the slab's low
    grid."""
    kw, kind = FUZZ[name]
    cfg = vt.RenderConfig(**kw)
    rng = np.random.default_rng(list(FUZZ).index(name) + 7)
    n = int(rng.choice([2, 3, 4]))
    h_loc = cfg.volume_height // n
    halo = int(rng.integers(3, min(cfg.reproj_window + 2, h_loc) + 1))
    r = vt.VolumetricRenderer(cfg, device="cpu")
    base = _fuzz_scene(kind, cfg.image_width / cfg.image_height)
    assert r.fuses_frame(base) == (name == "fused_rays")
    moves = rng.uniform(-0.3, 0.3, (2, 2)).astype(np.float32)
    scenes = [dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, position=base.camera.position + torch.tensor(
            [float(moves[i, 0]) * i, float(moves[i, 1]) * i, 0.3 * i])))
        for i in range(2)]
    gbuf = [r.render_scene_inputs(s) for s in scenes]
    fn = t_sr.make_multislab_render(r, n, halo)
    st, carry = r.init_state(1), fn.init_carry(1)
    for i, (s, (sc, vd)) in enumerate(zip(scenes, gbuf)):
        want, _, st = r.render_frame(st, s, 0.1 * i, sc, vd)
        bands, carry = fn(carry, s, 0.1 * i, list(sc.chunk(n)),
                          list(vd.chunk(n)))
        torch.testing.assert_close(torch.cat(bands), want, rtol=1e-4,
                                   atol=1e-5, msg=f"n={n} halo={halo} {i}")


def test_fixed_inputs_match_the_explicit_bands():
    cfg = vt.RenderConfig(**STAGED)
    r = vt.VolumetricRenderer(cfg, device="cpu")
    scene = vt.demo_scene(aspect=cfg.image_width / cfg.image_height,
                          device="cpu")
    sc, vd = r.render_scene_inputs(scene)
    bands = (list(sc.chunk(4)), list(vd.chunk(4)))
    fn = t_sr.make_multislab_render(r, 4)
    fnf = t_sr.make_multislab_render(r, 4, fixed_inputs=bands)
    a, b = fn.init_carry(1), fnf.init_carry(1)
    for i in range(2):
        img_a, a = fn(a, scene, 0.1 * i, *bands)
        img_b, b = fnf(b, scene, 0.1 * i)
    torch.testing.assert_close(torch.cat(img_a), torch.cat(img_b), rtol=0,
                               atol=0)
    assert (fn.halo, fn.n_shards, fn.h_global) == (6, 4, 32)


# 8. the slab forms against JAX's: map_dir ---------------------------------------

# RenderConfig(shadow_mode="map_dir") at tests/test_parallel.py's size: the
# gather sun sampler on the camera-aligned cascades, the XLA scatter with
# per-light rays, the "windowed" reprojection, the XLA scan
MAP_DIR_SLABS = dict(volume_width=16, volume_height=16, volume_depth=8,
                     image_width=48, image_height=32, shadow_map_size=32,
                     shadow_mode="map_dir")


@pytest.fixture(scope="module")
def map_dir_slabs():
    """JAX's make_multislab_render(n=2) and the port's on MAP_DIR_SLABS over
    two frames of a moving camera on benchmark_scene (4 local lights), both
    on the port's G-buffer bands; every shard bakes its maps in its frame,
    in both packages."""
    n = 2
    jr = JRenderer(JConfig(**MAP_DIR_SLABS))
    tr = vt.VolumetricRenderer(vt.RenderConfig(**MAP_DIR_SLABS), device="cpu")
    base = j_bench(aspect=48 / 32, num_local_lights=4,
                   noise_mode="procedural")
    cam = base.camera
    j_scenes = [dataclasses.replace(base, camera=dataclasses.replace(
        cam, position=cam.position + jnp.asarray([0.3, 0.2, 0.25],
                                                 jnp.float32) * i))
        for i in range(2)]
    t_scenes = [scene_from_numpy(s, "cpu") for s in j_scenes]
    j_fn = j_sr.make_multislab_render(jr, n)
    t_fn = t_sr.make_multislab_render(tr, n)
    j_carry, t_carry = j_fn.init_carry(1), t_fn.init_carry(1)
    j_imgs, t_imgs, j_carries = [], [], []
    for i, (js, ts) in enumerate(zip(j_scenes, t_scenes)):
        sc, vd = (list(a.chunk(n)) for a in tr.render_scene_inputs(ts))
        bands, j_carry = j_fn(j_carry, js, jnp.float32(0.1 * i),
                              [jnp.asarray(b.numpy()) for b in sc],
                              [jnp.asarray(b.numpy()) for b in vd])
        j_imgs.append(np.concatenate([np.asarray(b) for b in bands]))
        j_carries.append(jax.tree.map(np.asarray, j_carry))
        bands, t_carry = t_fn(t_carry, ts, np.float32(0.1 * i), sc, vd)
        t_imgs.append(torch.cat(bands).numpy())
    run = dict(kw=MAP_DIR_SLABS, j_fn=j_fn, j_carries=j_carries,
               t_carry=t_carry)
    return j_imgs, t_imgs, _cropped(run)


@pytest.mark.parametrize("part", ["frame0", "frame1", "accumulation",
                                  "shadow"])
def test_map_dir_multislab_matches_jax(map_dir_slabs, part):
    """The slice as a whole against the JAX package: both packages'
    make_multislab_render(n=2) on the shadow-map frame, each band of the two
    frames and the final cropped histories, at the class of the port's
    unsharded map_dir hold (tests/test_torch_shadow_maps.py:
    torch_tolerance.assert_boundary_close)."""
    j_imgs, t_imgs, ((j_acc, j_sh), (t_acc, t_sh)) = map_dir_slabs
    if part.startswith("frame"):
        i = int(part[-1])
        assert t_imgs[i].shape == j_imgs[i].shape == (32, 48, 4)
        assert float(np.abs(j_imgs[i][..., :3]).std()) > 1e-4
        assert_boundary_close(t_imgs[i], j_imgs[i], f"map_dir bands {i}")
    elif part == "accumulation":
        assert t_acc.shape == (8, 16, 16, 4)
        assert_boundary_close(t_acc, j_acc, "accumulation history")
    else:
        assert_boundary_close(t_sh, j_sh, "shadow history")


# 9. what a slab does not take ---------------------------------------------------

def _slab_call(kw, post=False):
    cfg = vt.RenderConfig(**dict(STAGED, **kw))
    r = vt.VolumetricRenderer(cfg, device="cpu")
    scene = vt.demo_scene(aspect=cfg.image_width / cfg.image_height,
                          device="cpu")
    sc, vd = r.render_scene_inputs(scene)
    fn = t_sr.make_multislab_render(r, 2)
    if post:
        r_loc = vt.VolumetricRenderer(dataclasses.replace(
            cfg, volume_height=16 + 2 * fn.halo, image_height=24),
            device="cpu")
        slab = t_sr.Slab(-6.0, fn.halo, cfg.grid, cfg.image_height)
        from volumetricrenderer_tpu_torch.post import PostConfig
        return r_loc.render_frame_post(r_loc.init_state(1), scene,
                                       PostConfig(), 0.0, sc[:24], vd[:24],
                                       slab=slab)
    return fn(fn.init_carry(1), scene, 0.0, list(sc.chunk(2)),
              list(vd.chunk(2)))


@pytest.mark.parametrize("kw, post, match", [
    (dict(shadow_mode="map_dir", reproj_impl="gather"), False,
     "reproj_impl='gather' in a slab"),
    (dict(shadow_mode="map"), True, "post stack in a slab"),
    (dict(reproj_impl="gather"), False, "reproj_impl='gather' in a slab"),
    ({}, True, "post stack in a slab"),
], ids=["map_dir", "map", "gather", "post"])
def test_unported_slabs_raise(kw, post, match):
    """What a slab still refuses, where the JAX package refuses it too: the
    gather reprojection (its row support is unbounded) and the post stack
    (render_frame_post takes no slab), also in the shadow-map modes, which
    render in slabs since their slab forms were ported (the map_dir and
    map cases held those refusals; the modes are held in
    test_multislab_matches_the_whole_grid and against JAX in
    test_map_dir_multislab_matches_jax)."""
    with pytest.raises(NotImplementedError, match=match):
        _slab_call(kw, post)


def test_a_slab_needs_its_gbuffer_band():
    cfg = vt.RenderConfig(**dict(STAGED, volume_height=28, image_height=24))
    r = vt.VolumetricRenderer(cfg, device="cpu")
    scene = vt.demo_scene(aspect=32 / 48, device="cpu")
    with pytest.raises(ValueError, match="G-buffer band"):
        r.render_frame(r.init_state(1), scene, 0.0,
                       slab=t_sr.Slab(-6.0, 6, (16, 32, 8), 48))
