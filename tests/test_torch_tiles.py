"""The host side of K2's, K5's, K6's, K7's, K10's and K11's slice tiles
(csrc/shadow_scatter.cu, csrc/shadow_blend.cu, csrc/scatter.cu,
csrc/dir_shadow.cu, csrc/temporal_blend.cu, csrc/windowed_warp.cu,
csrc/common.cuh) and K12's (csrc/pcf_shadow.cu), of K8's column tiles
(csrc/integrate.cu), of K1's and K9's light groups
(csrc/bake_radiance.cu, csrc/bake_visibility.cu) and of K13's pixel tiles
(csrc/ssr_march.cu): the launch grids and shared memory as the wrappers
mirror them, the reach of the reprojection region and of K11's staged
targets, K1's and K9's share of each sample's lights among their warps,
K13's packed tap table, its first-hit march and its forms by the table's
size (k13_form: the GEN instance past 32 taps a bin, the table opted in
past 48 KB and in device memory past 227 KB), the narrow index forms'
refusal (forced) of tables and volumes past 32-bit indices, where the size
rules take the wide forms, and the wrappers' refusal of a region or table
past shared memory. Plain Python and torch on the CPU (meta
tensors for the large grids); no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_ds
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import integrate as t_int
from volumetricrenderer_tpu_torch.ops import pcf_shadow as t_pcf
from volumetricrenderer_tpu_torch.ops import scatter as t_sca
from volumetricrenderer_tpu_torch.ops import shadow_blend as t_sb
from volumetricrenderer_tpu_torch.ops import ssr as t_ssr
from volumetricrenderer_tpu_torch.ops import temporal as t_tmp
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import warp as t_wp
from volumetricrenderer_tpu_torch import post as t_post


K2 = t_ff.K2_TILE
RAD, RAY, BAKED = t_sca.LOCAL_RADIANCE, t_sca.LOCAL_RAY, t_sca.LOCAL_BAKED


@pytest.mark.parametrize("grid,tile,want", [
    ((240, 135, 128), K2, (15, 9, 128)),     # FULL_CONFIG, UHD_CONFIG
    ((160, 88, 64), K2, (10, 6, 64)),        # the demo grid
    ((240, 57, 128), K2, (15, 4, 128)),      # a slab3 shard, halo included
    ((240, 39, 128), K2, (15, 3, 128)),      # a slab5 shard
    ((16, 15, 16), K2, (1, 1, 16)),
    ((240, 135, 128), (16, 8), (15, 17, 128)),
    ((240, 135, 128), (128, 0), (254, 1, 128)),   # 32400 froxels a slice
    ((240, 135, 128), (256, 0), (127, 1, 128)),
    ((240, 57, 128), (256, 0), (54, 1, 128)),
    ((16, 15, 16), (256, 0), (1, 1, 16))])
def test_tile_grid(grid, tile, want):
    """One block per tile of each slice, or per run of consecutive froxels
    of its rows; the ragged last ones in a partial block."""
    assert t_sca.tile_grid(grid, tile) == want


def test_block_shapes():
    """K2's 16x16 tile and K6's blocks, a whole number of warps each."""
    assert K2 == (16, 16)
    assert t_sca.K6_TILES == {RAD: (128, 0), RAY: (256, 0), BAKED: (16, 8)}
    for tx, ty in (K2, *t_sca.K6_TILES.values()):
        assert (tx * max(ty, 1)) % 32 == 0


@pytest.mark.parametrize("tile", [(128, 0), (256, 0), (16, 8)])
@pytest.mark.parametrize("grid", [(240, 135, 128), (160, 88, 64),
                                  (240, 39, 128), (16, 15, 16)])
def test_blocks_cover_each_froxel_once(grid, tile):
    """The blocks of a launch, less their masked threads, hold each froxel
    of a slice exactly once."""
    w, h, _ = grid
    gx, gy, _ = t_sca.tile_grid(grid, tile)
    tx, ty = tile
    seen = np.zeros((h, w), np.int64)
    for bx in range(gx):
        for by in range(gy):
            if ty == 0:
                f = bx * tx + np.arange(tx)
                f = f[f < w * h]
                np.add.at(seen, (f // w, f % w), 1)
            else:
                ys = by * ty + np.arange(ty)
                xs = bx * tx + np.arange(tx)
                ys, xs = ys[ys < h], xs[xs < w]
                seen[np.ix_(ys, xs)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("k,want", [(0, 4760), (1, 5928), (4, 10200),
                                    (8, 17688)])
def test_k2_shared_bytes(k, want):
    """(16 + 2k + 1)^2 cells of (ox, oy, oz, success), then the region's
    column and row terms, in float32."""
    assert t_ff.k2_shared_bytes(k) == want


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("grid", [(240, 135, 128), (40, 11, 4)])
def test_region_covers_the_warps_taps(k, grid):
    """Every tap of the 8-tap warp of a tile's froxel, at offsets clipped to
    +-k and clamped to the grid as warp8_by clamps them, lies inside the
    tile's region: column cx at cx - (xt - k) in [0, 16 + 2k + 1), row cy
    at cy - (yt - k) in [0, 16 + 2k + 1), for every tile, ragged ones
    too."""
    w, h, _ = grid
    nx, ny = K2[0] + 2 * k + 1, K2[1] + 2 * k + 1
    assert 4 * (4 * nx * ny + nx + ny) == t_ff.k2_shared_bytes(k)
    gx, gy, _ = t_sca.tile_grid(grid, K2)
    x = np.arange(gx * K2[0])
    y = np.arange(gy * K2[1])
    xt = x // K2[0] * K2[0]
    yt = y // K2[1] * K2[1]
    # floor of an offset clipped to [-k, k], then the pair of taps
    for f in range(-k, k + 1):
        for a in (0, 1):
            cx = np.clip(x + f + a, 0, w - 1)
            cy = np.clip(y + f + a, 0, h - 1)
            assert ((cx - (xt - k) >= 0) & (cx - (xt - k) < nx)).all()
            assert ((cy - (yt - k) >= 0) & (cy - (yt - k) < ny)).all()


@pytest.fixture(scope="module")
def tables():
    """A fused frame's tables (the radiance bake at ss = 4, one sun, four
    local lights) at 16x15x16."""
    cfg = dataclasses.replace(vt.FULL_CONFIG, volume_width=16,
                              volume_height=15, volume_depth=16,
                              image_width=128, image_height=120)
    r = vt.VolumetricRenderer(cfg, device="cpu")
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    return r.frame_tables(r.init_state(1), scene, 0.0)[0]


def _at(t, grid, **kw):
    """t at another grid, with meta tensors of the K2 and K6 inputs."""
    t = dataclasses.replace(t, grid_whd=grid, **kw)
    w, h, d = grid
    wl, hl, dl = t.low_dims
    shadow = torch.empty((t.n_dir, d, h, w), device="meta")
    bake = torch.empty((3 + t.n_noise, dl, hl, wl), device="meta")
    return t, shadow, bake


# 2048 x 2048 x 128 x 4 floats of planes = 2^31: one past the last index
@pytest.mark.parametrize("grid", [(2048, 2048, 128), (4096, 4096, 64),
                                  (8, 8, 65536)])
def test_wrappers_refuse_indices_past_32_bits(tables, grid):
    """The narrow forms of K5, K6 and K7 (ops/scatter.check_tile_indices)
    refuse, by name, a grid whose [4, D, H, W] planes pass 2^31 - 1 floats
    or whose launch grid would hold more than 65535 slices. K2 and K6 take
    them in their wide forms and go on to refuse only the meta tensors (not
    on CUDA); K6 forced narrow refuses before any launch."""
    t, shadow, bake = _at(tables, grid)
    with pytest.raises(ValueError, match="narrow form.*(2\\^31|65535)"):
        t_sca.check_tile_indices(t, form="narrow")
    assert t_sca.check_tile_indices(t) == "wide"
    assert t_ff.k2_form(t, RAD) == t_sca.k6_form(t, RAD) == "wide"
    with pytest.raises(ValueError, match="CUDA"):
        t_ff.shadow_scatter(t, shadow, bake)
    with pytest.raises(ValueError, match="CUDA"):
        t_sca.scatter_local(t, shadow, bake)
    with pytest.raises(ValueError, match="K6's narrow form.*(2\\^31|65535)"):
        t_sca.scatter_local(t, shadow, bake, form="narrow")


def test_largest_grid_under_32_bits_is_taken(tables):
    """One row fewer than the refused grid: the tables pass the check, and
    the wrappers go on to refuse only the meta tensors (not on CUDA)."""
    t, shadow, bake = _at(tables, (2048, 2047, 128))
    t_sca.check_tile_indices(t)
    with pytest.raises(ValueError, match="CUDA"):
        t_ff.shadow_scatter(t, shadow, bake)
    with pytest.raises(ValueError, match="CUDA"):
        t_sca.scatter_local(t, shadow, bake)


def test_k2_refuses_a_region_past_shared_memory(tables):
    """From the first reprojection window whose region does not fit a
    block's 227 KB of shared memory (k = 52) the mirror names K2's
    region_global form (the offsets in device memory) and one less the
    region_shared form; either way the wrapper goes on to refuse only the
    meta tensors (not on CUDA). Forcing region_shared past the edge, or the
    narrow index form with region_global, is refused by name; K6 has no
    region."""
    big = next(k for k in range(1, 100)
               if t_ff.k2_shared_bytes(k) + t_tmp.TILE_STATIC_SHARED
               > t_tmp.MAX_SHARED_BYTES)
    assert big == 52
    for k, want in ((big - 1, "region_shared"), (big, "region_global")):
        assert t_tmp.region_form("K2", k) == want
        t, shadow, bake = _at(tables, (16, 15, 16), k=k)
        with pytest.raises(ValueError, match="CUDA"):
            t_ff.shadow_scatter(t, shadow, bake)
    with pytest.raises(ValueError, match="K2's region does not fit a "
                                         "block's shared memory"):
        t_ff.shadow_scatter(t, shadow, bake, form="region_shared")
    with pytest.raises(ValueError, match="K2's region_global form has no "
                                         "narrow"):
        t_ff.shadow_scatter(t, shadow, bake,
                            form=("narrow", "region_global"))


# ---- K5 shadow_blend: K2's tile without the scatter --------------------

@pytest.mark.parametrize("k,want", [(0, 4760), (1, 5928), (4, 10200),
                                    (8, 17688), (25, 72360)])
def test_k5_shared_bytes(k, want):
    """K5's region is K2's: (16 + 2k + 1)^2 cells of (ox, oy, oz, success),
    then the region's column and row terms, in float32; under a block's
    227 KB up to k = 25 and past it (refused) at k = 60."""
    assert t_sb.K5_TILE == K2 == (16, 16)
    assert t_sb.k5_shared_bytes(k) == want == t_ff.k2_shared_bytes(k)
    assert want + t_tmp.TILE_STATIC_SHARED <= t_tmp.MAX_SHARED_BYTES
    assert (t_sb.k5_shared_bytes(60) + t_tmp.TILE_STATIC_SHARED
            > t_tmp.MAX_SHARED_BYTES)


@pytest.mark.parametrize("grid,want", [
    ((240, 135, 128), (15, 9, 128)),     # FULL_CONFIG
    ((160, 88, 64), (10, 6, 64)),        # the demo grid
    ((240, 57, 128), (15, 4, 128))])     # a slab3_staged shard
def test_k5_tile_grid(grid, want):
    """One block per 16x16 tile of each slice, as K2."""
    assert t_sca.tile_grid(grid, t_sb.K5_TILE) == want


def _history(t, grid, **kw):
    """t at another grid, with a meta tensor of K5's history."""
    t = dataclasses.replace(t, grid_whd=grid, **kw)
    w, h, d = grid
    return t, torch.empty((t.n_dir, d, h, w), device="meta")


@pytest.mark.parametrize("grid", [(2048, 2048, 128), (8, 8, 65536)])
def test_k5_refuses_indices_past_32_bits(tables, grid):
    """K5's narrow form raises ValueError, before any launch, where K2's
    does: [4, D, H, W] planes past 2^31 - 1 floats or more than 65535
    slices; its wide form takes them and goes on to refuse only the meta
    tensor (not on CUDA)."""
    t, prev = _history(tables, grid)
    with pytest.raises(ValueError, match="K5's narrow form.*(2\\^31|65535)"):
        t_sb.dir_shadow_blend(t, prev, form="narrow")
    assert t_sb.k5_form(t) == "wide"
    with pytest.raises(ValueError, match="CUDA"):
        t_sb.dir_shadow_blend(t, prev)


def test_k5_refuses_a_region_past_shared_memory(tables):
    """From the first reprojection window whose region does not fit a
    block's shared memory (k = 52, K2's) the mirror names K5's
    region_global form and one less region_shared; the wrapper goes on to
    refuse only the meta tensor (not on CUDA) at both, as at the largest
    grid under 32 bits and at region_global forced at k = 4. Forcing
    region_shared past the edge, or a sun form other than gen_global with
    region_global, is refused by name."""
    big = next(k for k in range(1, 100)
               if t_sb.k5_shared_bytes(k) + t_tmp.TILE_STATIC_SHARED
               > t_tmp.MAX_SHARED_BYTES)
    assert big == 52
    for grid, k, form in (((16, 15, 16), big, None),
                          ((16, 15, 16), big - 1, None),
                          ((2048, 2047, 128), 4, None),
                          ((16, 15, 16), 4, "region_global")):
        t, prev = _history(tables, grid, k=k)
        assert t_tmp.region_form("K5", k, form) == (
            "region_shared" if k < big and form is None
            else "region_global")
        with pytest.raises(ValueError, match="CUDA"):
            t_sb.dir_shadow_blend(t, prev, form=form)
    t, prev = _history(tables, (16, 15, 16), k=big)
    with pytest.raises(ValueError, match="K5's region does not fit"):
        t_sb.dir_shadow_blend(t, prev, form="region_shared")
    with pytest.raises(ValueError, match="K5's fixed form cannot take its "
                                         "region_global form"):
        t_sb.dir_shadow_blend(t, prev, form="fixed")


# ---- K10 temporal_blend and K11 windowed_warp: tiles of one slice --------

K10, K11 = t_tmp.K10_TILE, t_wp.K11_TILE


@pytest.mark.parametrize("k,k10,k11", [(0, 4760, 2244), (1, 5928, 2660),
                                       (4, 10200, 4100), (8, 17688, 6468)])
def test_k10_k11_shared_bytes(k, k10, k11):
    """K10's region is K5's: (16 + 2k + 1)^2 cells of (ox, oy, oz, success),
    then the region's column and row terms. K11 stages the y offsets of the
    tile's 16 rows and the z offsets of the region's 16 + 2k + 1 rows, each
    over the region's 16 + 2k + 1 columns. Both in float32."""
    assert K10 == K11 == t_sb.K5_TILE == (16, 16)
    assert t_tmp.k10_shared_bytes(k) == k10 == t_sb.k5_shared_bytes(k)
    assert t_wp.k11_shared_bytes(k) == k11


@pytest.mark.parametrize("grid,want", [
    ((240, 135, 128), (15, 9, 128)),     # FULL_CONFIG
    ((160, 88, 64), (10, 6, 64)),        # the demo grid
    ((240, 57, 128), (15, 4, 128)),      # a slab3 shard
    ((16, 15, 16), (1, 1, 16))])
@pytest.mark.parametrize("tile", [K10, K11])
def test_k10_k11_tile_grid(grid, want, tile):
    """One block per 16x16 tile of each slice, the ragged ones masked."""
    assert t_sca.tile_grid(grid, tile) == want


@pytest.mark.parametrize("grid", [(240, 135, 128), (160, 88, 64),
                                  (37, 21, 2)])
@pytest.mark.parametrize("tile", [K10, K11])
def test_k10_k11_blocks_cover_each_froxel_once(grid, tile):
    """The blocks of a K10 or K11 launch, less their masked threads, hold
    each froxel of a slice exactly once."""
    w, h, _ = grid
    gx, gy, _ = t_sca.tile_grid(grid, tile)
    seen = np.zeros((h, w), np.int64)
    for bx in range(gx):
        for by in range(gy):
            ys = by * tile[1] + np.arange(tile[1])
            xs = bx * tile[0] + np.arange(tile[0])
            seen[np.ix_(ys[ys < h], xs[xs < w])] += 1
    assert (seen == 1).all()


def _k11_staged(grid, k):
    """csrc/windowed_warp.cu's staging, block by block: the grid column that
    region column c of block column bx loads, [gx, nx]; the grid row of the
    y offsets at the tile's row r of block row by (clamped to the grid),
    [gy, 16]; and of the z offsets at region row r, [gy, ny]."""
    w, h, _ = grid
    tx, ty = K11
    nx, ny = tx + 2 * k + 1, ty + 2 * k + 1
    assert 4 * (ty + ny) * nx == t_wp.k11_shared_bytes(k)
    gx, gy, _ = t_sca.tile_grid(grid, K11)
    cols = np.clip(np.arange(gx)[:, None] * tx - k + np.arange(nx), 0, w - 1)
    rows_y = np.minimum(np.arange(gy)[:, None] * ty + np.arange(ty), h - 1)
    rows_z = np.clip(np.arange(gy)[:, None] * ty - k + np.arange(ny), 0,
                     h - 1)
    return cols, rows_y, rows_z


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("grid", [(40, 11, 3), (37, 21, 2), (16, 15, 2)])
def test_k11_staged_region_covers_every_target_tap(grid, k):
    """Every ty and tz value the thread-per-froxel form reads -- ty at (y,
    cx) for the x pass's 2 columns, tz at (cy, cx) for the y passes' 4
    pairs -- lies in the block's staged region, at the cell that loaded that
    very (row, column), on random targets that run past the grid on every
    side (clamped to the volume, clipped to +-k, taps edge-clamped as
    warp8_by clamps them). The region holds the offsets of the tile's rows
    and k rows and columns before it, k + 1 after."""
    w, h, d = grid
    rng = np.random.default_rng(w * 100 + k)
    # targets: texel coordinates up to k + 3 cells past each edge
    txv = rng.uniform(-k - 3, w + k + 2, (d, h, w)).astype(np.float32)
    tyv = rng.uniform(-k - 3, h + k + 2, (d, h, w)).astype(np.float32)
    cols, rows_y, rows_z = _k11_staged(grid, k)
    nx, ny = cols.shape[1], rows_z.shape[1]
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                          indexing="ij")
    bx, by = x // K11[0], y // K11[1]
    xt, yt = bx * K11[0], by * K11[1]
    off = lambda v, n, base: np.clip(np.clip(v, 0, n - 1) - base, -k, k)
    # the y offset at (y, cx) is at tile row y - yt
    assert (rows_y[by, y - yt] == y).all()
    ox = off(txv[z, y, x], w, x)
    reads = 0
    for a in (0, 1):
        cx = np.clip(x + np.floor(ox).astype(int) + a, 0, w - 1)
        c = cx - (xt - k)
        assert ((c >= 0) & (c < nx)).all()
        assert (cols[bx, c] == cx).all()
        oy = off(tyv[z, y, cx], h, y)
        for b in (0, 1):
            cy = np.clip(y + np.floor(oy).astype(int) + b, 0, h - 1)
            r = cy - (yt - k)
            assert ((r >= 0) & (r < ny)).all()
            # the z offset at (cy, cx) is at region row r, column c
            assert (rows_z[by, r] == cy).all()
            reads += cy.size
    assert reads == 4 * d * h * w


@pytest.mark.parametrize("shape", [(4, 128, 2048, 2048), (1, 65536, 8, 8),
                                   (2, 256, 2048, 2048)])
def test_k10_k11_refuse_indices_past_32_bits(shape):
    """K10's and K11's narrow forms, forced, raise ValueError, naming the
    kernel, before any launch for a volume of more than 2^31 - 1 floats or
    more than 65535 slices; their size rules take the wide forms there
    (ops/temporal.k10_form, ops/warp.k11_form), and the wrappers go on to
    refuse only the meta tensors (not on CUDA). One froxel row fewer takes
    the narrow forms."""
    c, d, h, w = shape
    vol = torch.empty(shape, device="meta")
    tgt = torch.empty(shape[1:], device="meta")
    bpar = torch.empty((1, 24), device="meta")
    with pytest.raises(ValueError, match="K11's narrow form.*(2\\^31|65535)"):
        t_wp.windowed_warp(vol, tgt, tgt, tgt, 4, form="narrow")
    with pytest.raises(ValueError, match="K10's narrow form.*(2\\^31|65535)"):
        t_tmp.temporal_blend(bpar, vol, vol, (w, h, d), h, 4, "alpha",
                             form="narrow")
    assert t_wp.k11_form(shape) == t_tmp.k10_form(shape) == "wide"
    with pytest.raises(ValueError, match="CUDA"):
        t_wp.windowed_warp(vol, tgt, tgt, tgt, 4)
    with pytest.raises(ValueError, match="CUDA"):
        t_tmp.temporal_blend(bpar, vol, vol, (w, h, d), h, 4, "alpha")
    if d <= t_sca.MAX_GRID_Z:
        fewer = (c, d, h - 1, w)
        assert t_wp.k11_form(fewer) == t_tmp.k10_form(fewer) == "narrow"
        vol = torch.empty(fewer, device="meta")
        tgt = torch.empty((d, h - 1, w), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            t_wp.windowed_warp(vol, tgt, tgt, tgt, 4, form="narrow")
        with pytest.raises(ValueError, match="CUDA"):
            t_tmp.temporal_blend(bpar, vol, vol, (w, h - 1, d), h, 4,
                                 "weight", form="narrow")


@pytest.mark.parametrize("kernel", ["K10", "K11"])
def test_k10_k11_refuse_a_region_past_shared_memory(kernel):
    """From the first reprojection window whose region does not fit a
    block's 227 KB of shared memory K10's mirror names its region_global
    form (k = 52; one less region_shared) and its wrapper goes on to refuse
    only the meta tensors (not on CUDA) at both, as at region_global forced
    at k = 4; forced region_shared past the edge is refused by name. K11,
    which has no other form, refuses k = 108 by name, and one less goes on
    to refuse only the meta tensors."""
    shared = t_tmp.k10_shared_bytes if kernel == "K10" \
        else t_wp.k11_shared_bytes
    big = next(k for k in range(1, 400)
               if shared(k) + t_tmp.TILE_STATIC_SHARED
               > t_tmp.MAX_SHARED_BYTES)
    assert big == (52 if kernel == "K10" else 108)
    vol = torch.empty((4, 16, 15, 16), device="meta")
    tgt = torch.empty((16, 15, 16), device="meta")
    bpar = torch.empty((1, 24), device="meta")
    run = (lambda k, form=None: t_tmp.temporal_blend(
        bpar, vol, vol, (16, 15, 16), 15, k, "alpha", form=form)) \
        if kernel == "K10" else \
        (lambda k: t_wp.windowed_warp(vol, tgt, tgt, tgt, k))
    if kernel == "K10":
        assert t_tmp.region_form("K10", big) == "region_global"
        assert t_tmp.region_form("K10", big - 1) == "region_shared"
        for k, form in ((big, None), (4, "region_global")):
            with pytest.raises(ValueError, match="CUDA"):
                run(k, form)
        with pytest.raises(ValueError, match="K10's region does not fit a "
                                             "block's shared memory"):
            run(big, "region_shared")
    else:
        with pytest.raises(ValueError, match="K11's region does not fit a "
                                             "block's shared memory"):
            run(big)
    with pytest.raises(ValueError, match="CUDA"):
        run(big - 1)


# ---- K1 bake_radiance: each sample's lights spread over warps -----------

@pytest.mark.parametrize("n_lights,n_noise,low,want", [
    # FULL_CONFIG's low grid, 16 lights and the fBm channel: 16x2 patches
    (16, 1, (60, 34, 32), (2176, 128, 32, 4, 1, 3712, 16, 2)),
    # the demo grid: one spot light, no fBm channel: a thread a sample
    (1, 0, (80, 44, 32), (960, 128, 128, 1, 1, 0, 16, 8)),
    # a slab5 shard's low grid
    (16, 1, (60, 10, 32), (640, 128, 32, 4, 1, 3712, 16, 2)),
    # a ragged low slice (13 x 5), 5 items
    (3, 2, (13, 5, 3), (9, 128, 32, 4, 1, 2560, 16, 2)),
    (2, 0, (13, 5, 3), (6, 128, 64, 2, 1, 2816, 16, 4)),
    (3, 0, (13, 5, 3), (9, 128, 32, 4, 1, 1536, 16, 2)),
    # no local light: the fBm channel alone
    (0, 1, (13, 5, 3), (3, 128, 128, 1, 1, 0, 16, 8)),
    # 40 lights: two passes, one pass's pairs in shared memory
    (40, 1, (60, 34, 32), (2176, 128, 32, 4, 2, 5760, 16, 2))])
def test_k1_geometry(n_lights, n_noise, low, want):
    """K1's launch as ops/frame_fused.k1_geometry mirrors
    vr_bake_radiance_geometry: (blocks, threads, samples a block, light
    groups, passes, dynamic shared bytes, a block's columns and rows)."""
    geo = t_ff.k1_geometry(n_lights, n_noise, low)
    assert dataclasses.astuple(geo) == want
    assert geo.threads == 32 * t_ff.K1_WARPS
    assert geo.samples * geo.groups == geo.threads
    assert geo.columns * geo.rows == geo.samples
    assert geo.shared_bytes < 48 * 1024


def _k1_samples_of(geo, low, b, warp, lane):
    """csrc/bake_radiance.cu's (low slice, row, column) of the sample of
    lane `lane` of warp `warp` of block b."""
    wl, hl, _ = low
    sw = t_ff.K1_WARPS // geo.groups
    runs_x, runs_y = -(-wl // geo.columns), -(-hl // geo.rows)
    m, rem = divmod(b, runs_x * runs_y)
    by, bx = divmod(rem, runs_x)
    c = bx * t_ff.K1_WX + lane % t_ff.K1_WX
    r = (by * sw + warp % sw) * (32 // t_ff.K1_WX) + lane // t_ff.K1_WX
    return m, r, c


@pytest.mark.parametrize("n_lights,n_noise,low", [
    (16, 1, (60, 34, 32)), (1, 0, (80, 44, 32)), (16, 1, (60, 10, 32)),
    (3, 2, (13, 5, 3)), (3, 0, (13, 5, 3)), (0, 1, (13, 5, 3))])
def test_k1_blocks_cover_each_sample_once(n_lights, n_noise, low):
    """Each light group's warps of the blocks hold, less the lanes past a
    ragged edge, each low sample exactly once; so the sums (group 0) and
    every group's pairs see every sample."""
    wl, hl, dl = low
    geo = t_ff.k1_geometry(n_lights, n_noise, low)
    sw = t_ff.K1_WARPS // geo.groups
    for g in range(geo.groups):
        seen = np.zeros((dl, hl, wl), np.int64)
        for b in range(geo.blocks):
            for warp in range(g * sw, (g + 1) * sw):
                for lane in range(32):
                    m, r, c = _k1_samples_of(geo, low, b, warp, lane)
                    if r < hl and c < wl:
                        seen[m, r, c] += 1
        assert (seen == 1).all()


def _k1_items(n_lights, n_noise, active, groups):
    """The kernel's share of one sample's work: for each pass of K1_PASS
    lights, the active ones in light order (ranks 0 .. n_act - 1) and, in
    the first pass, the fBm channels after them; light group g takes the
    items whose rank is g modulo groups. Returns ({group: [item]}, the
    lights in the order the sums add them)."""
    taken, order = {}, []
    passes = max(1, -(-n_lights // t_ff.K1_PASS))
    for p in range(passes):
        lights = [li for li in range(p * t_ff.K1_PASS,
                                     min((p + 1) * t_ff.K1_PASS, n_lights))
                  if active[li]]
        items = [("light", li) for li in lights]
        items += [("noise", c) for c in range(n_noise)] if p == 0 else []
        for q, item in enumerate(items):
            taken.setdefault(q % groups, []).append(item)
        order += lights
    return taken, order


@pytest.mark.parametrize("n_lights,n_noise", [(16, 1), (40, 1), (1, 0),
                                              (3, 2), (70, 4)])
def test_k1_items_each_once_in_light_order(n_lights, n_noise):
    """Every active light of a low slice and every fBm channel is one light
    group's item exactly once, and the sums add the lights in ascending
    index as the thread-per-sample form did, over any number of passes."""
    rng = np.random.default_rng(n_lights)
    active = rng.random(n_lights) < 0.75
    groups = t_ff.k1_geometry(n_lights, n_noise, (60, 34, 32)).groups
    taken, order = _k1_items(n_lights, n_noise, active, groups)
    flat = [it for its in taken.values() for it in its]
    assert sorted(flat) == sorted(
        [("light", li) for li in np.flatnonzero(active).tolist()]
        + [("noise", c) for c in range(n_noise)])
    assert order == np.flatnonzero(active).tolist()
    assert set(taken) <= set(range(groups))


# ---- K7 dir_shadow: K5's tile without the region; K8 integrate: column
# tiles whose slices go in chunks ------------------------------------------

K7 = t_ds.K7_TILE


@pytest.mark.parametrize("grid,want", [
    ((240, 135, 128), (15, 9, 128)),     # FULL_CONFIG
    ((160, 88, 64), (10, 6, 64)),        # the demo grid
    ((240, 57, 128), (15, 4, 128))])     # a slab3 shard, halo included
def test_k7_tile_grid(grid, want):
    """One block per 16x16 tile of each slice, K5's tile."""
    assert K7 == t_sb.K5_TILE == (16, 16)
    assert t_sca.tile_grid(grid, K7) == want


@pytest.mark.parametrize("grid", [(16, 15, 16), (37, 21, 2)])
def test_k7_blocks_cover_each_froxel_once(grid):
    """The blocks of a K7 launch, less their masked threads, hold each
    froxel exactly once, on ragged grids: block (bx, by, z), thread (tx,
    ty) at column 16 bx + tx, row 16 by + ty of slice z, as
    csrc/dir_shadow.cu reckons them."""
    w, h, d = grid
    gx, gy, gz = t_sca.tile_grid(grid, K7)
    seen = np.zeros((d, h, w), np.int64)
    tx, ty = np.meshgrid(np.arange(K7[0]), np.arange(K7[1]), indexing="xy")
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                x, y = bx * K7[0] + tx, by * K7[1] + ty
                keep = (x < w) & (y < h)
                np.add.at(seen, (bz, y[keep], x[keep]), 1)
    assert (seen == 1).all()


def test_k8_geometry():
    """K8's tile as ops/integrate.k8_geometry mirrors vr_integrate_geometry:
    16 columns in 2 rows, slices 16 at a time, 256 threads (warp 0 carries
    the tile's 32 columns), and two terms buffers [5, 16, 32], the xy blend
    [4, 17, 32] and slice_dz [16] of float32 in dynamic shared memory,
    under the 48 KB a launch takes without an opt-in."""
    geo = t_int.k8_geometry()
    assert dataclasses.astuple(geo) == (16, 2, 16, 256, 29248)
    tile = geo.columns * geo.rows
    assert 32 % tile == 0 and (geo.threads - 32) % tile == 0
    assert geo.shared_bytes <= 48 * 1024


@pytest.mark.parametrize("grid,want", [((240, 135, 128), 1020),
                                       ((160, 88, 64), 440),
                                       ((240, 57, 128), 435),
                                       ((37, 21, 2), 33)])
def test_k8_blocks_cover_each_column_once(grid, want):
    """K8's 1-D launch grid: block b owns the 16 x 2 columns from column
    16 (b % tiles) and row 2 (b // tiles), tiles = ceil(W / 16), its tile
    column c at (c % 16, c // 16), as csrc/integrate.cu reckons them; the
    blocks, less the columns past the grid's edges, hold each (y, x)
    column exactly once."""
    w, h, _ = grid
    geo = t_int.k8_geometry()
    assert t_int.k8_blocks(grid) == want
    tiles = -(-w // geo.columns)
    seen = np.zeros((h, w), np.int64)
    c = np.arange(geo.columns * geo.rows)
    for b in range(want):
        by = b // tiles
        x = (b - by * tiles) * geo.columns + c % geo.columns
        y = by * geo.rows + c // geo.columns
        keep = (x < w) & (y < h)
        np.add.at(seen, (y[keep], x[keep]), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("d", [16, 64, 100, 128])
def test_k8_chunks_cover_each_slice_once(d):
    """A block's chunks hold each slice exactly once, in order, full chunks
    of 16 and then the rest (100 = 6 x 16 + 4); and the kernel's schedule
    -- chunk 0's terms by every thread, then per chunk c warp 0 carrying c
    while the other warps store c - 1 and compute c + 1's terms into the
    buffer c - 1 held, then the last chunk's store -- computes each chunk's
    terms before it is carried, carries it before it is stored, and stores
    it before its buffer takes another chunk's terms."""
    chunks = t_int.k8_chunks(d)
    zc = t_int.k8_geometry().slices
    seen = np.zeros(d, np.int64)
    for z0, nz in chunks:
        assert 0 < nz <= zc and z0 % zc == 0
        seen[z0:z0 + nz] += 1
    assert (seen == 1).all()
    assert [nz for _, nz in chunks[:-1]] == [zc] * (len(chunks) - 1)
    buffers = {0: 0}             # buffer -> the chunk whose terms it holds
    done = {"terms": {0}, "carry": set(), "store": set()}
    for c in range(len(chunks)):
        assert buffers[c & 1] == c and c in done["terms"]
        done["carry"].add(c)     # warp 0
        if c > 0:                # the other warps, in this order
            assert buffers[(c + 1) & 1] == c - 1 and c - 1 in done["carry"]
            done["store"].add(c - 1)
        if c + 1 < len(chunks):
            assert c - 1 < 0 or c - 1 in done["store"]
            buffers[(c + 1) & 1] = c + 1
            done["terms"].add(c + 1)
    done["store"].add(len(chunks) - 1)
    assert done["terms"] == done["carry"] == done["store"] \
        == set(range(len(chunks)))


@pytest.mark.parametrize("grid", [(2048, 2048, 128), (8, 8, 65536)])
def test_k7_refuses_indices_past_32_bits(tables, grid):
    """K7's narrow form raises ValueError, before any launch, where K2's
    and K5's do (ops/scatter.check_tile_indices): [4, D, H, W] planes past
    2^31 - 1 floats or more than 65535 slices; its wide form takes them,
    and it and the largest grid under 32 bits go on to refuse only the
    meta tables (not on CUDA)."""
    t = dataclasses.replace(tables, grid_whd=grid,
                            spar=tables.spar.to("meta"))
    with pytest.raises(ValueError, match="K7's narrow form.*(2\\^31|65535)"):
        t_ds.dir_shadow(t, form="narrow")
    assert t_ds.k7_form(t) == "wide"
    with pytest.raises(ValueError, match="CUDA"):
        t_ds.dir_shadow(t)
    t = dataclasses.replace(t, grid_whd=(2048, 2047, 128))
    assert t_ds.k7_form(t) == "narrow"
    with pytest.raises(ValueError, match="CUDA"):
        t_ds.dir_shadow(t)


@pytest.mark.parametrize("grid,refused", [((2048, 2048, 128), True),
                                          ((4096, 4096, 64), True),
                                          ((2048, 2047, 128), False),
                                          ((8, 8, 65536), False)])
def test_k8_refuses_indices_past_32_bits(tables, grid, refused):
    """K8's narrow form raises ValueError, before any launch, for
    [4, D, H, W] planes past 2^31 - 1 floats, as its launcher does; one row
    fewer, or 65536 slices (a loop of each block, not a launch-grid axis),
    goes on to refuse only the meta tensor (not on CUDA). Its wide form
    takes every one of these grids (k8_form's rule picks it where the
    narrow one refuses)."""
    w, h, d = grid
    t = dataclasses.replace(tables, grid_whd=grid)
    scatter = torch.empty((4, d, h, w), device="meta")
    with pytest.raises(ValueError, match="K8's narrow form.*2\\^31"
                       if refused else "CUDA"):
        t_int.accumulate(t, scatter, form="narrow")
    assert t_int.k8_form(t) == ("wide" if refused else "narrow")
    with pytest.raises(ValueError, match="CUDA"):
        t_int.accumulate(t, scatter)


# ---- K12 pcf_shadow: slice tiles of every sun in one launch; K9
# bake_visibility: K1's light groups over a low slice's patch -------------

K12 = t_pcf.K12_TILE


@pytest.mark.parametrize("grid,nd,want", [
    ((120, 135, 64), 1, (8, 9, 64)),      # FULL_CONFIG, low rate
    ((240, 135, 128), 1, (15, 9, 128)),   # full rate
    ((160, 88, 64), 1, (10, 6, 64)),      # the demo grid
    ((120, 135, 64), 2, (8, 9, 128)),     # two suns: grid z = sun x slice
    ((37, 21, 2), 3, (3, 2, 6))])
def test_k12_grid(grid, nd, want):
    """One block per 16x16 tile of each slice of each sun."""
    assert K12 == (16, 16)
    assert t_pcf.k12_grid(grid, nd) == want


@pytest.mark.parametrize("grid,nd", [
    ((120, 135, 64), 1), ((240, 135, 128), 1), ((160, 88, 64), 1),
    ((120, 135, 64), 2), ((37, 21, 2), 3), ((16, 15, 16), 1),
    ((1, 1, 1), 2)])
def test_k12_blocks_cover_each_froxel_once(grid, nd):
    """The froxels of a K12 launch, less the masked ones, are each
    (sun, slice, row, column) exactly once: block (bx, by, bz), thread
    (tx, ty) and its row j < 4 at sun bz // D, slice bz % D, column
    16 bx + tx and row 16 by + ty + 4 j, its output at ((bz H) + y) W + x
    -- as csrc/pcf_shadow.cu reckons them."""
    w, h, d = grid
    gx, gy, gz = t_pcf.k12_grid(grid, nd)
    rows = t_pcf.K12_ROWS_PER_THREAD
    threads_y = K12[1] // rows
    bz, by, bx, j, ty, tx = np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx), np.arange(rows),
        np.arange(threads_y), np.arange(K12[0]), indexing="ij")
    x, y = bx * K12[0] + tx, by * K12[1] + ty + threads_y * j
    keep = (x < w) & (y < h)
    sun, z = bz // d, bz % d
    flat = ((bz * h + y) * w + x)[keep]
    seen = np.bincount(flat, minlength=nd * d * h * w)
    assert (seen == 1).all()
    assert np.array_equal(flat, (((sun * d + z) * h + y) * w + x)[keep])


@pytest.mark.parametrize("nc,want", [(1, 876), (2, 1352), (3, 1828),
                                     (4, 2304)])
def test_k12_shared_bytes(nc, want):
    """K12's dynamic shared memory at 1-4 cascades (the 2x2 atlas has 4):
    the slice's 3 products and count, per cascade its order entry, 2
    constant terms and a sphere, per column 3 + 5 C floats and per row
    3 + 2 C, under the 48 KB a launch takes without an opt-in."""
    tx, ty = K12
    assert t_pcf.k12_shared_bytes(nc) == want == 4 * (
        4 + nc * (1 + 2 + 4) + tx * (3 + 5 * nc) + ty * (3 + 2 * nc))
    assert want <= 48 * 1024


def _pcf_meta(grid, nd, s2, nc=4):
    w, h, d = grid
    meta = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device="meta")
    t = t_pcf.PcfTables(
        par=meta(nd, 24), coef=meta(nd, d, nc, 8),
        order=meta(nd, d, nc, dtype=torch.int32),
        count=meta(nd, d, dtype=torch.int32), spheres=meta(nd, nc, 4),
        grid_whd=grid, h_glob=h)
    return t, meta(nd, s2, s2)


@pytest.mark.parametrize("grid,nd,s2,refused", [
    ((4096, 4096, 128), 1, 1024, True),    # 2^31 floats of volume
    ((4096, 4095, 128), 1, 1024, False),
    ((1024, 1024, 1024), 2, 1024, True),
    ((16, 15, 16), 1, 46341, True),        # 46341^2 > 2^31 - 1
    ((16, 15, 16), 1, 46340, False),
    ((16, 15, 16), 2, 32768, True),        # two 2^30-texel atlases
    ((8, 8, 32768), 2, 64, True),          # 65536 slices of both suns
    ((8, 8, 65535), 1, 64, False)])
def test_k12_refuses_indices_past_32_bits(grid, nd, s2, refused):
    """K12's narrow form, forced, raises ValueError, naming K12, before the
    launch for volumes or atlases past 2^31 - 1 floats or a launch grid past
    65535 (sun, slice) pairs, as its launcher refuses them; its size rule
    (ops/pcf_shadow.k12_form) takes the wide form there. Just under each
    limit the rule takes the narrow form. Either way the wrapper goes on to
    refuse only the meta tensors (not on CUDA)."""
    t, atlas = _pcf_meta(grid, nd, s2)
    if refused:
        with pytest.raises(ValueError,
                           match="K12's narrow form.*(2\\^31|65535)"):
            t_pcf.pcf_shadow(t, atlas, form="narrow")
    assert t_pcf.k12_form(t, atlas) == ("wide" if refused else "narrow")
    with pytest.raises(ValueError, match="CUDA"):
        t_pcf.pcf_shadow(t, atlas)


@pytest.mark.parametrize("n_lights,low,want", [
    # FULL_CONFIG's low grid (ss=4), 16 lights: 32 samples a block
    (16, (60, 34, 32), (2048, 128, 32, 4, 64, 1536)),
    # demo_scene's one spot light: every warp its own samples
    (1, (60, 34, 32), (512, 128, 128, 1, 16, 1536)),
    (1, (80, 44, 32), (896, 128, 128, 1, 28, 1536)),   # the demo grid
    # 40 lights: ten a light group
    (40, (60, 34, 32), (2048, 128, 32, 4, 64, 1536)),
    # a ragged low slice (13 x 5 = 65 samples)
    (3, (13, 5, 3), (9, 128, 32, 4, 3, 1536)),
    (2, (13, 5, 3), (6, 128, 64, 2, 2, 1536)),
    (0, (13, 5, 3), (3, 128, 128, 1, 1, 1536))])
def test_k9_geometry(n_lights, low, want):
    """K9's launch as ops/visibility.k9_geometry mirrors
    vr_bake_visibility_geometry: (blocks, threads, samples a block, light
    groups, runs a low slice, static shared bytes)."""
    geo = t_vis.k9_geometry(n_lights, low)
    assert dataclasses.astuple(geo) == want
    assert geo.threads == 32 * t_vis.K9_WARPS
    assert geo.samples * geo.groups == geo.threads
    assert geo.blocks == geo.runs * low[2]
    assert geo.shared_bytes == 4 * 3 * geo.threads


def _k9_pairs(n_lights, low):
    """csrc/bake_visibility.cu's (light, low slice, row, column) of every
    thread's every store, in the order each thread makes them: block b's
    slice m = b // runs and run b % runs; warp w's light group g = w // sw
    and place wi in it; lane l's sample at = ((b % runs) sw + wi) 32 + l of
    the slice, row at // WL and column at % WL; its lights g, g + groups,
    ...; lanes past the slice's last sample store nothing. Returns
    [(warp id, light, m, r, c)] as an array."""
    wl, hl, dl = low
    geo = t_vis.k9_geometry(n_lights, low)
    sw = t_vis.K9_WARPS // geo.groups
    b, warp, lane = np.meshgrid(np.arange(geo.blocks),
                                np.arange(t_vis.K9_WARPS), np.arange(32),
                                indexing="ij")
    m, run = np.divmod(b, geo.runs)
    g, wi = np.divmod(warp, sw)
    at = (run * sw + wi) * 32 + lane
    keep = at < wl * hl
    r, c = np.divmod(at, wl)
    rows = []
    for li in range(n_lights):
        take = keep & (li % geo.groups == g)
        wid = (b * t_vis.K9_WARPS + warp)[take]
        rows.append(np.stack([wid, np.full_like(wid, li), m[take], r[take],
                              c[take]], axis=1))
    return np.concatenate(rows) if rows else np.zeros((0, 5), np.int64)


@pytest.mark.parametrize("n_lights,low", [
    (16, (60, 34, 32)), (1, (60, 34, 32)), (1, (80, 44, 32)),
    (40, (60, 34, 32)), (3, (13, 5, 3)), (2, (13, 5, 3)), (5, (7, 3, 2))])
def test_k9_blocks_cover_each_pair_once(n_lights, low):
    """The stores of a K9 launch hold each (light, low sample) pair
    exactly once, on the full grid's, the demo grid's and ragged low
    grids, at 1 to 40 lights; each warp's 32 lanes store one light of one
    slice at a time, so its cull (uniform per light and slice) never
    splits it, and their samples are consecutive (one coalesced store)."""
    wl, hl, dl = low
    pairs = _k9_pairs(n_lights, low)
    li, m, r, c = pairs[:, 1], pairs[:, 2], pairs[:, 3], pairs[:, 4]
    flat = ((li * dl + m) * hl + r) * wl + c
    seen = np.bincount(flat, minlength=n_lights * dl * hl * wl)
    assert (seen == 1).all()
    by_warp = {}
    for (wid, light, mm, _, _), f in zip(pairs.tolist(), flat.tolist()):
        by_warp.setdefault((wid, light), (set(), []))
        by_warp[(wid, light)][0].add(mm)
        by_warp[(wid, light)][1].append(f)
    for slices, stores in by_warp.values():
        assert len(slices) == 1
        assert stores == list(range(stores[0], stores[0] + len(stores)))


@pytest.mark.parametrize("n_lights", [1, 16, 40])
def test_k9_lights_each_once_in_light_order(n_lights):
    """Each warp takes its light group's lights g, g + groups, ... in
    ascending order, and the light groups together take every light exactly
    once: no cap on the light count (40 = ten a group)."""
    geo = t_vis.k9_geometry(n_lights, (60, 34, 32))
    taken = {g: list(range(g, n_lights, geo.groups))
             for g in range(geo.groups)}
    for lights in taken.values():
        assert lights == sorted(lights)
    flat = sorted(li for lights in taken.values() for li in lights)
    assert flat == list(range(n_lights))
    assert geo.groups == min(t_vis.K9_WARPS, 1 << max(0, n_lights - 1)
                             .bit_length())
    pairs = _k9_pairs(n_lights, (60, 34, 32))
    order = {}
    for wid, light, _, _, _ in pairs.tolist():
        if order.setdefault(wid, [light])[-1] != light:
            order[wid].append(light)
    for lights in order.values():
        assert lights == sorted(lights)
        assert len(set(li % geo.groups for li in lights)) == 1


@pytest.mark.parametrize("grid,n_lights,refused", [
    ((2048, 2048, 128), 4, False),    # [4, D, H, W] planes: not K9's
    ((8, 8, 65536), 4, False),        # past 65535 slices: a 1-D grid
    ((2048, 2047, 128), 300, False),  # 300 lights' volume: the wide form
    ((2048, 2047, 128), 4, False),
    ((16, 15, 16), 2 ** 27, True)])   # the lights table: 2^31 floats
def test_k9_refuses_indices_past_32_bits(tables, grid, n_lights, refused):
    """K9's wrapper raises ValueError, naming K9, before the launch, only
    for what its wide form cannot index (ops/visibility.k9_form): here a
    lights table [NL, 16] of 2^31 floats. The planes it never indexes, a
    slice count past 65535 (its blocks are a 1-D grid) and a [NL, DL, HL,
    WL] volume past 2^31 - 1 floats (the wide form) go on to refuse only
    the meta tables (not on CUDA)."""
    lights = torch.empty((n_lights, 16), device="meta")
    t = dataclasses.replace(tables, grid_whd=grid, lights=lights,
                            spar=tables.spar.to("meta"))
    with pytest.raises(ValueError, match="K9.*2\\^31" if refused
                       else "CUDA"):
        t_vis.bake_visibility(t)


# --------------------------------------------------------------------------
# K13 ssr_march (csrc/ssr_march.cu)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hq,wq,n_bins,max_taps,grid,shared,unroll", [
    (270, 480, 8, 12, (15, 68), 1568, 16),    # 1080p at ssr_downsample=4
    (270, 480, 16, 24, (15, 68), 6208, 32),   # ssr_steps=24, ssr_dirs=16
    (3, 10, 8, 12, (1, 1), 1568, 16),         # smaller than one tile
    (33, 65, 1, 1, (3, 9), 20, 16)])
def test_k13_launch(hq, wq, n_bins, max_taps, grid, shared, unroll):
    """K13's 32x4-pixel tiles, the ragged ones in a partial block; a
    block's copy of the table; the kernel instance for its tap count."""
    assert t_ssr.K13_TILE == (32, 4)
    assert t_ssr.k13_grid(hq, wq) == grid
    assert t_ssr.k13_shared_bytes(n_bins, max_taps) == shared
    assert t_ssr.k13_unroll(max_taps) == unroll


def test_k13_refuses_a_table_past_its_unroll():
    """33 taps a bin pass the largest fixed instance and take the GEN
    instance (k13_unroll 0); a table past 48 KB stays in device memory
    (GEN's global form). Neither is refused any more: the wrapper reaches the device
    check (meta planes). What K13 still refuses before a launch: a forced
    form that cannot take the table, and an offset past its 12-bit
    packing."""
    assert t_ssr.k13_unroll(32) == 32
    assert t_ssr.k13_unroll(33) == 0
    planes = [torch.empty((270, 480), device="meta") for _ in range(8)]
    tap = (1.0, 2.0, 0, 2)
    for offsets, form in (((tuple([tap] * 33),) * 8, "gen"),
                          ((tuple([tap] * 32),) * 96, "gen_global")):
        assert t_ssr.k13_form(len(offsets), len(offsets[0])) == form
        with pytest.raises(ValueError, match="CUDA"):
            t_ssr.ssr_march(planes[0], planes[1:4], *planes[4:], offsets,
                            0.6, 56.0)
        with pytest.raises(ValueError, match="K13 form 'fixed'"):
            t_ssr.ssr_march(planes[0], planes[1:4], *planes[4:], offsets,
                            0.6, 56.0, form="fixed")
    with pytest.raises(ValueError, match="2048"):
        t_ssr.pack_taps(((tap, (1.0, 2.0, 0, -2048)),), 56.0)


# (bins, taps a bin) -> K13's form by the size rule: the ssr_steps /
# ssr_dirs tables of the default, 24 / 16, 48 / 8, 64 / 16, 96 / 64, 96 /
# 128, and the edges of static shared memory (48 KB) for the fixed and the
# GEN instance
K13_FORM_CASES = [
    (8, 12, "fixed"), (16, 24, "fixed"), (8, 33, "gen"), (16, 39, "gen"),
    (64, 54, "gen_global"), (128, 54, "gen_global"), (95, 32, "fixed"),
    (96, 32, "gen_global"), (189, 16, "fixed"), (56, 54, "gen"),
    (57, 54, "gen_global")]


@pytest.mark.parametrize("n_bins,max_taps,form", K13_FORM_CASES)
def test_k13_form(n_bins, max_taps, form):
    """The wrapper's mirror of K13's size rule, and the forms that can be
    forced on the same table: a fixed form up to 32 taps a bin, a shared
    form where its bytes fit, the global form always."""
    assert t_ssr.k13_form(n_bins, max_taps) == form
    smem = t_ssr.k13_shared_bytes(n_bins, max_taps)
    unrolled = max_taps <= 32
    fits = {"fixed": unrolled and smem <= 48 * 1024,
            "gen": smem <= 48 * 1024, "gen_global": True}
    assert tuple(fits) == t_ssr.K13_FORMS
    for f, ok in fits.items():
        if ok:
            assert t_ssr.k13_form(n_bins, max_taps, f) == f
        else:
            with pytest.raises(ValueError, match="K13 form"):
                t_ssr.k13_form(n_bins, max_taps, f)


@pytest.mark.parametrize("kw", [{}, dict(ssr_steps=24, ssr_dirs=16)])
def test_k13_packed_taps_match_ssr_offsets(kw):
    """pack_taps against post._ssr_offsets: each row's t_prev, t and
    t / max_px as float32, its offsets, the counts, and the reuse flag set
    exactly where t_prev equals the previous kept tap's t."""
    cfg = t_post.PostConfig(**kw)
    offsets = t_post._ssr_offsets(cfg)
    max_px = float(cfg.ssr_max_px)
    rows, counts = t_ssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)[..., 3]
    assert rows.shape == (len(offsets), max(len(b) for b in offsets), 4)
    assert counts.tolist() == [len(b) for b in offsets]
    n_reuse = 0
    for b, taps in enumerate(offsets):
        for i, (t_prev, t, oy, ox) in enumerate(taps):
            f = np.float32
            assert rows[b, i, :3].tolist() == [f(t_prev), f(t),
                                               f(t / max_px)]
            p = int(bits[b, i])
            assert ((p & 0xfff) - 2048, ((p >> 12) & 0xfff) - 2048) == \
                (oy, ox)
            reuse = i > 0 and t_prev == taps[i - 1][1]
            assert (p >> 24) == int(reuse), (b, i)
            n_reuse += reuse
        assert not bits[b, len(taps):].any()
    assert 0 < n_reuse < sum(counts)


def k13_emulate(dq, colors, invz0, g, bin_idx, valid, offsets, thickness,
                max_px):
    """K13's march as the kernel runs it, one pixel at a time in float32:
    its bin's taps from pack_taps' table, the reused 1/z, the first hit and
    its colours only. [5, hq, wq]."""
    rows, counts = t_ssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)
    f = np.float32
    dq_, cr, cg, cb, z0p, gp, bp, vp = (
        p.numpy() for p in (dq, *colors, invz0, g, bin_idx, valid))
    hq, wq = dq_.shape
    depth = lambda v: f(1.0) / v if v > f(1e-4) else f(1e9)
    out = np.zeros((5, hq, wq), np.float32)
    for y in range(hq):
        for x in range(wq):
            acc = [f(0.0)] * 5
            bf = bp[y, x]
            b = int(bf)
            if bf >= 0 and b < len(offsets) and f(b) == bf:
                z0, gi, z_last = z0p[y, x], gp[y, x], f(0.0)
                for k in range(counts[b]):
                    t_prev, t, tf = rows[b, k, :3]
                    p = int(bits[b, k, 3])
                    sy = y + (p & 0xfff) - 2048
                    sx = x + ((p >> 12) & 0xfff) - 2048
                    zs = dq_[min(max(sy, 0), hq - 1), min(max(sx, 0), wq - 1)]
                    z_ray = depth(z0 + gi * t)
                    z_prev = z_last if (p >> 24) & 1 else \
                        depth(z0 + gi * t_prev)
                    z_last = z_ray
                    if (0 <= sy < hq and 0 <= sx < wq and z_ray >= zs
                            and z_prev <= zs + f(thickness)):
                        acc = [f(0.0) + cr[sy, sx], f(0.0) + cg[sy, sx],
                               f(0.0) + cb[sy, sx], f(1.0), f(0.0) + tf]
                        break
            for c in range(5):
                out[c, y, x] = f(0.0) + vp[y, x] * acc[c]
    return out


def test_k13_first_hit_march_is_the_twin():
    """The kernel's march (k13_emulate: first hit only, colours read only
    there, 1/z reused where flagged) against the twin, bit for bit (sign
    bits included), on a 12x20 plane with a red plane that is 0 at every
    hit and a blue one of -0 in places; bins 0-7, one not integral and two
    out of the table."""
    rng = np.random.default_rng(3)
    hq, wq = 12, 20
    dq = rng.uniform(4.0, 12.0, (hq, wq)).astype(np.float32)
    invz0 = (np.float32(1.0) / dq).astype(np.float32)
    g = (-invz0 * rng.uniform(0.0, 0.2, (hq, wq))).astype(np.float32)
    bins = rng.integers(0, 8, (hq, wq)).astype(np.float32)
    bins[0, :3] = (-1.0, 8.0, 2.5)
    valid = (rng.uniform(size=(hq, wq)) < 0.8).astype(np.float32)
    cg = rng.uniform(0.0, 1.0, (hq, wq)).astype(np.float32)
    cb = np.where(rng.uniform(size=(hq, wq)) < 0.3, np.float32(-0.0),
                  rng.uniform(0.0, 1.0, (hq, wq))).astype(np.float32)
    planes = [torch.as_tensor(a) for a in
              (dq, np.zeros_like(dq), cg, cb, invz0, g, bins, valid)]
    cfg = t_post.PostConfig(ssr_max_px=8)
    offsets = t_post._ssr_offsets(cfg)
    args = (planes[0], planes[1:4], *planes[4:], offsets, 0.6, 8.0)
    twin = torch.stack(t_ssr.ssr_march_reference(*args)).numpy()
    got = k13_emulate(*args)
    hit = twin[3] > 0
    assert 0.05 < hit.mean() < 0.95
    assert (got.view(np.int32) == twin.view(np.int32)).all()
