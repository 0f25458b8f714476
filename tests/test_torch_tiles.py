"""The host side of K2's and K6's slice tiles (csrc/shadow_scatter.cu,
csrc/scatter.cu, csrc/common.cuh): the launch grid and K2's shared memory
as the wrappers mirror them, the reach of K2's reprojection region, and the
wrappers' refusal of tables the kernels cannot index in 32 bits. Plain
Python and torch on the CPU (meta tensors for the large grids); no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import scatter as t_sca


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
    """K2's and K6's wrappers raise ValueError, before any launch, for a
    grid whose [4, D, H, W] planes pass 2^31 - 1 floats or whose launch grid
    would hold more than 65535 slices."""
    t, shadow, bake = _at(tables, grid)
    with pytest.raises(ValueError, match="2\\^31|65535"):
        t_sca.check_tile_indices(t)
    with pytest.raises(ValueError, match="2\\^31|65535"):
        t_ff.shadow_scatter(t, shadow, bake)
    with pytest.raises(ValueError, match="2\\^31|65535"):
        t_sca.scatter_local(t, shadow, bake)


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
    """A reprojection window whose region does not fit a block's 227 KB of
    shared memory is refused by K2's wrapper; K6 has no region."""
    big = next(k for k in range(1, 100)
               if t_ff.k2_shared_bytes(k) + t_ff.K2_STATIC_SHARED
               > t_ff.MAX_SHARED_BYTES)
    t, shadow, bake = _at(tables, (16, 15, 16), k=big)
    with pytest.raises(ValueError, match="shared memory"):
        t_ff.shadow_scatter(t, shadow, bake)
    t, shadow, bake = _at(tables, (16, 15, 16), k=big - 1)
    with pytest.raises(ValueError, match="CUDA"):
        t_ff.shadow_scatter(t, shadow, bake)
