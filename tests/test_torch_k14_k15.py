"""The gathers of K14 (csrc/composite_grad.cu, K4's adjoint) and K15
(csrc/ssr_march_grad.cu, the SSR march's adjoint) on the CPU, without JAX:

  * K14's twin composite_grad_plain (each froxel's terms in K14's fixed
    order, rounds of index operations) against the scatter it replaced --
    index_add_ of each of K4's xy taps into one zeroed volume -- to 1e-6
    relative and 1e-6 of the largest element absolute (the same products
    summed in another order: a froxel sums up to ~100 terms of both signs,
    and where they cancel the rounding is relative to the terms, not to
    their sum), in the cells and the per-pixel form, at an integer and a
    non-integer pixel/froxel ratio, with depths below the near plane and
    past the volume's far end (the far clamp) and taps clamped at every
    edge of the grid;
  * the host footprints (zg_composite.axis_footprint, grad_footprint)
    against a brute-force enumeration of every pixel's taps, at the
    training paths' ratios (720/88 among them) and at ratios below 1;
  * K14's gather emulated as the kernel runs it -- a thread a (froxel
    column, channel), its d sums from +0, the block's footprint in chunks of
    K14_ROWS rows, the tap ranges of the host table -- equal to the twin bit
    for bit;
  * K15's code plane and gather emulated as the kernel runs them, on the
    plane k15_code_shape gives and the offsets tap_extent gives, every
    thread of the launch grid included, equal to the unchanged twin
    ssr_march_grad_plain bit for bit;
  * the wrappers' refusals before a launch (meta tensors): K14 past the
    shared memory a block may take, K15's table past 48 KB;
  * the launch mirrors K14_TILE, k14_shared_bytes, K15_TILE,
    k15_shared_bytes and k15_code_shape at the shapes the paths use
    (chip_smoke.py holds them against the kernels' own on the card).
"""

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.ops import ssr as tssr
from volumetricrenderer_tpu_torch.ops import zg_composite as zg

import torch_tolerance  # noqa: F401  (torch's threads under xdist)

FOV, NEAR = 1.0, 0.3
# (form, (IH, IW), grid (W, H, D)): an integer ratio per form, and 720/88
# (the demo grid's rows) scaled down to 90 rows on 11
SHAPES = [("cells", (32, 48), (16, 16, 8)),
          ("cells", (24, 40), (8, 6, 6)),
          ("pixels", (36, 50), (16, 11, 8)),
          ("pixels", (90, 80), (10, 11, 6))]


def _inputs(form, shape, grid, seed=0):
    (ih, iw), (w, h, d) = shape, grid
    rng = np.random.default_rng(seed)
    params = tfroxel.make_froxel_params(torch.tensor(FOV),
                                        torch.tensor(iw / ih),
                                        torch.tensor(NEAR), 100.0, 0.5, grid)
    return (torch.as_tensor(rng.normal(size=(ih, iw, 4)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0, 1, (ih, iw, 3)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0.05, 140.0, (ih, iw))
                            .astype(np.float32)), params, grid, form)


def _index_add_twin(grad_img, scene_color, view_depth, params, grid_whd,
                    form):
    """The twin K14 had as an atomic scatter: per xy tap of K4 (the cells
    form's 3x3 neighbours, the per-pixel form's 2x2), index_add_ of
    (g (1 - f)) w at z0 and (g f) w at z1 into one zeroed volume."""
    w, h, d = grid_whd
    shape = tuple(view_depth.shape)
    z0, z1, f = zg._z_taps(params, view_depth, d)
    gv = zg._grad_of_v(grad_img, scene_color)
    g0, g1 = gv * (1.0 - f), gv * f
    taps = zg._cell_taps_plain(shape, grid_whd, zg.cell_weights(
        shape[0] // h, shape[1] // w), h, 0, "cpu") if form == "cells" \
        else zg._pixel_taps_plain(shape, grid_whd, None, "cpu")
    out = torch.zeros((4, d * h * w), dtype=torch.float32)
    for yy, xx, wt in taps:
        for z, g in ((z0, g0), (z1, g1)):
            out.index_add_(1, ((z * h + yy) * w + xx).reshape(-1),
                           (g * wt).reshape(4, -1))
    return out.reshape(4, d, h, w)


@pytest.mark.parametrize("form,shape,grid", SHAPES)
def test_twin_equals_the_index_add_scatter(form, shape, grid):
    args = _inputs(form, shape, grid)
    depth = args[2]
    assert float(depth.min()) < NEAR and float(depth.max()) > 100.0
    got = zg.composite_grad_plain(*args)
    want = _index_add_twin(*args)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    # the far clamp and every edge row and column receive terms
    assert float(got[:, -1].abs().sum()) > 0.0
    for edge in (got[:, :, 0], got[:, :, -1], got[..., 0], got[..., -1]):
        assert float(edge.abs().sum()) > 0.0


def _brute_taps(ih, iw, grid, form):
    """Every pixel's K4 taps by enumeration: per image row its two froxel
    rows (a = 0, 1) and per column its two froxel columns, from
    pixel_taps' first taps or cell_taps' first window row and column,
    clamped to the grid."""
    w, h, _ = grid
    if form == "pixels":
        ky, kx = zg.pixel_taps(ih, h)[0], zg.pixel_taps(iw, w)[0]
    else:
        py, px = ih // h, iw // w
        first, _ = zg.cell_taps(zg.cell_weights(py, px))
        ky = [i // py + first[(i % py) * px, 0] - 1 for i in range(ih)]
        kx = [j // px + first[j % px, 1] - 1 for j in range(iw)]
    clamp = lambda v, n: min(max(int(v), 0), n - 1)
    rows = [[clamp(k + t, h) for t in (0, 1)] for k in ky]
    cols = [[clamp(k + t, w) for t in (0, 1)] for k in kx]
    return rows, cols


@pytest.mark.parametrize("form,ih,iw,grid", [
    ("pixels", 720, 1280, (160, 88, 64)),    # train_fog: 720/88 rows
    ("cells", 704, 1280, (160, 88, 64)),     # train_lights, train_opacity
    ("cells", 1080, 1920, (240, 135, 128)),
    ("pixels", 270, 480, (80, 44, 32)),      # 270/44, 480/80
    ("pixels", 10, 16, (16, 11, 4)),         # fewer pixels than froxels
    ("cells", 32, 48, (16, 16, 8))])
def test_footprint_against_every_pixels_taps(form, ih, iw, grid):
    w, h, _ = grid
    rows, cols = _brute_taps(ih, iw, grid, form)
    table, fw = zg.grad_footprint(ih, iw, grid, form)
    ry, rx = table[:4 * h].reshape(4, h), table[4 * h:].reshape(4, w)
    for taps, r, n in ((rows, ry, h), (cols, rx, w)):
        for t in (0, 1):
            for y in range(n):
                hits = [i for i, tp in enumerate(taps) if tp[t] == y]
                assert hits == list(range(r[2 * t, y], r[2 * t + 1, y])), \
                    (t, y)
    # a tile's footprint: the pixel columns with a tap on one of its
    # froxel columns (no gap between them), the widest over the tiles
    tx = zg.K14_TILE[0]
    widths = []
    for x in range(0, w, tx):
        tile = set(range(x, min(x + tx, w)))
        js = [j for j, tp in enumerate(cols) if set(tp) & tile]
        assert js == list(range(js[0], js[-1] + 1))
        widths.append(len(js))
    assert fw == max(widths)


def _emulate_k14(grad_img, scene_color, view_depth, params, grid_whd, form):
    """K14 thread by thread in float32: a (froxel column, channel) sums,
    from +0, chunk by chunk of K14_ROWS footprint rows, a row's taps a that
    reach its row, the columns of its range, their taps b that reach its
    column, z0's term, then z1's (both into one sum at the far clamp)."""
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    table, _ = zg.grad_footprint(ih, iw, tuple(grid_whd), form)
    ry, rx = table[:4 * h].reshape(4, h), table[4 * h:].reshape(4, w)
    z0, _, f = zg._z_taps(params, view_depth, d)
    gv = zg._grad_of_v(grad_img, scene_color).numpy()
    z0, f = z0.numpy(), f.numpy()
    if form == "cells":
        py, px = ih // h, iw // w
        wts = zg.cell_taps(zg.cell_weights(py, px))[1]
        weight = lambda i, a, j, b: wts[(i % py) * px + j % px, 2 * a + b]
    else:
        yw, xw = zg.pixel_taps(ih, h)[1], zg.pixel_taps(iw, w)[1]
        weight = lambda i, a, j, b: np.float32(yw[a, i] * xw[b, j])
    one = np.float32(1.0)
    out = np.zeros((4, d, h, w), np.float32)
    tx_, ty_ = zg.K14_TILE
    for y0 in range(0, h, ty_):
        yl = min(y0 + ty_, h) - 1
        fy0 = min(ry[0, y0], ry[2, y0])
        fy1 = max(ry[1, yl], ry[3, yl])
        for y in range(y0, yl + 1):
            for x in range(w):
                cols = range(min(rx[0, x], rx[2, x]), max(rx[1, x], rx[3, x]))
                for c in range(4):
                    acc = np.zeros(d, np.float32)
                    for r0 in range(fy0, fy1, zg.K14_ROWS):
                        for i in range(r0, min(r0 + zg.K14_ROWS, fy1)):
                            for a in (0, 1):
                                if not ry[2 * a, y] <= i < ry[2 * a + 1, y]:
                                    continue
                                for j in cols:
                                    za = int(z0[i, j])
                                    zb = min(za + 1, d - 1)
                                    g, ff = np.float32(gv[c, i, j]), f[i, j]
                                    g0, g1 = g * (one - ff), g * ff
                                    for b in (0, 1):
                                        if not (rx[2 * b, x] <= j
                                                < rx[2 * b + 1, x]):
                                            continue
                                        wt = weight(i, a, j, b)
                                        if wt == 0:
                                            continue
                                        s0 = acc[za] + g0 * wt
                                        s1 = (s0 if zb == za else acc[zb]) \
                                            + g1 * wt
                                        acc[za], acc[zb] = s0, s1
                    out[c, :, y, x] = acc
    return out


@pytest.mark.parametrize("form,shape,grid", [
    ("cells", (16, 24), (8, 6, 4)), ("pixels", (21, 26), (8, 5, 6))])
def test_k14_gather_emulated_is_the_twin(form, shape, grid):
    args = _inputs(form, shape, grid, seed=3)
    twin = zg.composite_grad_plain(*args).numpy()
    got = _emulate_k14(*args)
    assert (np.abs(twin) > 0).mean() > 0.5
    assert (got.view(np.int32) == twin.view(np.int32)).all()


def _emulate_k15(grads, bin_idx, hit_k, offsets, max_px):
    """K15 as it runs: the int16 code plane of k15_code_shape (a pixel's
    bin * max_taps + hit, -1 off the plane or without a hit), then every
    thread of the launch grid, its two source pixels, walking the bins and
    their taps in order, one code compare a tap and the three cotangents
    read on a hit."""
    rows, counts = tssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)
    n_bins, max_taps = rows.shape[:2]
    oy_lo, oy_hi, ox_lo, ox_hi = tssr.tap_extent(offsets)
    hq, wq = bin_idx.shape
    hc, wc = tssr.k15_code_shape(hq, wq, oy_hi - oy_lo, ox_hi - ox_lo)
    bp, hp = bin_idx.numpy(), hit_k.numpy()
    codes = np.full((hc, wc), -1, np.int16)
    for r in range(hc):
        for c in range(wc):
            py, px = r - oy_hi, c - ox_hi
            if 0 <= py < hq and 0 <= px < wq:
                hit, bf = hp[py, px], bp[py, px]
                if 0 <= hit < max_taps and 0 <= bf < n_bins \
                        and bf == np.floor(bf):
                    codes[r, c] = int(bf) * max_taps + hit
    flat = codes.ravel()
    gs = [g.numpy().ravel() for g in grads]
    out = np.zeros((3, hq * wq), np.float32)
    tx, ty = tssr.K15_TILE
    for y in range(-(-hq // ty) * ty):
        for x in range(-(-wq // tx) * tx):
            cq, q = (y + oy_hi) * wc + x + ox_hi, y * wq + x
            acc = [np.float32(0.0)] * 3
            for b in range(n_bins):
                for k in range(counts[b]):
                    p = int(bits[b, k, 3])
                    oy, ox = (p & 0xfff) - 2048, ((p >> 12) & 0xfff) - 2048
                    at = cq - (oy * wc + ox)
                    assert 0 <= at < flat.size
                    if flat[at] == b * max_taps + k:
                        j = q - (oy * wq + ox)
                        acc = [a + g[j] for a, g in zip(acc, gs)]
            if y < hq and x < wq:
                out[:, q] = acc
    return out.reshape(3, hq, wq)


@pytest.mark.parametrize("seed,hq,wq", [(0, 20, 28), (1, 9, 40)])
def test_k15_code_plane_gather_emulated_is_the_twin(seed, hq, wq):
    """Seeded bins (integers, a non-integer and NaN among them) and hit
    records (-1, in range, and past a bin's taps) under a table of 4 bins
    whose offsets reach past the planes' edges."""
    rng = np.random.default_rng(seed)
    offsets = tuple(tuple((0.0, 1.0, int(t * dy), int(t * dx))
                          for t in (1, 2, 5, 9)[:n])
                    for (dy, dx), n in zip(((0, 1), (1, 0), (-1, -1),
                                            (1, -2)), (4, 3, 4, 2)))
    bins = rng.integers(0, 4, (hq, wq)).astype(np.float32)
    bins[rng.random((hq, wq)) < 0.05] = 1.5
    bins[rng.random((hq, wq)) < 0.05] = np.nan
    hits = rng.integers(-1, 5, (hq, wq)).astype(np.int32)
    cots = [torch.as_tensor(np.where(rng.random((hq, wq)) < 0.1, -0.0,
                                     rng.normal(size=(hq, wq)))
                            .astype(np.float32)) for _ in range(3)]
    bin_t, hit_t = torch.as_tensor(bins), torch.as_tensor(hits)
    twin = torch.stack(tssr.ssr_march_grad_plain(cots, bin_t, hit_t,
                                                 offsets)).numpy()
    got = _emulate_k15(cots, bin_t, hit_t, offsets, 20.0)
    assert (np.abs(twin) > 0).mean() > 0.05
    assert (got.view(np.int32) == twin.view(np.int32)).all()


def test_refusals_before_a_launch():
    """K14 past the shared memory a block may take (its d sums) and K15's
    table past 48 KB are refused by name before any launch (meta
    tensors)."""
    params = tfroxel.make_froxel_params(torch.tensor(FOV), torch.tensor(1.5),
                                        torch.tensor(NEAR), 100.0, 0.5,
                                        (16, 11, 1024))
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(NotImplementedError, match="K14"):
        zg.composite_grad(meta(88, 128, 4), meta(88, 128, 3), meta(88, 128),
                          params, (16, 11, 1024), "pixels")
    offsets = tuple(tuple((0.0, 1.0, 0, k + 1) for k in range(32))
                    for _ in range(200))
    planes = [meta(30, 40) for _ in range(4)]
    with pytest.raises(NotImplementedError, match="K15"):
        tssr.ssr_march_grad(planes[:3], planes[3],
                            torch.empty((30, 40), dtype=torch.int32,
                                        device="meta"), offsets, 56.0)


@pytest.mark.parametrize("d,form,ih,iw,grid,fw,shared", [
    (64, "pixels", 720, 1280, (160, 88, 64), 72, 30800),
    (64, "cells", 704, 1280, (160, 88, 64), 72, 30800),
    (128, "cells", 1080, 1920, (240, 135, 128), 72, 47184)])
def test_k14_launch(d, form, ih, iw, grid, fw, shared):
    """K14's 8 x 2 column tiles of 64 threads, 8 pixel rows a chunk, and a
    block's shared memory at the training grids (chip_smoke.K14_FORMS)."""
    assert (zg.K14_TILE, zg.K14_THREADS, zg.K14_ROWS) == ((8, 2), 64, 8)
    assert zg.grad_footprint(ih, iw, grid, form)[1] == fw
    assert zg.k14_shared_bytes(d, fw) == shared


@pytest.mark.parametrize("hq,wq,n_bins,max_taps,span,shared,plane", [
    (270, 480, 8, 12, (112, 112), 800, (384, 592)),
    (270, 480, 16, 20, (112, 112), 2624, (384, 592)),
    (33, 65, 1, 1, (0, 0), 12, (48, 96))])
def test_k15_launch(hq, wq, n_bins, max_taps, span, shared, plane):
    """K15's 32 x 16-pixel tiles, its table's shared bytes and its code
    plane: the planes rounded up to whole tiles, grown by the offsets'
    span."""
    assert tssr.K15_TILE == (32, 16)
    assert tssr.k15_shared_bytes(n_bins, max_taps) == shared
    assert tssr.k15_code_shape(hq, wq, *span) == plane
