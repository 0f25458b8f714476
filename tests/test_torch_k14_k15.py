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
  * K14's chunked form (its slices in chunks, one a grid z index)
    emulated likewise, equal to the twin bit for bit, and its chunk plan
    (zg_composite.k14_chunks): the chunks cover [0, d) once, each fits, no
    fewer fit, one launch where all d slices fit;
  * K15's forms (ssr.k15_form: the offsets in static or opted-in shared
    memory or in device memory, int16 or int32 codes), its gather emulated
    with int32 codes;
  * the wrappers before a launch (meta tensors): K14 past the shared memory
    a block may take and K15's table past 48 KB now reach the device check
    in their chunked and opted-in forms; a forced form or chunk count that
    cannot take the table is refused by name;
  * each wrapper's launch on meta tensors (the device check and the
    launch stubbed): it names its kernel's one entry point, with as many
    arguments as cuda._declare gives that entry (less the stream), and
    the size rule's form (-1, or K15's mirrored form, or K14's 0) or the
    forced one;
  * the launch mirrors K14_TILE, k14_shared_bytes, K15_TILE,
    k15_shared_bytes and k15_code_shape at the shapes the paths use
    (chip_smoke.py holds them against the kernels' own on the card).
"""

import numpy as np
import pytest
import torch

from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.ops import cuda
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


def _emulate_k14(grad_img, scene_color, view_depth, params, grid_whd, form,
                 zc=None):
    """K14 thread by thread in float32: a (froxel column, channel) sums,
    from +0, chunk by chunk of K14_ROWS footprint rows, a row's taps a that
    reach its row, the columns of its range, their taps b that reach its
    column, z0's term, then z1's (both into one sum at the far clamp). zc:
    the chunked form, a block per chunk of zc slices, adding only the
    terms whose slice lies in its chunk."""
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
    zc = zc or d
    for y0, z_lo in ((y0, z_lo) for y0 in range(0, h, ty_)
                     for z_lo in range(0, d, zc)):
        yl = min(y0 + ty_, h) - 1
        fy0 = min(ry[0, y0], ry[2, y0])
        fy1 = max(ry[1, yl], ry[3, yl])
        chunk = range(z_lo, min(z_lo + zc, d))
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
                                        if za in chunk:
                                            acc[za] = acc[za] + g0 * wt
                                        if zb in chunk:
                                            acc[zb] = acc[zb] + g1 * wt
                    out[c, chunk, y, x] = acc[chunk]
    return out


@pytest.mark.parametrize("form,shape,grid", [
    ("cells", (16, 24), (8, 6, 4)), ("pixels", (21, 26), (8, 5, 6))])
def test_k14_gather_emulated_is_the_twin(form, shape, grid):
    args = _inputs(form, shape, grid, seed=3)
    twin = zg.composite_grad_plain(*args).numpy()
    got = _emulate_k14(*args)
    assert (np.abs(twin) > 0).mean() > 0.5
    assert (got.view(np.int32) == twin.view(np.int32)).all()


@pytest.mark.parametrize("form,shape,grid,chunks", [
    ("cells", (16, 24), (8, 6, 5), 2), ("pixels", (21, 26), (8, 5, 6), 4)])
def test_k14_chunked_gather_emulated_is_the_twin(form, shape, grid, chunks):
    """The chunked form (forced: 3 + 2 slices, and 2 + 2 + 2) is the twin
    bit for bit: a froxel lies in one chunk, which adds its terms in the
    one-launch form's order; z0 and z1 of a pixel fall in two chunks."""
    args = _inputs(form, shape, grid, seed=4)
    fw = zg.grad_footprint(*shape, grid, form)[1]
    n, zc = zg.k14_chunks(grid[2], fw, chunks)
    assert n == -(-grid[2] // zc) > 1
    twin = zg.composite_grad_plain(*args).numpy()
    got = _emulate_k14(*args, zc=zc)
    assert (got.view(np.int32) == twin.view(np.int32)).all()


@pytest.mark.parametrize("ih,iw,grid,form", [
    (720, 1280, (160, 88), "pixels"), (1080, 1920, (240, 135), "cells")])
@pytest.mark.parametrize("d", [64, 128, 830, 1024, 4096])
def test_k14_chunk_plan(ih, iw, grid, form, d):
    """k14_chunks at the 720p and 1080p footprints: one launch where all d
    slices fit a block, else chunks that cover [0, d) exactly once, each
    fitting K14_MAX_SHARED, and no fewer that would."""
    fw = zg.grad_footprint(ih, iw, (*grid, d), form)[1]
    n, zc = zg.k14_chunks(d, fw)
    fits = lambda s: zg.k14_shared_bytes(s, fw) <= zg.K14_MAX_SHARED
    if fits(d):
        assert (n, zc) == (1, d)
    covered = [z for k in range(n) for z in range(k * zc, min(k * zc + zc,
                                                              d))]
    assert covered == list(range(d))
    assert fits(zc) and n == -(-d // zc)
    if n > 1:
        assert not fits(-(-d // (n - 1)))
    # a forced count keeps the same rule; one that cannot fit is refused
    assert zg.k14_chunks(d, fw, n) == (n, zc)
    if not fits(d):
        with pytest.raises(ValueError, match="K14"):
            zg.k14_chunks(d, fw, 1)


def _emulate_k15(grads, bin_idx, hit_k, offsets, max_px, dtype=np.int16):
    """K15 as it runs: the code plane of k15_code_shape (int16, or int32 in
    the global_wide form: a pixel's bin * max_taps + hit, -1 off the plane or
    without a hit), then every thread of the launch grid, its two source
    pixels, walking the bins and their taps in order, one code compare a
    tap and the three cotangents read on a hit."""
    rows, counts = tssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)
    n_bins, max_taps = rows.shape[:2]
    oy_lo, oy_hi, ox_lo, ox_hi = tssr.tap_extent(offsets)
    hq, wq = bin_idx.shape
    hc, wc = tssr.k15_code_shape(hq, wq, oy_hi - oy_lo, ox_hi - ox_lo)
    bp, hp = bin_idx.numpy(), hit_k.numpy()
    codes = np.full((hc, wc), -1, dtype)
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


@pytest.mark.parametrize("seed,hq,wq,dtype", [(0, 20, 28, np.int16),
                                              (1, 9, 40, np.int16),
                                              (2, 20, 28, np.int32)])
def test_k15_code_plane_gather_emulated_is_the_twin(seed, hq, wq, dtype):
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
    got = _emulate_k15(cots, bin_t, hit_t, offsets, 20.0, dtype)
    assert (np.abs(twin) > 0).mean() > 0.05
    assert (got.view(np.int32) == twin.view(np.int32)).all()


def test_refusals_before_a_launch():
    """K14 past the shared memory a block may take at 1024 slices (its d
    sums) and K15's table past 48 KB are no longer refused: K14 plans two
    chunks of 512 slices, K15 takes opted-in shared memory, and both
    wrappers reach the device check (meta tensors). A forced chunk count
    or form that cannot take them is refused by name before any launch."""
    params = tfroxel.make_froxel_params(torch.tensor(FOV), torch.tensor(1.5),
                                        torch.tensor(NEAR), 100.0, 0.5,
                                        (16, 11, 1024))
    meta = lambda *s: torch.empty(s, device="meta")
    fw = zg.grad_footprint(88, 128, (16, 11, 1024), "pixels")[1]
    assert zg.k14_shared_bytes(1024, fw) > zg.K14_MAX_SHARED
    assert zg.k14_chunks(1024, fw) == (2, 512)
    k14_args = (meta(88, 128, 4), meta(88, 128, 3), meta(88, 128), params,
                (16, 11, 1024), "pixels")
    with pytest.raises(ValueError, match="CUDA"):
        zg.composite_grad(*k14_args)
    with pytest.raises(ValueError, match="K14"):
        zg.composite_grad(*k14_args, chunks=1)
    offsets = tuple(tuple((0.0, 1.0, 0, k + 1) for k in range(32))
                    for _ in range(200))
    assert tssr.k15_shared_bytes(200, 32) > tssr.K15_MAX_SHARED
    assert tssr.k15_form(200, 32) == "optin"
    planes = [meta(30, 40) for _ in range(4)]
    k15_args = (planes[:3], planes[3],
                torch.empty((30, 40), dtype=torch.int32, device="meta"),
                offsets, 56.0)
    with pytest.raises(ValueError, match="CUDA"):
        tssr.ssr_march_grad(*k15_args)
    with pytest.raises(ValueError, match="K15 form 'fixed'"):
        tssr.ssr_march_grad(*k15_args, form="fixed")


# (bins, taps a bin) -> K15's form by the size rule: the tables of the
# default, 64 / 16, 96 / 64 and 96 / 128 (ssr_steps / ssr_dirs), the edge
# of opted-in shared memory and past it, and past 32,767 bins x taps
K15_FORM_CASES = [
    (8, 12, "fixed"), (16, 39, "fixed"), (64, 54, "fixed"),
    (128, 54, "optin"), (451, 32, "optin"), (500, 65, "global"),
    (600, 56, "global_wide")]


@pytest.mark.parametrize("n_bins,max_taps,form", K15_FORM_CASES)
def test_k15_form(n_bins, max_taps, form):
    """The wrappers' mirror of K15's size rule and the forms that can be
    forced on the same table: a shared form where its bytes fit, the int16
    codes up to 32,767 bins x taps, the int32 ones always."""
    assert tssr.k15_form(n_bins, max_taps) == form
    smem = tssr.k15_shared_bytes(n_bins, max_taps)
    narrow = n_bins * max_taps <= 32767
    fits = {"fixed": narrow and smem <= 48 * 1024,
            "optin": narrow and smem <= 232448, "global": narrow,
            "global_wide": True}
    assert tuple(fits) == tssr.K15_FORMS
    for f, ok in fits.items():
        if ok:
            assert tssr.k15_form(n_bins, max_taps, f) == f
        else:
            with pytest.raises(ValueError, match="K15 form"):
                tssr.k15_form(n_bins, max_taps, f)


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


class _Library:
    """A stand-in for a kernel's loaded library: any entry point, which
    keeps the argument types cuda._declare gives it."""

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("kernel,forced,form_arg", [
    ("ssr_march", None, -1), ("ssr_march", "gen_global", 2),
    ("ssr_march_record", None, -1), ("ssr_march_record", "gen", 1),
    ("ssr_march_grad", None, 0), ("ssr_march_grad", "global_wide", 3),
    ("composite_grad", None, 0), ("composite_grad", 2, 32)])
def test_wrappers_launch_their_one_entry_point(kernel, forced, form_arg,
                                               monkeypatch):
    """K13 (without and with its hit record), K15 and K14 as their
    wrappers launch them: the source's one form-taking entry point, its
    declared argument count, the form or chunk argument in its place, and
    K15's code plane of the width its form reads."""
    calls = []
    monkeypatch.setattr(cuda, "check_cuda", lambda *t, **kw: None)
    monkeypatch.setattr(cuda, "ptr", lambda t: t)
    monkeypatch.setattr(cuda, "launch", lambda name, *args, entry="":
                        calls.append((name, entry, args)))
    meta = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype,
                                                       device="meta")
    offsets = tuple(tuple((0.0, 1.0, 0, k + 1) for k in range(12))
                    for _ in range(8))
    planes = [meta(30, 40) for _ in range(8)]
    if kernel.startswith("ssr_march") and kernel != "ssr_march_grad":
        record = kernel == "ssr_march_record"
        tssr.ssr_march(planes[0], planes[1:4], *planes[4:], offsets, 0.6,
                       56.0, record=record, form=forced)
        name, entry, args = calls[0]
        assert (args[20] is None) == (not record)
        where = 21
    elif kernel == "ssr_march_grad":
        tssr.ssr_march_grad(planes[:3], planes[3], meta(30, 40,
                                                        dtype=torch.int32),
                            offsets, 56.0, form=forced)
        name, entry, args = calls[0]
        assert args[15].dtype == (torch.int32 if forced == "global_wide"
                                  else torch.int16)
        where = 16
    else:
        grid = (16, 11, 64)
        params = tfroxel.make_froxel_params(torch.tensor(FOV),
                                            torch.tensor(1.5),
                                            torch.tensor(NEAR), 100.0, 0.5,
                                            grid)
        zg.composite_grad(meta(88, 128, 4), meta(88, 128, 3), meta(88, 128),
                          params, grid, "pixels", chunks=forced)
        name, entry, args = calls[0]
        where = 14
    lib = _Library()
    cuda._declare(lib, name)
    assert entry == {"ssr_march": "vr_ssr_march_form",
                     "ssr_march_grad": "vr_ssr_march_grad_form",
                     "composite_grad": "vr_composite_grad_chunks"}[name]
    assert len(args) + 1 == len(getattr(lib, entry).argtypes)
    assert args[where] == form_arg
