"""The exact-f32 trilinear composite: rgb = scene * T + L, a = T.

Port of `volumetricrenderer_tpu/ops/pallas/zg_composite.py`
`composite_zgather` and `composite_zgather_planes` (the zgather branches of
`pipeline.composite`). Per pixel: fz = depth_to_froxel_z(depth) - 0.5
clipped to [0, d-1], the two z taps floor(fz) and min(floor(fz) + 1, d - 1),
and the xy taps of the pixel's cell and its clamped neighbours weighted by
the static in-cell bilinear weights (pixel -> froxel coordinate (i + 0.5) *
W / IW - 0.5, clamp to edge). The TPU kernel's padded planes, cells-as-rows
transpose, 8x8 sub-images and unshuffle are layout workarounds and do not
exist here: any multiple-of-8 cell is one kernel. At most 2x2 of a pixel's
nine weights are non-zero; K4 reads those four and their first tap per
in-cell position from a table made on the host (`cell_taps`), and its twin
adds all nine (the zero weights add nothing: the same sums).

`composite` launches the CUDA kernel K4 (csrc/composite.cu) for CUDA tensors
and runs its twin `composite_plain` for CPU tensors; `composite_planes` is
K4 without a scene colour. `composite_cosited` is the JAX package's
fractional-resolution composite (composite_upsample > 1): K4's planes at
the low resolution on co-sited pixels, then a plain bilinear upsample and
the scene blend at full resolution, as JAX runs both in XLA.
`composite_pixels` is K4's per-pixel form for any pixel/froxel ratio (JAX
`composite_rowmm`, `composite_anyres` and the "xla" gather, which differ
only in their TPU layouts): per row and column the first tap and the two
weights of (i + 0.5) * H / IH - 0.5, worked out in float64 on the host
(`pixel_taps`), taps clamped to the volume. `composite_frame` picks the
form as JAX's `pipeline.composite` picks its branch
(config.composite_route).

A slab of an H-sharded frame (parallel/shard_render.py) composites its band
of the image from its halo-extended accumulation: in the cells form with a
row offset (`composite(..., row_off=halo)`, JAX `composite_zgather` with
`halo_rows` or `prepadded` at `row_off`), whose cell rows read the
neighbouring shards' real rows where the whole grid clamps, or in the
per-pixel form on the slab's rows of the global mapping
(`composite_pixels(..., y_map=(H, IH, halo))`, JAX `composite_rowmm(fy=...,
row_off=0)`), as config.slab_composite_route picks.

The gradient: under grad (acc or the scene colour requires it) a CUDA call
of `composite` or `composite_pixels` on the whole grid goes through
`CompositeFn`, which launches K4 forward and K14 (`composite_grad`,
csrc/composite_grad.cu) backward, K14 the exact adjoint of the form's
taps as a gather: each froxel sums its terms in one fixed order (pixel rows
and their taps, then pixel columns and theirs), with no atomics, and its twin
`composite_grad_plain` adds the same terms in the same order, so the two
agree bit for bit and every run gives the same bits. On the CPU autograd
differentiates the twins. What the JAX
package does not differentiate raises under grad: a view depth that
requires grad, a slab's forms and the planes of the co-sited composite.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel
from volumetricrenderer_tpu_torch.config import (RenderConfig,
                                                 composite_route,
                                                 slab_composite_route)
from volumetricrenderer_tpu_torch.ops import cuda


@functools.lru_cache(maxsize=8)
def cell_weights(py: int, px: int, us: int = 1) -> np.ndarray:
    """[9, py*px] float32 bilinear weights of the 3x3 cell neighbours
    (dy, dx in -1, 0, 1) for each pixel in a cell. us = 1: at the pixel
    centres, in-cell offsets (i + 0.5)/p - 0.5 from the cell centre. us > 1:
    for the co-sited composite's low-res pixels, each standing for full-res
    pixel us*i, at (us*i + 0.5)/(us*p) - 0.5 (JAX `_cell_weights_at`, the
    w9_override of pipeline.composite)."""
    fy = (us * np.arange(py) + 0.5) / (us * py) - 0.5
    fx = (us * np.arange(px) + 0.5) / (us * px) - 0.5
    out = np.zeros((3, 3, py, px), np.float32)
    for d in (-1, 0, 1):
        wy = np.maximum(0.0, 1.0 - np.abs(fy - d))
        for e in (-1, 0, 1):
            wx = np.maximum(0.0, 1.0 - np.abs(fx - e))
            out[d + 1, e + 1] = np.outer(wy, wx)
    return out.reshape(9, py * px)


def cell_taps(w9: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """K4's 2x2 form of a [9, py*px] cell-weight table: per in-cell position
    its first tap (dy0, dx0) [py*px, 2] int32 and the four weights
    w9[(dy0 + a) * 3 + dx0 + b], a, b in (0, 1), [py*px, 4] float32, copied
    bit for bit. Every position's non-zero weights must lie in one 2x2
    window of the 3x3 neighbours, as they do for in-cell offsets in (-0.5,
    0.5) (cell_weights at any us); raises on more than 2 non-zero taps on
    either axis."""
    w = np.ascontiguousarray(w9, np.float32).reshape(3, 3, -1)
    nz = w != 0.0

    def first(hit):             # [3, cp] -> the window's first tap
        lo = np.argmax(hit, axis=0)
        hi = 2 - np.argmax(hit[::-1], axis=0)
        if (hit.any(axis=0) & (hi - lo > 1)).any():
            raise ValueError("cell weights with more than 2 non-zero taps "
                             "on an axis")
        return np.minimum(lo, 1)

    dy0, dx0 = first(nz.any(axis=1)), first(nz.any(axis=0))
    cp, ab = w.shape[2], np.arange(2)
    wts = w[dy0[:, None, None] + ab[None, :, None],
            dx0[:, None, None] + ab[None, None, :],
            np.arange(cp)[:, None, None]]
    return (np.stack([dy0, dx0], axis=1).astype(np.int32),
            wts.reshape(cp, 4))


@functools.lru_cache(maxsize=8)
def _device_cell_taps(data: bytes, cp: int, device: torch.device):
    """cell_taps of a weight table on the card, uploaded once per table and
    device."""
    first, wts = cell_taps(np.frombuffer(data, np.float32).reshape(9, cp))
    return cuda.upload(first, device, torch.int32), cuda.upload(wts, device)


def _check(acc, view_depth, grid_whd, w9, row_off=0) -> np.ndarray:
    """Validate the shapes; returns the weight table [9, py*px]. The cells
    of grid_whd's h rows read acc rows [row_off - 1, row_off + h]: acc has
    exactly h rows at row_off 0 (edge-clamped), else all of those rows."""
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    h_acc = acc.shape[2] if acc.dim() == 4 else -1
    rows_ok = h_acc == h if row_off == 0 \
        else row_off >= 1 and row_off + h + 1 <= h_acc
    if (acc.shape != (4, d, h_acc, w) or not rows_ok or ih % h
            or iw % w):
        raise ValueError(f"composite shapes: acc {tuple(acc.shape)}, depth "
                         f"{(ih, iw)}, grid {grid_whd}, row_off {row_off}")
    py, px = ih // h, iw // w
    w9 = cell_weights(py, px) if w9 is None \
        else np.ascontiguousarray(w9, np.float32)
    if w9.shape != (9, py * px):
        raise ValueError(f"cell weights {w9.shape} for {py}x{px} cells")
    return w9


def _z_taps(params, view_depth, d: int):
    """The two z taps (long [IH, IW]) and the lerp weight f of each pixel:
    fz = depth_to_froxel_z(depth) - 0.5 clipped to [0, d - 1], z0 =
    floor(fz), z1 = min(z0 + 1, d - 1) (K4's and K14's depth_taps)."""
    fz = froxel.depth_to_froxel_z(params, view_depth) - 0.5
    fz = torch.clamp(fz, 0.0, d - 1.0)
    z0f = torch.floor(fz)
    f = fz - z0f
    z0 = torch.clamp(z0f.to(torch.long), 0, d - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    return z0, z1, f


def _cell_taps_plain(shape, grid_whd, w9, h_acc, row_off, dev):
    """The cells form's xy taps in K4's order: (yy [IH, 1], xx [1, IW],
    weight [IH, IW]) of the 3x3 cell neighbours, dy outer; cell row cy
    reads acc rows cy + row_off + dy - 1, clamped to acc's h_acc rows. The
    zero weights are kept: they add nothing."""
    w, h, _ = grid_whd
    ih, iw = shape
    py, px = ih // h, iw // w
    rows = torch.arange(ih, device=dev)
    cols = torch.arange(iw, device=dev)
    cell = ((rows % py)[:, None] * px + (cols % px)[None, :])
    w9 = torch.as_tensor(w9, device=dev)
    for dy in range(3):
        yy = torch.clamp(rows // py + row_off + dy - 1, 0,
                         h_acc - 1)[:, None]
        for dx in range(3):
            xx = torch.clamp(cols // px + dx - 1, 0, w - 1)[None, :]
            yield yy, xx, w9[dy * 3 + dx][cell]


def _pixel_taps_plain(shape, grid_whd, y_map, dev):
    """The per-pixel form's xy taps in K4's order: (yy [IH, 1], xx [1, IW],
    weight [IH, IW]) of pixel_taps' two rows and two columns, y outer,
    clamped to the volume."""
    w, h, _ = grid_whd
    ih, iw = shape
    (yk, yw) = pixel_taps(ih, *_y_map(y_map, h, ih))
    (xk, xw) = pixel_taps(iw, w)
    yk = torch.as_tensor(yk, device=dev).long()
    xk = torch.as_tensor(xk, device=dev).long()
    yw, xw = torch.as_tensor(yw, device=dev), torch.as_tensor(xw, device=dev)
    for a in range(2):
        yy = torch.clamp(yk + a, 0, h - 1)[:, None]
        for b in range(2):
            xx = torch.clamp(xk + b, 0, w - 1)[None, :]
            yield yy, xx, yw[a][:, None] * xw[b][None, :]


def _trilinear(acc, z_taps, taps) -> torch.Tensor:
    """(L_r, L_g, L_b, T) [4, IH, IW]: each xy tap's weight times acc at
    both z taps, summed in tap order, then lerped in z."""
    z0, z1, f = z_taps
    s0 = torch.zeros((4, *z0.shape), dtype=torch.float32, device=acc.device)
    s1 = torch.zeros_like(s0)
    for yy, xx, wt in taps:
        s0 = s0 + acc[:, z0, yy, xx] * wt
        s1 = s1 + acc[:, z1, yy, xx] * wt
    return s0 * (1.0 - f) + s1 * f


def _sample_plain(acc, view_depth, params, grid_whd, w9,
                  row_off=0) -> torch.Tensor:
    """The trilinear (L_r, L_g, L_b, T) at every pixel: [4, IH, IW]; cell
    row cy reads acc rows cy + row_off + dy - 1, clamped to acc's rows."""
    return _trilinear(acc, _z_taps(params, view_depth, grid_whd[2]),
                      _cell_taps_plain(view_depth.shape, grid_whd, w9,
                                       acc.shape[2], row_off, acc.device))


def _blend(v: torch.Tensor, scene_color: torch.Tensor) -> torch.Tensor:
    """[4, IH, IW] planes over the scene [IH, IW, 3] -> rgba [IH, IW, 4]."""
    rgb = scene_color * v[3][..., None] + v[:3].permute(1, 2, 0)
    return torch.cat([rgb, v[3][..., None]], dim=-1)


def composite_plain(acc: torch.Tensor, scene_color: torch.Tensor,
                    view_depth: torch.Tensor, params,
                    grid_whd: Tuple[int, int, int],
                    row_off: int = 0) -> torch.Tensor:
    """Twin of K4. acc [4, D, H, W], scene_color [IH, IW, 3], view_depth
    [IH, IW] -> image [IH, IW, 4]; with row_off, acc is a slab's
    halo-extended [4, D, H_ext, W] and grid_whd's h the band's cell rows
    (composite)."""
    w9 = _check(acc, view_depth, grid_whd, None, row_off)
    return _blend(_sample_plain(acc, view_depth, params, grid_whd, w9,
                                row_off), scene_color)


def composite_planes_plain(acc: torch.Tensor, view_depth: torch.Tensor,
                           params, grid_whd: Tuple[int, int, int],
                           w9: Optional[np.ndarray] = None) -> torch.Tensor:
    """Twin of K4 without a scene colour: planes [4, IH, IW]."""
    w9 = _check(acc, view_depth, grid_whd, w9)
    return _sample_plain(acc, view_depth, params, grid_whd, w9)


def _launch(acc, scene_color, view_depth, params, grid_whd, w9, out,
            row_off=0):
    cuda.check_cuda(acc, view_depth,
                    *(() if scene_color is None else (scene_color,)))
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    dev = acc.device
    first, wts = _device_cell_taps(w9.tobytes(), w9.shape[1], dev)
    fp = froxel.depth_params(params).to(dev)
    cuda.launch("composite", cuda.ptr(acc),
                None if scene_color is None else cuda.ptr(scene_color),
                cuda.ptr(view_depth), cuda.ptr(first), cuda.ptr(wts),
                cuda.ptr(fp), w, h, d, ih, iw, acc.shape[2], row_off,
                cuda.ptr(out))
    return out


def composite(acc: torch.Tensor, scene_color: torch.Tensor,
              view_depth: torch.Tensor, params,
              grid_whd: Tuple[int, int, int],
              row_off: int = 0) -> torch.Tensor:
    """K4: the composited image [IH, IW, 4] (the cell weights of the pixel
    centres). row_off > 0: acc is a slab's halo-extended accumulation
    [4, D, H_ext, W] and the image the slab's band of grid_whd's h cell
    rows, whose cell row cy reads acc rows cy + row_off + dy - 1 -- real
    neighbour rows where the whole grid clamps (JAX composite_zgather with
    halo_rows, or prepadded at row_off). Under grad (acc or scene_color
    requires it) a CUDA call goes through CompositeFn: K4 forward, K14
    backward; a slab's band raises there."""
    w9 = _check(acc, view_depth, grid_whd, None, row_off)
    if scene_color.shape != (*view_depth.shape, 3):
        raise ValueError(f"scene colour {tuple(scene_color.shape)} for "
                         f"depth {tuple(view_depth.shape)}")
    grad = _needs_grad(acc, scene_color, view_depth,
                       "a slab's cells composite (JAX composite_zgather)"
                       if row_off else None)
    if acc.device.type == "cpu":
        return composite_plain(acc, scene_color, view_depth, params,
                               grid_whd, row_off)
    if grad:
        return CompositeFn.apply(acc, scene_color, view_depth, params,
                                 grid_whd, "cells")
    out = torch.empty((*view_depth.shape, 4), dtype=torch.float32,
                      device=acc.device)
    return _launch(acc, scene_color, view_depth, params, grid_whd, w9, out,
                   row_off)


def composite_planes(acc: torch.Tensor, view_depth: torch.Tensor, params,
                     grid_whd: Tuple[int, int, int],
                     w9: Optional[np.ndarray] = None) -> torch.Tensor:
    """K4 without a scene colour: the sampled planes (L_r, L_g, L_b, T)
    [4, IH, IW], as `composite_zgather_planes` returns them. w9: the
    [9, py*px] cell weights (its w9_override), those of the pixel centres
    when None. Raises under grad: JAX takes composite_zgather_planes."""
    _needs_grad(acc, None, view_depth,
                "the composite's planes (JAX composite_zgather_planes)")
    if acc.device.type == "cpu":
        return composite_planes_plain(acc, view_depth, params, grid_whd, w9)
    w9 = _check(acc, view_depth, grid_whd, w9)
    out = torch.empty((4, *view_depth.shape), dtype=torch.float32,
                      device=acc.device)
    return _launch(acc, None, view_depth, params, grid_whd, w9, out)


def upsample_cosited(p: torch.Tensor, us: int) -> torch.Tensor:
    """[..., h, w] -> [..., us*h, us*w] co-sited bilinear upsample (JAX
    pipeline._upsample_cosited): low sample i sits at full index us*i, so
    out[us*i + k] = p[i] + (k/us) * (p[i+1] - p[i]), edge-clamped; rows
    first, then columns. Phase 0 is p + 0 * (...), p itself."""
    def rows(q):
        nxt = torch.cat([q[..., 1:, :], q[..., -1:, :]], dim=-2)
        out = torch.stack([q + (k / us) * (nxt - q) for k in range(us)],
                          dim=-2)
        return out.reshape(*q.shape[:-2], q.shape[-2] * us, q.shape[-1])
    return rows(rows(p).transpose(-1, -2)).transpose(-1, -2)


def composite_cosited(acc: torch.Tensor, scene_color: torch.Tensor,
                      view_depth: torch.Tensor, params,
                      grid_whd: Tuple[int, int, int], us: int
                      ) -> torch.Tensor:
    """The fractional-resolution composite (JAX pipeline.composite with
    composite_upsample = us > 1): K4's planes at 1/us of the image on the
    pixels co-sited with full-res pixel (us*i, us*j) -- their depth, their
    in-cell weights -- upsampled bilinearly, then rgb = scene * T + L at
    full resolution. Every us-th pixel of each axis equals the exact
    composite. Returns [IH, IW, 4]; raises under grad (JAX takes
    composite_zgather_planes)."""
    ih, iw = view_depth.shape
    w, h, _ = grid_whd
    if ih % us or iw % us or (ih // us) % h or (iw // us) % w:
        raise ValueError(f"co-sited composite: image {(ih, iw)} at 1/{us} "
                         f"on grid {grid_whd}")
    lo = view_depth[::us, ::us].contiguous()
    w9 = cell_weights((ih // us) // h, (iw // us) // w, us)
    up = upsample_cosited(composite_planes(acc, lo, params, grid_whd, w9), us)
    return _blend(up, scene_color)


@functools.lru_cache(maxsize=16)
def pixel_taps(n: int, cells: int, total: Optional[int] = None,
               offset: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Along one image axis of n pixels over `cells` froxels: each pixel's
    first tap k0 = floor(f) (int32; -1 at the top or left edge) and the
    weights (1 - t, t) [2, n] float32 of taps k0, k0 + 1, for f = (i + 0.5)
    * cells / n - 0.5 and t = f - k0 in float64 (JAX rowmm's fy). A slab's
    band of n rows takes the global ratio cells / total (total: the whole
    image's rows, cells the global grid's) and reads its halo-extended
    volume `offset` rows down: f = (i + 0.5) * cells / total - 0.5 + offset
    (JAX pipeline.composite's slab fy at row_off 0)."""
    f = (np.arange(n) + 0.5) * (cells / (total or n)) - 0.5 + offset
    k0 = np.floor(f)
    t = f - k0
    return k0.astype(np.int32), np.stack([1.0 - t, t]).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_taps(ih: int, iw: int, y_map: Tuple[int, int, int], w: int,
                 device: torch.device):
    """(yk, yw, xk, xw) of pixel_taps on the card, uploaded once per shape,
    row mapping and device."""
    yk, yw = pixel_taps(ih, *y_map)
    xk, xw = pixel_taps(iw, w)
    k = cuda.upload(np.concatenate([yk, xk]), device, torch.int32)
    wt = cuda.upload(np.concatenate([yw.ravel(), xw.ravel()]), device)
    return k[:ih], wt[:2 * ih], k[ih:], wt[2 * ih:]


def _check_pixels(acc, view_depth, grid_whd) -> None:
    w, h, d = grid_whd
    if acc.shape != (4, d, h, w) or view_depth.dim() != 2:
        raise ValueError(f"composite shapes: acc {tuple(acc.shape)}, depth "
                         f"{tuple(view_depth.shape)}, grid {grid_whd}")


def _y_map(y_map, h: int, ih: int) -> Tuple[int, int, int]:
    """pixel_taps' (cells, total, offset) of the rows: the whole image's
    (h, ih, 0) by default."""
    return (h, ih, 0) if y_map is None else tuple(int(v) for v in y_map)


def composite_pixels_plain(acc: torch.Tensor, scene_color: torch.Tensor,
                           view_depth: torch.Tensor, params,
                           grid_whd: Tuple[int, int, int],
                           y_map: Optional[Tuple[int, int, int]] = None
                           ) -> torch.Tensor:
    """Twin of K4's per-pixel form: image [IH, IW, 4] at any image size."""
    _check_pixels(acc, view_depth, grid_whd)
    v = _trilinear(acc, _z_taps(params, view_depth, grid_whd[2]),
                   _pixel_taps_plain(view_depth.shape, grid_whd, y_map,
                                     acc.device))
    return _blend(v, scene_color)


def composite_pixels(acc: torch.Tensor, scene_color: torch.Tensor,
                     view_depth: torch.Tensor, params,
                     grid_whd: Tuple[int, int, int],
                     y_map: Optional[Tuple[int, int, int]] = None
                     ) -> torch.Tensor:
    """K4's per-pixel form: the composited image [IH, IW, 4] at any
    pixel/froxel ratio. y_map = (cells, total, offset) maps the rows as
    pixel_taps does: a slab's band passes (H_glob, IH_glob, halo) with its
    halo-extended acc; None maps the whole image on grid_whd's rows."""
    _check_pixels(acc, view_depth, grid_whd)
    if scene_color.shape != (*view_depth.shape, 3):
        raise ValueError(f"scene colour {tuple(scene_color.shape)} for "
                         f"depth {tuple(view_depth.shape)}")
    grad = _needs_grad(acc, scene_color, view_depth,
                       None if y_map is None else
                       "a slab's per-pixel composite (JAX composite_rowmm "
                       "with the slab's fy)")
    if acc.device.type == "cpu":
        return composite_pixels_plain(acc, scene_color, view_depth, params,
                                      grid_whd, y_map)
    if grad:
        return CompositeFn.apply(acc, scene_color, view_depth, params,
                                 grid_whd, "pixels")
    return _launch_pixels(acc, scene_color, view_depth, params, grid_whd,
                          y_map)


def _launch_pixels(acc, scene_color, view_depth, params, grid_whd, y_map):
    cuda.check_cuda(acc, scene_color, view_depth)
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    dev = acc.device
    yk, yw, xk, xw = _device_taps(ih, iw, _y_map(y_map, h, ih), w, dev)
    fp = froxel.depth_params(params).to(dev)
    out = torch.empty((ih, iw, 4), dtype=torch.float32, device=dev)
    cuda.launch("composite", cuda.ptr(acc), cuda.ptr(scene_color),
                cuda.ptr(view_depth), cuda.ptr(yk), cuda.ptr(yw),
                cuda.ptr(xk), cuda.ptr(xw), cuda.ptr(fp), w, h, d, ih, iw,
                cuda.ptr(out), entry="vr_composite_pixels")
    return out


# --------------------------------------------------------------------------
# The gradient: K14, the adjoint of K4's cells and per-pixel forms
# --------------------------------------------------------------------------

FORMS = ("cells", "pixels")
# K14's launch (csrc/composite_grad.cu): a block a tile of (columns, rows)
# of froxel columns, a thread a (column, channel) of it, its footprint
# staged K14_ROWS pixel rows at a time; the most dynamic shared memory an
# H100 block may take
K14_TILE = (8, 2)
K14_THREADS = 4 * K14_TILE[0] * K14_TILE[1]
K14_ROWS = 8
K14_MAX_SHARED = 232448


def k14_shared_bytes(d: int, fw: int) -> int:
    """Mirror of k14_shared_bytes: a block's sums of d slices ([d][threads]
    floats), z0 and f of a chunk's K14_ROWS x fw pixels, its four g_v
    planes of (K14_ROWS fw | 1) floats, 8 B a footprint column."""
    cap = K14_ROWS * fw
    return 4 * d * K14_THREADS + 8 * cap + 16 * (cap | 1) + 8 * fw


def k14_chunks(d: int, fw: int, chunks: Optional[int] = None
               ) -> Tuple[int, int]:
    """Mirror of k14_plan: (chunks, slices a chunk) of K14 at d slices and
    footprints fw columns wide. By the size rule (chunks None) all d slices
    in one launch where k14_shared_bytes(d, fw) fits K14_MAX_SHARED, else
    the fewest chunks that fit, ceil(d / chunks) slices each (the last
    the rest). chunks: a count to force, ceil(d / chunks) slices each;
    raises ValueError where a chunk does not fit."""
    if chunks is None:
        fit = (K14_MAX_SHARED - k14_shared_bytes(0, fw)) // (4 * K14_THREADS)
        chunks = -(-d // fit) if fit >= 1 else 0
    zc = -(-d // chunks) if chunks >= 1 else 0
    if zc < 1 or k14_shared_bytes(zc, fw) > K14_MAX_SHARED:
        raise ValueError(f"K14 at {d} slices, footprints {fw} wide: no "
                         f"chunk of {zc} slices fits {K14_MAX_SHARED} B")
    return -(-d // zc), zc


def _first_taps(ih: int, iw: int, grid_whd, form: str):
    """K4's first xy tap of each image row, ky [IH], and column, kx [IW]
    (int64, unclamped): pixel (i, j) reads rows clamp(ky[i] + a) and
    columns clamp(kx[j] + b), a, b in (0, 1). Per pixel: pixel_taps' k0.
    Cells: cell row i // py plus the window's first row of the pixel's
    in-cell position (cell_taps) less 1, likewise the columns; raises if a
    position's first row depends on its column or its first column on its
    row."""
    w, h, _ = grid_whd
    if form == "pixels":
        return (pixel_taps(ih, h)[0].astype(np.int64),
                pixel_taps(iw, w)[0].astype(np.int64))
    py, px = ih // h, iw // w
    first, _ = cell_taps(cell_weights(py, px))
    dy0, dx0 = first[:, 0].reshape(py, px), first[:, 1].reshape(py, px)
    if (dy0 != dy0[:, :1]).any() or (dx0 != dx0[:1, :]).any():
        raise ValueError("cell taps whose window is not one row and one "
                         "column range per in-cell row and column")
    rows, cols = np.arange(ih), np.arange(iw)
    return (rows // py + dy0[rows % py, 0].astype(np.int64) - 1,
            cols // px + dx0[0, cols % px].astype(np.int64) - 1)


def axis_footprint(k: np.ndarray, n: int) -> np.ndarray:
    """Along one axis of n froxels, with first taps k (monotone): [4, n]
    int64, per froxel y the range [lo_0, hi_0) of the pixels whose tap 0,
    clamp(k), reaches y and the range [lo_1, hi_1) of those whose tap 1,
    clamp(k + 1), does (empty where lo = hi), zero-weight taps included."""
    if (np.diff(k) < 0).any():
        raise ValueError("K14 needs first taps that never decrease")
    at = np.arange(n)
    out = []
    for t in (0, 1):
        tap = np.clip(k + t, 0, n - 1)
        out += [np.searchsorted(tap, at, "left"),
                np.searchsorted(tap, at, "right")]
    return np.stack(out)


@functools.lru_cache(maxsize=16)
def grad_footprint(ih: int, iw: int, grid_whd: Tuple[int, int, int],
                   form: str) -> Tuple[np.ndarray, int]:
    """K14's host table of K4's `form` at IH x IW on grid_whd: the rows'
    axis_footprint [4, H] and the columns' [4, W] concatenated (int32),
    and the widest footprint, in pixel columns, of a K14_TILE tile (the
    union of its columns' ranges)."""
    w, h, _ = grid_whd
    ky, kx = _first_taps(ih, iw, grid_whd, form)
    ry, rx = axis_footprint(ky, h), axis_footprint(kx, w)
    tx = K14_TILE[0]
    # a tile's columns x0..x1 read pixel columns min(lo)[x0]..max(hi)[x1]
    width = lambda x0, x1: max(rx[1, x1], rx[3, x1]) - min(rx[0, x0],
                                                           rx[2, x0])
    fw = max(width(x, min(x + tx, w) - 1) for x in range(0, w, tx))
    return np.concatenate([ry.ravel(), rx.ravel()]).astype(np.int32), int(fw)


@functools.lru_cache(maxsize=16)
def _device_footprint(ih: int, iw: int, grid_whd: Tuple[int, int, int],
                      form: str, device: torch.device) -> torch.Tensor:
    """grad_footprint's table on the card, uploaded once per shape, form
    and device."""
    return cuda.upload(grad_footprint(ih, iw, grid_whd, form)[0], device,
                       torch.int32)


def _needs_grad(acc, scene_color, view_depth, refused=None) -> bool:
    """Whether the composite runs under grad: grad mode on and acc or the
    scene colour requiring it. A view depth that requires grad raises (no
    JAX entry point differentiates the G-buffer), and so does `refused`, a
    form that JAX serves with a Pallas kernel, once grad is needed."""
    if not torch.is_grad_enabled():
        return False
    if view_depth.requires_grad:
        raise NotImplementedError(
            "the composite's gradient in the view depth: no JAX entry point "
            "differentiates the G-buffer")
    grad = acc.requires_grad or (scene_color is not None
                                 and scene_color.requires_grad)
    if grad and refused:
        raise NotImplementedError(
            f"{refused} under grad: jax.grad refuses that route")
    return grad


def _grad_of_v(grad_img: torch.Tensor, scene_color: torch.Tensor
               ) -> torch.Tensor:
    """The gradient of the sampled planes (L_r, L_g, L_b, T) [4, IH, IW]
    from the image's [IH, IW, 4]: g_rgb, and g_T = g_r S_r + g_g S_g +
    g_b S_b + g_a, added left to right as K14 adds them."""
    g, s = grad_img, scene_color
    g_t = (g[..., 0] * s[..., 0] + g[..., 1] * s[..., 1]
           + g[..., 2] * s[..., 2] + g[..., 3])
    return torch.stack([g[..., 0], g[..., 1], g[..., 2], g_t])


def _grad_taps(shape, grid_whd, form: str, dev):
    """K4's xy taps of every pixel: rows yy [IH, 2, 1, 1] and columns xx
    [1, 1, IW, 2] (long, clamped) of taps a and b, and the weights wt
    [IH, 2, IW, 2] (i, a, j, b) K4 reads: the cell table's (cells) or
    yw[a] * xw[b] (per pixel)."""
    w, h, _ = grid_whd
    ih, iw = shape
    ky, kx = _first_taps(ih, iw, grid_whd, form)
    t = torch.arange(2, device=dev)
    yy = torch.clamp(torch.as_tensor(ky, device=dev)[:, None] + t, 0, h - 1)
    xx = torch.clamp(torch.as_tensor(kx, device=dev)[:, None] + t, 0, w - 1)
    if form == "cells":
        py, px = ih // h, iw // w
        _, wts = cell_taps(cell_weights(py, px))
        cell = ((torch.arange(ih, device=dev) % py)[:, None] * px
                + (torch.arange(iw, device=dev) % px)[None, :])
        wt = torch.as_tensor(wts, device=dev)[cell].reshape(ih, iw, 2, 2)
        wt = wt.permute(0, 2, 1, 3)
    else:
        yw = torch.as_tensor(pixel_taps(ih, h)[1], device=dev)
        xw = torch.as_tensor(pixel_taps(iw, w)[1], device=dev)
        wt = yw.T[:, :, None, None] * xw.T[None, None, :, :]
    return yy[:, :, None, None], xx[None, None, :, :], wt


def _sum_in_order(tgt: torch.Tensor, val: torch.Tensor,
                  n: int) -> torch.Tensor:
    """[C, n]: out[:, t] = the sum, from +0 and left to right, of
    val[:, i] over the i with tgt[i] = t in the order of i. Rounds of index
    operations whose targets are unique within a round (so deterministic on
    the card too): round r adds every target's r-th term."""
    out = torch.zeros((val.shape[0], n), dtype=val.dtype, device=val.device)
    if tgt.numel() == 0:
        return out
    st, order = torch.sort(tgt, stable=True)
    val = val[:, order]
    new = torch.ones_like(st, dtype=torch.bool)
    new[1:] = st[1:] != st[:-1]
    starts = torch.nonzero(new).squeeze(1)
    lens = torch.diff(starts, append=starts.new_tensor([st.numel()]))
    lens, by_len = torch.sort(lens, descending=True, stable=True)
    starts = starts[by_len]
    # round r: the segments longer than r, a prefix of starts
    per_len = np.bincount(lens.cpu().numpy())
    active = np.cumsum(per_len[::-1])[::-1]
    for r in range(len(per_len) - 1):
        pos = starts[:int(active[r + 1])] + r
        t = st[pos]
        out.index_copy_(1, t, out.index_select(1, t) + val[:, pos])
    return out


def composite_grad_plain(grad_img: torch.Tensor, scene_color: torch.Tensor,
                         view_depth: torch.Tensor, params,
                         grid_whd: Tuple[int, int, int],
                         form: str = "cells") -> torch.Tensor:
    """Twin of K14: the accumulation's gradient [4, D, H, W] from the
    image's grad_img [IH, IW, 4], through K4's `form` ("cells" or
    "pixels") on the whole grid. Each xy tap of K4's with a non-zero weight
    w adds (g (1 - f)) w to slice z0 and (g f) w to z1, g the planes'
    gradient (g_rgb, g_rgb . scene + g_a); each froxel sums its terms from
    +0 in K14's order (csrc/composite_grad.cu): pixel rows in order, a
    row's taps a in order, then pixel columns in order, a column's taps b
    in order, z0's term before z1's."""
    if form not in FORMS:
        raise ValueError(f"composite form {form!r}: one of {FORMS}")
    w, h, d = grid_whd
    z0, z1, f = _z_taps(params, view_depth, d)
    gv = _grad_of_v(grad_img, scene_color)
    g0, g1 = gv * (1.0 - f), gv * f
    yy, xx, wt = _grad_taps(tuple(view_depth.shape), tuple(grid_whd), form,
                            grad_img.device)
    col = yy * w + xx                                      # [IH, 2, IW, 2]
    at = lambda v: v[..., :, None, :, None]           # (i, j) -> (i, a, j, b)
    tgt = torch.stack([at(z0) * (h * w) + col, at(z1) * (h * w) + col],
                      dim=-1)
    val = torch.stack([at(g0) * wt, at(g1) * wt], dim=-1)
    keep = (wt != 0.0)[..., None].expand(tgt.shape)
    return _sum_in_order(tgt[keep], val[:, keep],
                         d * h * w).reshape(4, d, h, w)


def _k4(form, acc, scene_color, view_depth, params, grid_whd):
    """K4's launch in `form` on the whole grid."""
    if form == "cells":
        out = torch.empty((*view_depth.shape, 4), dtype=torch.float32,
                          device=acc.device)
        return _launch(acc, scene_color, view_depth, params, grid_whd,
                       cell_weights(view_depth.shape[0] // grid_whd[1],
                                    view_depth.shape[1] // grid_whd[0]),
                       out)
    return _launch_pixels(acc, scene_color, view_depth, params, grid_whd,
                          None)


def _k14(form, grad_img, scene_color, view_depth, params, grid_whd,
         chunks=None):
    """K14's launch in `form`: it writes every element of the gradient
    volume, its slices in one launch or in the chunks k14_chunks plans (or
    `chunks` of them, forced; one a grid z index)."""
    grid = tuple(int(v) for v in grid_whd)
    w, h, d = grid
    ih, iw = view_depth.shape
    dev = grad_img.device
    fw = grad_footprint(ih, iw, grid, form)[1]
    zc = k14_chunks(d, fw, chunks)[1]  # refuses a chunk that cannot fit
    cuda.check_cuda(grad_img, scene_color, view_depth)
    if grad_img.data_ptr() % 16:        # K14 reads a pixel's 4 floats at once
        grad_img = grad_img.clone()
    ranges = _device_footprint(ih, iw, grid, form, dev)
    fp = froxel.depth_params(params).to(dev)
    if form == "cells":
        w9 = cell_weights(ih // h, iw // w)
        _, wa = _device_cell_taps(w9.tobytes(), w9.shape[1], dev)
        wb = wa                         # unused by the cells form
    else:
        _, wa, _, wb = _device_taps(ih, iw, (h, ih, 0), w, dev)
    out = torch.empty((4, d, h, w), dtype=torch.float32, device=dev)
    cuda.launch("composite_grad", cuda.ptr(grad_img), cuda.ptr(scene_color),
                cuda.ptr(view_depth), cuda.ptr(ranges), cuda.ptr(wa),
                cuda.ptr(wb), cuda.ptr(fp), w, h, d, ih, iw, fw,
                int(form == "cells"), 0 if chunks is None else zc,
                cuda.ptr(out), entry="vr_composite_grad_chunks")
    return out


def composite_grad(grad_img: torch.Tensor, scene_color: torch.Tensor,
                   view_depth: torch.Tensor, params,
                   grid_whd: Tuple[int, int, int],
                   form: str = "cells",
                   chunks: Optional[int] = None) -> torch.Tensor:
    """K14 (csrc/composite_grad.cu): the accumulation's gradient
    [4, D, H, W] from the image's [IH, IW, 4] through K4's `form` on the
    whole grid. Its twin composite_grad_plain for CPU tensors. chunks: the
    count of slice chunks to force on the card (k14_chunks; `form` names
    K4's form here), None for the size rule's."""
    if form not in FORMS:
        raise ValueError(f"composite form {form!r}: one of {FORMS}")
    w, h, _ = grid_whd
    cells_ok = view_depth.shape[0] % h == 0 and view_depth.shape[1] % w == 0
    if grad_img.shape != (*view_depth.shape, 4) \
            or scene_color.shape != (*view_depth.shape, 3) \
            or (form == "cells" and not cells_ok):
        raise ValueError(f"composite gradient shapes: grad "
                         f"{tuple(grad_img.shape)}, scene "
                         f"{tuple(scene_color.shape)}, depth "
                         f"{tuple(view_depth.shape)}, grid {grid_whd}, "
                         f"form {form}")
    if grad_img.device.type == "cpu":
        return composite_grad_plain(grad_img, scene_color, view_depth,
                                    params, grid_whd, form)
    return _k14(form, grad_img, scene_color, view_depth, params, grid_whd,
                chunks)


class CompositeFn(torch.autograd.Function):
    """K4 with K14 as its backward: apply(acc, scene_color, view_depth,
    params, grid_whd, form) -> image [IH, IW, 4]. The forward launches K4
    as the wrappers do; the backward launches K14 for acc and takes the
    scene colour's gradient g_rgb * T from the image's alpha, which is T."""

    @staticmethod
    def forward(ctx, acc, scene_color, view_depth, params, grid_whd, form):
        image = _k4(form, acc.detach(), scene_color.detach(), view_depth,
                    params, grid_whd)
        ctx.save_for_backward(scene_color, view_depth, image)
        ctx.args = (params, grid_whd, form)
        return image

    @staticmethod
    def backward(ctx, grad_img):
        scene_color, view_depth, image = ctx.saved_tensors
        params, grid_whd, form = ctx.args
        grad_img = grad_img.contiguous()
        g_acc = g_scene = None
        if ctx.needs_input_grad[0]:
            g_acc = composite_grad(grad_img, scene_color.detach(),
                                   view_depth, params, grid_whd, form)
        if ctx.needs_input_grad[1]:
            g_scene = grad_img[..., :3] * image[..., 3:]
        return g_acc, g_scene, None, None, None, None


def composite_frame(cfg: RenderConfig, acc: torch.Tensor,
                    scene_color: torch.Tensor, view_depth: torch.Tensor,
                    params, slab=None) -> torch.Tensor:
    """The frame's composite [IH, IW, 4] in the form of K4 that
    config.composite_route picks for cfg, JAX `pipeline.composite`'s
    branch. A slab (cfg: the slab's halo-extended config, the band of the
    image) takes config.slab_composite_route: the cells form at row_off =
    halo over the band's h - 2 halo cell rows (JAX's slab zgather, both
    its prepadded and its halo_rows call), else the per-pixel form on the
    slab's rows of the global mapping (JAX composite_rowmm with the slab's
    fy)."""
    w, h, d = cfg.grid
    if slab is not None:
        halo = int(slab.halo)
        if slab_composite_route(cfg, halo) == "cells":
            return composite(acc, scene_color, view_depth, params,
                             (w, h - 2 * halo, d), row_off=halo)
        return composite_pixels(acc, scene_color, view_depth, params,
                                cfg.grid, (slab.grid_global[1],
                                           slab.image_height_global, halo))
    args = (acc, scene_color, view_depth, params, cfg.grid)
    route = composite_route(cfg)
    if route == "cosited":
        return composite_cosited(*args, cfg.composite_upsample)
    return composite(*args) if route == "cells" else composite_pixels(*args)
