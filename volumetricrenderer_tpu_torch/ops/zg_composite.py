"""The exact-f32 trilinear composite: rgb = scene * T + L, a = T.

Port of `volumetricrenderer_tpu/ops/pallas/zg_composite.py`
`composite_zgather` (the zgather branch of `pipeline.composite`). Per pixel:
fz = depth_to_froxel_z(depth) - 0.5 clipped to [0, d-1], the two z taps
floor(fz) and min(floor(fz) + 1, d - 1), and the xy taps of the pixel's
cell and its clamped neighbours weighted by the static in-cell bilinear
weights (pixel -> froxel coordinate (i + 0.5) * W / IW - 0.5, clamp to
edge). The TPU kernel's padded planes, cells-as-rows transpose and unshuffle
are layout workarounds and do not exist here.

`composite` launches the CUDA kernel K4 (csrc/composite.cu) for CUDA tensors
and runs its twin `composite_plain` for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel
from volumetricrenderer_tpu_torch.ops import cuda


@functools.lru_cache(maxsize=8)
def cell_weights(py: int, px: int) -> np.ndarray:
    """[9, py*px] float32 bilinear weights of the 3x3 cell neighbours
    (dy, dx in -1, 0, 1) for each pixel in a cell, at in-cell offsets
    (i + 0.5)/p - 0.5 from the cell centre."""
    fy = (np.arange(py) + 0.5) / py - 0.5
    fx = (np.arange(px) + 0.5) / px - 0.5
    out = np.zeros((3, 3, py, px), np.float32)
    for d in (-1, 0, 1):
        wy = np.maximum(0.0, 1.0 - np.abs(fy - d))
        for e in (-1, 0, 1):
            wx = np.maximum(0.0, 1.0 - np.abs(fx - e))
            out[d + 1, e + 1] = np.outer(wy, wx)
    return out.reshape(9, py * px)


def composite_plain(acc: torch.Tensor, scene_color: torch.Tensor,
                    view_depth: torch.Tensor, params,
                    grid_whd: Tuple[int, int, int]) -> torch.Tensor:
    """Twin of K4. acc [4, D, H, W], scene_color [IH, IW, 3], view_depth
    [IH, IW] -> image [IH, IW, 4]."""
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    py, px = ih // h, iw // w
    dev = acc.device
    fz = froxel.depth_to_froxel_z(params, view_depth) - 0.5
    fz = torch.clamp(fz, 0.0, d - 1.0)
    z0f = torch.floor(fz)
    f = fz - z0f
    z0 = torch.clamp(z0f.to(torch.long), 0, d - 1)
    z1 = torch.clamp(z0 + 1, max=d - 1)
    rows = torch.arange(ih, device=dev)
    cols = torch.arange(iw, device=dev)
    cell = ((rows % py)[:, None] * px + (cols % px)[None, :])
    w9 = torch.as_tensor(cell_weights(py, px), device=dev)
    s0 = torch.zeros((4, ih, iw), dtype=torch.float32, device=dev)
    s1 = torch.zeros_like(s0)
    for dy in range(3):
        yy = torch.clamp(rows // py + dy - 1, 0, h - 1)[:, None]
        for dx in range(3):
            xx = torch.clamp(cols // px + dx - 1, 0, w - 1)[None, :]
            wt = w9[dy * 3 + dx][cell]
            s0 = s0 + acc[:, z0, yy, xx] * wt
            s1 = s1 + acc[:, z1, yy, xx] * wt
    v = s0 * (1.0 - f) + s1 * f
    rgb = scene_color * v[3][..., None] + v[:3].permute(1, 2, 0)
    return torch.cat([rgb, v[3][..., None]], dim=-1)


def composite(acc: torch.Tensor, scene_color: torch.Tensor,
              view_depth: torch.Tensor, params,
              grid_whd: Tuple[int, int, int]) -> torch.Tensor:
    """K4: the composited image [IH, IW, 4]."""
    w, h, d = grid_whd
    ih, iw = view_depth.shape
    if acc.shape != (4, d, h, w) or scene_color.shape != (ih, iw, 3) \
            or ih % h or iw % w:
        raise ValueError(f"composite shapes: acc {tuple(acc.shape)}, scene "
                         f"{tuple(scene_color.shape)}, depth {(ih, iw)}")
    if acc.device.type == "cpu":
        return composite_plain(acc, scene_color, view_depth, params, grid_whd)
    cuda.check_cuda(acc, scene_color, view_depth)
    dev = acc.device
    w9 = cuda.upload(cell_weights(ih // h, iw // w), dev)
    fp = torch.stack([params.z, params.w, params.near]).to(
        device=dev, dtype=torch.float32)
    out = torch.empty((ih, iw, 4), dtype=torch.float32, device=dev)
    cuda.launch("composite", cuda.ptr(acc), cuda.ptr(scene_color),
                cuda.ptr(view_depth), cuda.ptr(w9), cuda.ptr(fp), w, h, d,
                ih, iw, cuda.ptr(out))
    return out
