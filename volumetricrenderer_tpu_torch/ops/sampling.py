"""Volume sampling outside the kernels.

Counterpart of `volumetricrenderer_tpu/ops/sampling.py` on channel-first
volumes [C, D, H, W]: `shift_sample_3d` (the whole grid at one constant
offset: the jittered fetch of the plain accumulation) and
`trilinear_sample_3d` (arbitrary positions: the "gather" reprojection).
All coordinates are texel coordinates; borders clamp to the edge. The eight
weight products and the sum over the taps are taken in the JAX functions'
order.
"""

from __future__ import annotations

import numpy as np
import torch


def shift_sample_3d(vol: torch.Tensor, offset) -> torch.Tensor:
    """vol [C, D, H, W] sampled at texel (z + oz, y + oy, x + ox) for every
    cell, clamp-to-edge. offset = (ox, oy, oz): three host floats, each
    within one cell of zero (a jitter)."""
    off = np.asarray(offset, np.float32).reshape(3)
    base = np.floor(off)
    fx, fy, fz = (off - base).astype(np.float32)
    pad = 2
    pvol = torch.nn.functional.pad(vol[None], (pad,) * 6,
                                   mode="replicate")[0]
    ix0, iy0, iz0 = (int(v) for v in np.clip(base.astype(np.int32) + pad, 0,
                                             2 * pad))
    _, d, h, w = vol.shape

    def tap(dz, dy, dx):
        return pvol[:, iz0 + dz:iz0 + dz + d, iy0 + dy:iy0 + dy + h,
                    ix0 + dx:ix0 + dx + w]

    one = np.float32(1.0)
    wz0, wz1 = one - fz, fz
    wy0, wy1 = one - fy, fy
    wx0, wx1 = one - fx, fx
    return (tap(0, 0, 0) * float(wz0 * wy0 * wx0)
            + tap(0, 0, 1) * float(wz0 * wy0 * wx1)
            + tap(0, 1, 0) * float(wz0 * wy1 * wx0)
            + tap(0, 1, 1) * float(wz0 * wy1 * wx1)
            + tap(1, 0, 0) * float(wz1 * wy0 * wx0)
            + tap(1, 0, 1) * float(wz1 * wy0 * wx1)
            + tap(1, 1, 0) * float(wz1 * wy1 * wx0)
            + tap(1, 1, 1) * float(wz1 * wy1 * wx1))


def trilinear_sample_3d(vol: torch.Tensor, tx: torch.Tensor,
                        ty: torch.Tensor, tz: torch.Tensor) -> torch.Tensor:
    """Joint trilinear sample of vol [C, D, H, W] at texel coordinates
    tx/ty/tz (one shape [...]), clamp-to-edge: [C, ...]."""
    c, d, h, w = vol.shape
    x0, y0, z0 = torch.floor(tx), torch.floor(ty), torch.floor(tz)
    fx, fy, fz = tx - x0, ty - y0, tz - z0
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    flat = vol.reshape(c, -1)

    def tap(dz, dy, dx):
        zi = torch.clamp(z0 + dz, 0, d - 1)
        yi = torch.clamp(y0 + dy, 0, h - 1)
        xi = torch.clamp(x0 + dx, 0, w - 1)
        idx = (zi * h + yi) * w + xi
        return flat[:, idx.reshape(-1)].reshape((c,) + tuple(idx.shape))

    wz0, wz1 = 1.0 - fz, fz
    wy0, wy1 = 1.0 - fy, fy
    wx0, wx1 = 1.0 - fx, fx
    return (tap(0, 0, 0) * (wz0 * wy0 * wx0)
            + tap(0, 0, 1) * (wz0 * wy0 * wx1)
            + tap(0, 1, 0) * (wz0 * wy1 * wx0)
            + tap(0, 1, 1) * (wz0 * wy1 * wx1)
            + tap(1, 0, 0) * (wz1 * wy0 * wx0)
            + tap(1, 0, 1) * (wz1 * wy0 * wx1)
            + tap(1, 1, 0) * (wz1 * wy1 * wx0)
            + tap(1, 1, 1) * (wz1 * wy1 * wx1))
