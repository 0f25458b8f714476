"""Volume sampling outside the kernels.

Counterpart of `volumetricrenderer_tpu/ops/sampling.py` on channel-first
volumes [C, D, H, W]: `shift_sample_3d` (the whole grid at one constant
offset: the jittered fetch of the plain accumulation) and
`trilinear_sample_3d` (arbitrary positions: the "gather" reprojection, and
with wrap=True the noise texture's repeat sampler). All coordinates are
texel coordinates; borders clamp to the edge unless wrapped. The eight
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
                        ty: torch.Tensor, tz: torch.Tensor,
                        wrap: bool = False) -> torch.Tensor:
    """Joint trilinear sample of vol [C, D, H, W] at texel coordinates
    tx/ty/tz (one shape [...]): [C, ...]. Clamp-to-edge, or with wrap the
    tap indices taken mod each axis's size (a repeat sampler; negative
    coordinates included). The eight taps are gathered in one indexing
    call, their int32 indices as the JAX function's."""
    c, d, h, w = vol.shape
    shape = tuple(tx.shape)

    def axis(t, n):
        """(indices [2, ...] of the two taps, weights [2, ...])."""
        t0 = torch.floor(t)
        f = t - t0
        i0 = t0.to(torch.int32)
        i = torch.stack([i0, i0 + 1])
        i = torch.remainder(i, n) if wrap else torch.clamp(i, 0, n - 1)
        return i, torch.stack([1.0 - f, f])

    xi, wx = axis(tx, w)
    yi, wy = axis(ty, h)
    zi, wz = axis(tz, d)
    # tap (dz, dy, dx) at [dz, dy, dx]: its flat index and weight
    idx = (zi[:, None, None] * h + yi[None, :, None]) * w \
        + xi[None, None, :]
    wgt = wz[:, None, None] * wy[None, :, None] * wx[None, None, :]
    taps = vol.reshape(c, -1)[:, idx.reshape(-1)].reshape(
        (c, 2, 2, 2) + shape) * wgt
    out = taps[:, 0, 0, 0]
    for dz, dy, dx in ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0),
                       (1, 0, 1), (1, 1, 0), (1, 1, 1)):
        out = out + taps[:, dz, dy, dx]
    return out
