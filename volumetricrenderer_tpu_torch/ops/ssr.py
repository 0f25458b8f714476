"""The quarter-res SSR march: kernel K13 and its plain-torch twin.

Counterpart of `volumetricrenderer_tpu/ops/pallas/ssr.py`
(`ssr_march_pallas`, whose `_kernel` runs every direction bin's taps over
edge-padded VMEM copies of the planes) and of the XLA loop in
`volumetricrenderer_tpu/post.py` `_ssr_p` that it is held to.
`ssr_march` launches K13 (`csrc/ssr_march.cu`) on CUDA tensors and runs
`ssr_march_reference`, the XLA loop term for term (every bin over the whole
plane, masked by its `sel`), on CPU tensors. K13 gives each pixel one
thread that walks only its own bin's taps: every other bin adds 0 * a
finite value, so both compute the same function, bit for bit.

Inputs are [hq, wq] float32 planes from post._ssr_p's geometry stage: the
view depth dq, the three colour planes, invz0 = 1 / dq, the 1/z gradient g
per pixel of march, the direction bin (an integer-valued float) and the
valid mask (0 or 1). `offsets` is post._ssr_offsets(cfg): per bin, the
(t_prev, t, oy, ox) taps. Returns (refl_r, refl_g, refl_b, hit_w, hit_t).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops import cuda


def ssr_march_reference(dq, colors: Sequence, invz0, g, bin_idx, valid,
                        offsets: tuple, thickness: float, max_px: float
                        ) -> Tuple[torch.Tensor, ...]:
    """Twin of K13: the JAX package's XLA march loop (post._ssr_p), all
    bins over the whole plane, each masked by its sel."""
    # post imports this module: its edge-clamped shift is bound here
    from volumetricrenderer_tpu_torch.post import _shift2_p as _shift
    hq, wq = dq.shape
    z = lambda: torch.zeros((hq, wq), dtype=torch.float32, device=dq.device)
    yy = torch.arange(hq, device=dq.device)[:, None]
    xx = torch.arange(wq, device=dq.device)[None, :]
    refl = [z(), z(), z()]
    hitw, hitt = z(), z()
    for b, taps in enumerate(offsets):
        sel = (bin_idx == b).to(torch.float32) * valid
        not_hit = torch.ones_like(dq)
        acc = [z(), z(), z()]
        aw, at = z(), z()
        for (t_prev, t, oy, ox) in taps:
            zs = _shift(dq, oy, ox)
            invz = invz0 + g * t
            z_ray = torch.where(invz > 1e-4,
                                1.0 / torch.clamp(invz, min=1e-4),
                                torch.full_like(invz, 1e9))
            invz_p = invz0 + g * t_prev
            z_prev = torch.where(invz_p > 1e-4,
                                 1.0 / torch.clamp(invz_p, min=1e-4),
                                 torch.full_like(invz_p, 1e9))
            onscreen = ((yy + oy >= 0) & (yy + oy < hq)
                        & (xx + ox >= 0) & (xx + ox < wq)).to(torch.float32)
            hit = ((z_ray >= zs) & (z_prev <= zs + thickness)
                   ).to(torch.float32) * onscreen
            wgt = not_hit * hit
            for c in range(3):
                acc[c] = acc[c] + wgt * _shift(colors[c], oy, ox)
            aw = aw + wgt
            at = at + wgt * (t / max_px)
            not_hit = not_hit * (1.0 - hit)
        for c in range(3):
            refl[c] = refl[c] + sel * acc[c]
        hitw = hitw + sel * aw
        hitt = hitt + sel * at
    return refl[0], refl[1], refl[2], hitw, hitt


@functools.lru_cache(maxsize=8)
def tap_table(offsets: tuple, max_px: float, device: torch.device):
    """K13's tap table on `device`: float32 [n_bins, max_taps, 5] rows
    (t_prev, t, t / max_px, oy, ox), each as the twin rounds it to float32,
    and int32 [n_bins] tap counts. Uploaded once per config: two copies a
    call would cost K13's wrapper three times the kernel's device time."""
    n_taps = max(max((len(b) for b in offsets), default=0), 1)
    rows = np.zeros((len(offsets), n_taps, 5), np.float32)
    for b, taps in enumerate(offsets):
        for i, (t_prev, t, oy, ox) in enumerate(taps):
            rows[b, i] = (t_prev, t, t / max_px, oy, ox)
    counts = np.array([len(b) for b in offsets], np.int32)
    return (cuda.upload(rows, device),
            cuda.upload(counts, device, torch.int32))


def ssr_march(dq, colors: Sequence, invz0, g, bin_idx, valid,
              offsets: tuple, thickness: float, max_px: float
              ) -> Tuple[torch.Tensor, ...]:
    """K13: the SSR march of `ssr_march_pallas` (the JAX signature, less
    `interpret`). CPU tensors take the twin; CUDA tensors launch the kernel
    once, or raise."""
    if dq.device.type == "cpu":
        return ssr_march_reference(dq, colors, invz0, g, bin_idx, valid,
                                   offsets, thickness, max_px)
    planes = [p.contiguous() for p in (dq, *colors, invz0, g, bin_idx,
                                       valid)]
    hq, wq = dq.shape
    for p in planes:
        if p.shape != (hq, wq):
            raise ValueError(f"plane {tuple(p.shape)} != {(hq, wq)}")
    cuda.check_cuda(*planes)
    taps, counts = tap_table(offsets, float(max_px), dq.device)
    outs = [torch.empty_like(planes[0]) for _ in range(5)]
    cuda.launch("ssr_march", *(cuda.ptr(p) for p in planes), cuda.ptr(taps),
                cuda.ptr(counts), len(offsets), taps.shape[1], hq, wq,
                float(np.float32(thickness)), *(cuda.ptr(o) for o in outs))
    return tuple(outs)


# the JAX package's name for the same function
ssr_march_pallas = ssr_march
