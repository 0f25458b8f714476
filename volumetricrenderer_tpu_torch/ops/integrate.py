"""The jittered xy sample of the scatter planes and the per-slice integral.

Plain-torch twins of `volumetricrenderer_tpu/ops/pallas/integrate.py`
`make_xy_blend` (3-tap clamped tent for a constant jitter offset) and of the
expm1/Taylor slice integral of `frame_fused.py`; the CUDA counterparts are
in `csrc/integrate_blend.cu`.
"""

from __future__ import annotations

import torch


def make_xy_blend(ox: float, oy: float):
    """xy_blend(plane [..., H, W]): the 3-tap clamped tent at offset
    (ox, oy) in (-1, 1), x first then y."""
    wxm, wx0, wxp = max(-ox, 0.0), 1.0 - abs(ox), max(ox, 0.0)
    wym, wy0, wyp = max(-oy, 0.0), 1.0 - abs(oy), max(oy, 0.0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def shift(p, dim, s):
        n = p.shape[dim]
        idx = torch.clamp(torch.arange(n, device=p.device) + s, 0, n - 1)
        return p.index_select(dim, idx)

    def xy_blend(plane):
        w = [f32(v).to(plane.device)
             for v in (wxm, wx0, wxp, wym, wy0, wyp)]
        px = w[0] * shift(plane, -1, -1) + w[1] * plane \
            + w[2] * shift(plane, -1, 1)
        return w[3] * shift(px, -2, -1) + w[4] * px + w[5] * shift(px, -2, 1)

    return xy_blend


def slice_depths(fpz, fpw, near, z: torch.Tensor, d: int):
    """(vz_lo, vz_hi) view depths of the faces of slice(s) z; vz_lo = near at
    z = 0."""
    zf = z.to(torch.float32)
    vz_hi = (torch.exp(torch.log(fpz) * (zf + 0.5) / d) - 1.0) * fpw + near
    vz_lo = torch.where(
        zf > 0.0, (torch.exp(torch.log(fpz) * (zf - 0.5) / d) - 1.0) * fpw
        + near, near)
    return vz_lo, vz_hi
