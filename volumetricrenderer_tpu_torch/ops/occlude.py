"""Any-hit shadow-ray test against the packed primitive tables.

Plain-torch twin of `volumetricrenderer_tpu/ops/pallas/occlude.py`
`any_hit` (solid branch); its CUDA counterpart is `any_hit` in
`csrc/common.cuh`. Same epsilons and root selection. Fractional box opacity
and the heightfield march are not ported.
"""

from __future__ import annotations

import torch


def pack_boxes(geometry) -> torch.Tensor:
    """[B, 8] box table: (min xyz, opacity, max xyz, 0)."""
    bmin = geometry.box_min
    op = geometry.box_opacity[:, None] if geometry.box_opacity.shape[0] \
        else torch.ones_like(bmin[:, :1])
    return torch.cat([bmin, op, geometry.box_max, torch.zeros_like(bmin[:, :1])],
                     dim=-1)


def any_hit(planes, spheres, boxes, wx, wy, wz, dx, dy, dz, max_t, *,
            n_planes: int, n_spheres: int, n_boxes: int) -> torch.Tensor:
    """bool occlusion of rays from (wx, wy, wz) along the normalized
    direction (dx, dy, dz), parametric range (1e-4, max_t). planes [P, 4]
    (normal, d), spheres [S, 4] (center, r), boxes [B, 8] (pack_boxes)."""
    occ = torch.zeros(torch.broadcast_shapes(wx.shape, torch.as_tensor(
        dx).shape), dtype=torch.bool, device=wx.device)
    for i in range(n_planes):
        nx_, ny_, nz_, pd = planes[i, 0], planes[i, 1], planes[i, 2], \
            planes[i, 3]
        denom = dx * nx_ + dy * ny_ + dz * nz_
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                            denom)
        t = -(wx * nx_ + wy * ny_ + wz * nz_ + pd) / denom
        occ |= (t > 1e-4) & (t < max_t)
    for i in range(n_spheres):
        cx_, cy_, cz_, r_ = spheres[i, 0], spheres[i, 1], spheres[i, 2], \
            spheres[i, 3]
        ox, oy, oz = wx - cx_, wy - cy_, wz - cz_
        bq = ox * dx + oy * dy + oz * dz
        cq = ox * ox + oy * oy + oz * oz - r_ * r_
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t = torch.where(-bq - sq > 1e-4, -bq - sq, -bq + sq)
        occ |= (disc > 0.0) & (t > 1e-4) & (t < max_t)
    if n_boxes:
        def inv(v):
            v = torch.as_tensor(v)
            return 1.0 / torch.where(v.abs() < 1e-9, torch.full_like(v, 1e-9),
                                     v)
        inv_x, inv_y, inv_z = inv(dx), inv(dy), inv(dz)
        for i in range(n_boxes):
            t0x = (boxes[i, 0] - wx) * inv_x
            t1x = (boxes[i, 4] - wx) * inv_x
            t0y = (boxes[i, 1] - wy) * inv_y
            t1y = (boxes[i, 5] - wy) * inv_y
            t0z = (boxes[i, 2] - wz) * inv_z
            t1z = (boxes[i, 6] - wz) * inv_z
            tmin = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                               torch.minimum(t0y, t1y)),
                                 torch.minimum(t0z, t1z))
            tmax = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                               torch.maximum(t0y, t1y)),
                                 torch.maximum(t0z, t1z))
            t = torch.where(tmin > 1e-4, tmin, tmax)
            occ |= (tmax >= tmin) & (t > 1e-4) & (t < max_t)
    return occ
