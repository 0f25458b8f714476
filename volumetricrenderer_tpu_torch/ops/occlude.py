"""Any-hit shadow-ray test against the packed primitive tables.

Plain-torch twin of `volumetricrenderer_tpu/ops/pallas/occlude.py`
`any_hit` and `_any_hit_fractional`, the terrain march of
`ops/material.heightfield_occluded` included; its CUDA counterpart is
`any_hit` in `csrc/common.cuh`. Same epsilons and root selection.
"""

from __future__ import annotations

import torch

from volumetricrenderer_tpu_torch.ops.material import heightfield_occluded


def pack_boxes(geometry) -> torch.Tensor:
    """[B, 8] box table: (min xyz, opacity, max xyz, 0)."""
    bmin = geometry.box_min
    op = geometry.box_opacity[:, None] if geometry.box_opacity.shape[0] \
        else torch.ones_like(bmin[:, :1])
    return torch.cat([bmin, op, geometry.box_max, torch.zeros_like(bmin[:, :1])],
                     dim=-1)


def any_hit(planes, spheres, boxes, wx, wy, wz, dx, dy, dz, max_t, *,
            n_planes: int, n_spheres: int, n_boxes: int, hf=None,
            hf_static=None, fractional: bool = False) -> torch.Tensor:
    """Occlusion of rays from (wx, wy, wz) along the normalized direction
    (dx, dy, dz), parametric range (1e-4, max_t). planes [P, 4] (normal,
    d), spheres [S, 4] (center, r), boxes [B, 8] (pack_boxes), hf [1, 6]
    (material.pack_heightfield) with hf_static (octaves, period, seed,
    steps, far), or hf_static None to skip the terrain. Returns a bool
    tensor; with fractional (geometry.box_fractional) the f32 occlusion
    amount 1 - prod(1 - opacity_i * hit_i) instead: boxes attenuate by their
    opacity, planes, spheres and the terrain stay solid. Either form feeds
    a consumer's `1 - occ.to(float32) * gate`."""
    shape = torch.broadcast_shapes(wx.shape, torch.as_tensor(dx).shape)
    hits = _hits(planes, spheres, boxes, wx, wy, wz, dx, dy, dz, max_t,
                 n_planes, n_spheres, n_boxes)
    if fractional:
        trans = torch.ones(shape, dtype=torch.float32, device=wx.device)
        for kind, i, hit in hits:
            hit = hit.to(torch.float32)
            trans = trans * (1.0 - (boxes[i, 3] * hit if kind == "box"
                                    else hit))
        if hf_static is not None:
            hfo = heightfield_occluded(hf, hf_static, wx, wy, wz, dx, dy,
                                       dz, max_t).to(torch.float32)
            trans = trans * (1.0 - hfo)
        return 1.0 - trans
    occ = torch.zeros(shape, dtype=torch.bool, device=wx.device)
    for _, _, hit in hits:
        occ |= hit
    if hf_static is not None:
        occ |= heightfield_occluded(hf, hf_static, wx, wy, wz, dx, dy, dz,
                                    max_t)
    return occ


def _hits(planes, spheres, boxes, wx, wy, wz, dx, dy, dz, max_t, n_planes,
          n_spheres, n_boxes):
    """(kind, index, bool hit) of every plane, sphere and box, in order."""
    for i in range(n_planes):
        nx_, ny_, nz_, pd = planes[i, 0], planes[i, 1], planes[i, 2], \
            planes[i, 3]
        denom = dx * nx_ + dy * ny_ + dz * nz_
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                            denom)
        t = -(wx * nx_ + wy * ny_ + wz * nz_ + pd) / denom
        yield "plane", i, (t > 1e-4) & (t < max_t)
    for i in range(n_spheres):
        cx_, cy_, cz_, r_ = spheres[i, 0], spheres[i, 1], spheres[i, 2], \
            spheres[i, 3]
        ox, oy, oz = wx - cx_, wy - cy_, wz - cz_
        bq = ox * dx + oy * dy + oz * dz
        cq = ox * ox + oy * oy + oz * oz - r_ * r_
        disc = bq * bq - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t = torch.where(-bq - sq > 1e-4, -bq - sq, -bq + sq)
        yield "sphere", i, (disc > 0.0) & (t > 1e-4) & (t < max_t)
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
            yield "box", i, (tmax >= tmin) & (t > 1e-4) & (t < max_t)
