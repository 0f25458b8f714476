"""Analytic scene geometry (`volumetricrenderer_tpu/models/geometry.py`).

Infinite planes, spheres and axis-aligned boxes, ray-cast for the G-buffer
stand-in and for every shadow ray. The heightfield and fractional box
opacity fields are carried so that a converted scene keeps them, but the
port's renderer refuses a scene that uses either.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Geometry:
    plane_normal: torch.Tensor   # [P, 3] unit; dot(n, p) + d = 0
    plane_d: torch.Tensor        # [P]
    plane_albedo: torch.Tensor   # [P, 3]
    sphere_center: torch.Tensor  # [S, 3]
    sphere_radius: torch.Tensor  # [S]
    sphere_albedo: torch.Tensor  # [S, 3]
    box_min: torch.Tensor        # [B, 3]
    box_max: torch.Tensor        # [B, 3]
    box_albedo: torch.Tensor     # [B, 3]
    box_opacity: torch.Tensor    # [B] shadow opacity, 1 = solid
    hf_amp: torch.Tensor
    hf_base: torch.Tensor
    hf_tiling: torch.Tensor      # [2]
    hf_offset: torch.Tensor      # [2]
    hf_albedo: torch.Tensor      # [3]
    box_fractional: bool = False
    n_proxy_boxes: int = 0
    hf_enabled: bool = False
    hf_octaves: int = 2
    hf_period: int = 4
    hf_seed: int = 11
    hf_steps: int = 12
    hf_far: float = 200.0

    @staticmethod
    def create(planes=(), spheres=(), boxes=(), device="cuda") -> "Geometry":
        """planes: [(normal, d, albedo)], spheres: [(center, r, albedo)],
        boxes: [(min, max, albedo)] (solid). No heightfield."""
        def pack(items, shapes):
            if not items:
                return [torch.zeros((0,) + s, dtype=torch.float32,
                                    device=device) for s in shapes]
            cols = list(zip(*items))
            return [_f32(list(c), device).reshape((len(items),) + s)
                    for c, s in zip(cols, shapes)]

        pn, pd, pa = pack(list(planes), [(3,), (), (3,)])
        sc, sr, sa = pack(list(spheres), [(3,), (), (3,)])
        boxes = [(*b, 1.0) for b in boxes]
        bmin, bmax, ba, bo = pack(boxes, [(3,), (3,), (3,), ()])
        pn = pn / torch.clamp(torch.linalg.norm(pn, dim=-1, keepdim=True),
                              min=1e-9)
        f = lambda v: _f32(v, device)
        return Geometry(pn, pd, pa, sc, sr, sa, bmin, bmax, ba, bo,
                        hf_amp=f(0.0), hf_base=f(0.0),
                        hf_tiling=f((0.05, 0.05)), hf_offset=f((0.0, 0.0)),
                        hf_albedo=f((0.3, 0.35, 0.25)))
