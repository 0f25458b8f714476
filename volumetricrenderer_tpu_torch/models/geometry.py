"""Analytic scene geometry (`volumetricrenderer_tpu/models/geometry.py`).

Infinite planes, spheres, axis-aligned boxes (solid, or with a shadow
opacity below 1: box_fractional) and an optional procedural heightfield
(the terrain: base + amp * fBm(x, z)), ray-cast for the G-buffer stand-in
and for every shadow ray. The last n_proxy_boxes boxes are shadow-only
proxies of a triangle mesh (models/mesh.py): every shadow ray sees them,
the G-buffer's primary rays skip them.
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
    def empty(device="cuda") -> "Geometry":
        """No primitives and no heightfield."""
        return Geometry.create(device=device)

    @staticmethod
    def create(planes=(), spheres=(), boxes=(), heightfield=None,
               n_proxy_boxes: int = 0, device="cuda") -> "Geometry":
        """planes: [(normal, d, albedo)], spheres: [(center, r, albedo)],
        boxes: [(min, max, albedo)] or [(min, max, albedo, opacity)]
        (box_fractional where any opacity is below 1); heightfield: None or
        a dict with amp, base, tiling, offset, albedo and the statics
        octaves, period, seed, steps, far; n_proxy_boxes: the last n boxes
        are shadow-only mesh proxies."""
        def pack(items, shapes):
            if not items:
                return [torch.zeros((0,) + s, dtype=torch.float32,
                                    device=device) for s in shapes]
            cols = list(zip(*items))
            return [_f32(list(c), device).reshape((len(items),) + s)
                    for c, s in zip(cols, shapes)]

        pn, pd, pa = pack(list(planes), [(3,), (), (3,)])
        sc, sr, sa = pack(list(spheres), [(3,), (), (3,)])
        boxes = [b if len(b) == 4 else (*b, 1.0) for b in boxes]
        bmin, bmax, ba, bo = pack(boxes, [(3,), (3,), (3,), ()])
        pn = pn / torch.clamp(torch.linalg.norm(pn, dim=-1, keepdim=True),
                              min=1e-9)
        if not 0 <= n_proxy_boxes <= len(boxes):
            raise ValueError(f"n_proxy_boxes={n_proxy_boxes} of "
                             f"{len(boxes)} boxes")
        hf = heightfield or {}
        f = lambda v: _f32(v, device)
        return Geometry(pn, pd, pa, sc, sr, sa, bmin, bmax, ba, bo,
                        hf_amp=f(hf.get("amp", 0.0)),
                        hf_base=f(hf.get("base", 0.0)),
                        hf_tiling=f(hf.get("tiling", (0.05, 0.05))),
                        hf_offset=f(hf.get("offset", (0.0, 0.0))),
                        hf_albedo=f(hf.get("albedo", (0.3, 0.35, 0.25))),
                        box_fractional=any(float(b[3]) < 1.0 for b in boxes),
                        n_proxy_boxes=int(n_proxy_boxes),
                        hf_enabled=heightfield is not None,
                        hf_octaves=int(hf.get("octaves", 2)),
                        hf_period=int(hf.get("period", 4)),
                        hf_seed=int(hf.get("seed", 11)),
                        hf_steps=int(hf.get("steps", 12)),
                        hf_far=float(hf.get("far", 200.0)))
