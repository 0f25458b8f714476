"""Participating-media description (`volumetricrenderer_tpu/models/media.py`).

Scattering colour, absorption, phase g, optional animated noise (tiling +
scroll; "procedural" fBm or a "texture"), constant or box volumes, additive
or alpha blends, and the exponential height falloff. Coefficients scale as
scatter = color * 0.00692, absorption = a * 0.00077.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

SCATTER_SCALE = 0.00692
ABSORPT_SCALE = 0.00077

CONSTANT = "constant"
BOX = "box"
ALPHA_BLEND = "alpha"
ADDITIVE = "additive"


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class Medium:
    scattering_color: torch.Tensor       # [3]
    absorption: torch.Tensor             # []
    phase_g: torch.Tensor                # []
    noise_tex: Optional[torch.Tensor]    # [Nz, Ny, Nx] or None
    noise_tiling: torch.Tensor           # [3]
    noise_scroll: torch.Tensor           # [3]
    box_min: torch.Tensor                # [3]
    box_max: torch.Tensor                # [3]
    box_softness: torch.Tensor           # []
    height_falloff: torch.Tensor         # []
    height_base: torch.Tensor            # []
    volume_type: str = CONSTANT
    blend_type: str = ALPHA_BLEND
    noise_mode: str = "texture"
    noise_octaves: int = 3
    noise_period: int = 4
    noise_seed: int = 7

    @property
    def scattering_coef(self) -> torch.Tensor:
        return self.scattering_color * SCATTER_SCALE

    @property
    def absorption_coef(self) -> torch.Tensor:
        return self.absorption * ABSORPT_SCALE

    @staticmethod
    def create(scattering_color=(0.58, 0.58, 0.58), absorption=0.58,
               phase_g=0.002, noise_tex=None, noise_tiling=(0.0, 0.0, 0.0),
               noise_scroll=(0.0, 0.0, 0.0), volume_type=CONSTANT,
               blend_type=ALPHA_BLEND, box_min=(0.0, 0.0, 0.0),
               box_max=(0.0, 0.0, 0.0), box_softness=0.0,
               height_falloff=0.0, height_base=0.0, noise_mode="texture",
               noise_octaves=3, noise_period=4, noise_seed=7,
               device="cuda") -> "Medium":
        f = lambda v: _f32(v, device)
        return Medium(
            scattering_color=f(scattering_color), absorption=f(absorption),
            phase_g=f(phase_g),
            noise_tex=None if noise_tex is None else f(noise_tex),
            noise_tiling=f(noise_tiling), noise_scroll=f(noise_scroll),
            box_min=f(box_min), box_max=f(box_max),
            box_softness=f(box_softness), height_falloff=f(height_falloff),
            height_base=f(height_base), volume_type=volume_type,
            blend_type=blend_type, noise_mode=noise_mode,
            noise_octaves=int(noise_octaves), noise_period=int(noise_period),
            noise_seed=int(noise_seed))
