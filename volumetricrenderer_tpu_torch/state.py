"""Cross-frame state.

The history volumes plus the previous view matrix and the frame counter
that selects the jitter. Unlike the JAX package, the accumulation history
has one layout only: [4, D, H, W] (L_r, L_g, L_b, T). The material and
scatter histories exist only while their blends are on (None otherwise);
each history is the BLENDED volume of the last frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FrameState:
    prev_shadow: torch.Tensor          # [Nd, D, H, W] dir-light visibility
    prev_accumulation: torch.Tensor    # [4, D, H, W] (L rgb, T)
    prev_world_to_view: torch.Tensor   # [4, 4] on the CPU (host prep)
    frame_count: int
    prev_material_a: Optional[torch.Tensor] = None   # [4, D, H, W] or None
    prev_scatter: Optional[torch.Tensor] = None      # [4, D, H, W] or None

    @staticmethod
    def create(grid_dhw: Tuple[int, int, int], num_dir_lights: int = 1,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda",
               with_material: bool = False,
               with_scatter: bool = False) -> "FrameState":
        """Fresh history: shadow visibility 1, accumulation 0 (T = 0 marks
        "no history" for the accumulation blend), material and scatter 0
        where asked for, on `device`; the view matrix stays on the CPU,
        where the frame's tables are packed."""
        d, h, w = grid_dhw
        nd = max(num_dir_lights, 1)
        zeros4 = lambda: torch.zeros((4, d, h, w), dtype=dtype, device=device)
        return FrameState(
            prev_shadow=torch.ones((nd, d, h, w), dtype=dtype, device=device),
            prev_accumulation=zeros4(),
            prev_world_to_view=torch.eye(4, dtype=torch.float32),
            frame_count=0,
            prev_material_a=zeros4() if with_material else None,
            prev_scatter=zeros4() if with_scatter else None,
        )


def packed_accumulation(prev: torch.Tensor) -> torch.Tensor:
    """[4, D, H, W] accumulation history -> packed [D, H, W, 4]."""
    return prev.permute(1, 2, 3, 0).contiguous()
