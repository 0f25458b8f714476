"""Cross-frame state.

The history volumes of the production path plus the previous view matrix and
the frame counter that selects the jitter. Unlike the JAX package, the
accumulation history has one layout only: [4, D, H, W] (L_r, L_g, L_b, T).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FrameState:
    prev_shadow: torch.Tensor          # [Nd, D, H, W] dir-light visibility
    prev_accumulation: torch.Tensor    # [4, D, H, W] (L rgb, T)
    prev_world_to_view: torch.Tensor   # [4, 4] on the CPU (host prep)
    frame_count: int

    @staticmethod
    def create(grid_dhw: Tuple[int, int, int], num_dir_lights: int = 1,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> "FrameState":
        """Fresh history: shadow visibility 1, accumulation 0 (T = 0 marks
        "no history" for the accumulation blend), on `device`; the view
        matrix stays on the CPU, where the frame's tables are packed."""
        d, h, w = grid_dhw
        nd = max(num_dir_lights, 1)
        return FrameState(
            prev_shadow=torch.ones((nd, d, h, w), dtype=dtype, device=device),
            prev_accumulation=torch.zeros((4, d, h, w), dtype=dtype,
                                          device=device),
            prev_world_to_view=torch.eye(4, dtype=torch.float32),
            frame_count=0,
        )


def packed_accumulation(prev: torch.Tensor) -> torch.Tensor:
    """[4, D, H, W] accumulation history -> packed [D, H, W, 4]."""
    return prev.permute(1, 2, 3, 0).contiguous()
