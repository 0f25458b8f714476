"""Camera model: position, forward, up, vertical fov, aspect, near, far."""

from __future__ import annotations

import dataclasses

import torch

from volumetricrenderer_tpu_torch import froxel


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor   # [3]
    forward: torch.Tensor    # [3] unit
    up: torch.Tensor         # [3] unit
    fov_y: torch.Tensor      # vertical field of view, radians
    aspect: torch.Tensor     # width / height
    near: torch.Tensor
    far: torch.Tensor

    @staticmethod
    def create(position, forward, up=(0.0, 1.0, 0.0), fov_y_deg=60.0,
               aspect=16.0 / 9.0, near=0.3, far=100.0,
               device="cuda") -> "Camera":
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        fwd = f32(forward)
        fwd = fwd / torch.linalg.norm(fwd)
        upv = f32(up)
        return Camera(position=f32(position), forward=fwd,
                      up=upv / torch.linalg.norm(upv),
                      fov_y=f32(fov_y_deg) * torch.pi / 180.0,
                      aspect=f32(aspect), near=f32(near), far=f32(far))

    def view_to_world(self) -> torch.Tensor:
        return froxel.look_at_matrix(self.position, self.forward, self.up)

    def world_to_view(self) -> torch.Tensor:
        return froxel.invert_rigid(self.view_to_world())
