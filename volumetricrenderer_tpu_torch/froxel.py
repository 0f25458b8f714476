"""Froxel-grid geometry: the coordinate-system contract.

The froxel <-> view <-> world transforms of `volumetricrenderer_tpu/froxel.py`
on torch tensors. Froxel positions are continuous: slice/texel centers sit at
integer + 0.5. Volumes are stored [D, H, W].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FroxelParams:
    """Packed froxel <-> view parameters.

    x: cot(fov_x/2), y: cot(fov_y/2),
    z: depth_distribution*(D - near*D/volume_distance) + 1,
    w: volume_distance / depth_distribution / D (0-d float32 tensors).
    y0: global row of local row 0 (0 for the whole grid)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    w: torch.Tensor
    near: torch.Tensor
    grid: Tuple[int, int, int]       # (W, H, D)
    y0: float = 0.0


def make_froxel_params(fov_y_rad: torch.Tensor, aspect: torch.Tensor,
                       near: torch.Tensor, volume_distance: float,
                       depth_distribution: float,
                       grid: Tuple[int, int, int]) -> FroxelParams:
    """Froxel params from the camera (float32 throughout, as in JAX)."""
    _, _, d = grid
    py = 1.0 / torch.tan(fov_y_rad / 2.0)
    px = py / aspect
    pz = depth_distribution * (d - near * d / volume_distance) + 1.0
    pw = torch.full_like(near, volume_distance / depth_distribution / d,
                         dtype=torch.float32)
    f32 = lambda v: v.to(torch.float32)
    return FroxelParams(x=f32(px), y=f32(py), z=f32(pz), w=pw,
                        near=f32(near), grid=grid)


def depth_params(p: FroxelParams) -> torch.Tensor:
    """(z, w, near) as one float32 [3] tensor on the params' device, the
    depth mapping the composite kernels read: a view of the params' own
    storage where params_to packed them in that order (no copy, no launch),
    else a new stack."""
    z, w, near = p.z, p.w, p.near
    step = z.element_size()
    if (z.dtype == w.dtype == near.dtype == torch.float32
            and z.untyped_storage().data_ptr()
            == near.untyped_storage().data_ptr()
            and w.data_ptr() == z.data_ptr() + step
            and near.data_ptr() == z.data_ptr() + 2 * step):
        return z.as_strided((3,), (1,))
    return torch.stack([z, w, near]).to(torch.float32)


def params_to(p: FroxelParams, device) -> FroxelParams:
    """The same params with their tensors on `device` (one copy)."""
    vals = torch.stack([p.x, p.y, p.z, p.w, p.near])
    if vals.device.type == "cpu" and torch.device(device).type == "cuda":
        vals = vals.pin_memory().to(device, non_blocking=True)
    else:
        vals = vals.to(device)
    return dataclasses.replace(p, x=vals[0], y=vals[1], z=vals[2], w=vals[3],
                               near=vals[4])


def froxel_to_view(p: FroxelParams, froxel_pos: torch.Tensor) -> torch.Tensor:
    """froxel_pos [..., 3] (x, y, z) continuous -> view position."""
    w, h, d = p.grid
    fx, fy, fz = froxel_pos[..., 0], froxel_pos[..., 1], froxel_pos[..., 2]
    vz = (torch.pow(p.z, fz / d) - 1.0) * p.w + p.near
    vx = (2.0 * fx / w - 1.0) * vz / p.x
    vy = (2.0 * fy / h - 1.0) * vz / p.y
    return torch.stack([vx, vy, vz], dim=-1)


def view_to_froxel(p: FroxelParams, view_pos: torch.Tensor) -> torch.Tensor:
    """View position -> continuous froxel position (log argument clamped)."""
    w, h, d = p.grid
    vx, vy, vz = view_pos[..., 0], view_pos[..., 1], view_pos[..., 2]
    fz = d * torch.log(torch.clamp((vz - p.near) / p.w + 1.0, min=1e-8)) \
        / torch.log(p.z)
    fx = w * (p.x * vx / vz + 1.0) / 2.0
    fy = h * (p.y * vy / vz + 1.0) / 2.0
    return torch.stack([fx, fy, fz], dim=-1)


def depth_to_froxel_z(p: FroxelParams, view_depth: torch.Tensor
                      ) -> torch.Tensor:
    """Linear view depth -> continuous froxel z."""
    _, _, d = p.grid
    return d * torch.log(torch.clamp((view_depth - p.near) / p.w + 1.0,
                                     min=1e-8)) / torch.log(p.z)


def froxel_z_to_view_z(p: FroxelParams, fz: torch.Tensor) -> torch.Tensor:
    """View depth of continuous froxel z."""
    _, _, d = p.grid
    return (torch.pow(p.z, fz / d) - 1.0) * p.w + p.near


def froxel_centers(grid: Tuple[int, int, int], device="cpu") -> torch.Tensor:
    """Continuous froxel position (x, y, z) of every cell centre (integer
    index + 0.5): [D, H, W, 3]."""
    w, h, d = grid
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=device) + 0.5
    zz, yy, xx = torch.meshgrid(ar(d), ar(h), ar(w), indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise 3-vector dot as three products and two adds, in the JAX
    package's order: the shadow-map compare depths depend on it."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def transform_points(mat: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 (column-vector convention) to [..., 3] points, w-divide.
    Written as explicit products, not a matmul, like the JAX package."""
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]
    out = torch.stack(
        [mat[0, 0] * x + mat[0, 1] * y + mat[0, 2] * z + mat[0, 3],
         mat[1, 0] * x + mat[1, 1] * y + mat[1, 2] * z + mat[1, 3],
         mat[2, 0] * x + mat[2, 1] * y + mat[2, 2] * z + mat[2, 3]], dim=-1)
    w = mat[3, 0] * x + mat[3, 1] * y + mat[3, 2] * z + mat[3, 3]
    return out / w[..., None]


def transform_dirs(mat: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 3] directions by the upper-left 3x3."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(
        [mat[0, 0] * x + mat[0, 1] * y + mat[0, 2] * z,
         mat[1, 0] * x + mat[1, 1] * y + mat[1, 2] * z,
         mat[2, 0] * x + mat[2, 1] * y + mat[2, 2] * z], dim=-1)


def froxel_to_world(p: FroxelParams, view_to_world_mat: torch.Tensor,
                    froxel_pos: torch.Tensor) -> torch.Tensor:
    return transform_points(view_to_world_mat, froxel_to_view(p, froxel_pos))


def world_to_froxel(p: FroxelParams, world_to_view_mat: torch.Tensor,
                    world_pos: torch.Tensor) -> torch.Tensor:
    return view_to_froxel(p, transform_points(world_to_view_mat, world_pos))


def look_at_matrix(position: torch.Tensor, forward: torch.Tensor,
                   up: torch.Tensor) -> torch.Tensor:
    """Unity-style LookAt view->world matrix: z = forward,
    x = normalize(cross(up, z)), y = cross(z, x); columns (x, y, z, pos)."""
    z = forward / torch.linalg.norm(forward)
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    m = torch.eye(4, dtype=torch.float32, device=position.device)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = position
    return m


def invert_rigid(m: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid (rotation + translation) 4x4."""
    r = m[:3, :3]
    t = m[:3, 3]
    inv = torch.eye(4, dtype=m.dtype, device=m.device)
    inv[:3, :3] = r.T
    inv[:3, 3] = -(r.T @ t)
    return inv
