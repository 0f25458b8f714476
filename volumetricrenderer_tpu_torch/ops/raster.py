"""Triangle rasterizer for the mesh G-buffer (`volumetricrenderer_tpu/ops/
raster.py`), in plain torch.

The reference gets scene colour and depth from Unity's rasterizer; the froxel
pipeline reads them as inputs, so this runs once per scene and camera, not
per frame, as in the JAX package (plain XLA there: no TPU kernel). It is the
JAX package's brute-force form: every triangle against every pixel with
screen-space edge functions over the [H, W] pixel grid, in chunks of
triangles (peak memory [chunk, H, W]) whose depth resolve is carried from
chunk to chunk; perspective-correct depth from 1/z interpolated with the
screen-space barycentrics.

The resolve does not depend on the chunk size: within a chunk the first
triangle at the nearest depth wins, across chunks only a strictly nearer
one, so the first triangle at the nearest depth wins overall. The renderer
takes CUDA_CHUNK triangles a chunk on the card (fewer launches) and the JAX
package's 8 on the CPU.

The projection is ops/raycast.camera_rays' (the same tan-scaled view
directions, pixel centres and bottom-left origin), so `depth` composites
one to one with the analytic ray cast's linear view z.
"""

from __future__ import annotations

from typing import Tuple

import torch

from volumetricrenderer_tpu_torch import froxel
from volumetricrenderer_tpu_torch.ops import raycast

BIG = raycast.BIG  # no-hit depth
# near-clip guard: a triangle with any vertex at or behind the camera plane
# is dropped whole (environment content behind the camera needs no split)
_Z_EPS = 1e-3
CPU_CHUNK = 8
CUDA_CHUNK = 64


def rasterize_mesh(mesh, camera, width: int, height: int,
                   chunk: int = CPU_CHUNK
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rasterize a TriMesh through `camera` at width x height, on the
    mesh's device.

    Returns (albedo [H, W, 3], normal [H, W, 3]: the world-space unit face
    normal of the winning triangle, not flipped toward the camera, and depth
    [H, W]: linear view z, BIG where no triangle covers the pixel).
    Triangles are double-sided: either winding rasterizes."""
    f32 = torch.float32
    dev = mesh.verts.device
    verts = mesh.verts.to(f32)
    tris = mesh.tris.long()
    t_alb = mesh.albedo.to(f32)
    n_tris = int(tris.shape[0])

    w2v = camera.world_to_view()
    tan_y = torch.tan(camera.fov_y / 2.0)
    tan_x = tan_y * camera.aspect

    # per-triangle setup, vectorized over the triangles
    tv = verts[tris.reshape(-1)].reshape(n_tris, 3, 3)
    pv = froxel.transform_points(w2v, tv.reshape(-1, 3)).reshape(n_tris, 3,
                                                                 3)
    z = pv[:, :, 2]                                   # [T, 3] view z
    # pixel coordinates of each vertex (camera_rays inverted)
    sx = ((pv[:, :, 0] / (z * tan_x) + 1.0) * 0.5) * width - 0.5
    sy = ((pv[:, :, 1] / (z * tan_y) + 1.0) * 0.5) * height - 0.5
    inv_z = 1.0 / z
    # world-space face normal (the shading faces it toward the camera)
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    nrm = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                       e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                       e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
    nrm = nrm / torch.clamp(torch.sqrt(torch.sum(nrm * nrm, dim=-1,
                                                 keepdim=True)), min=1e-9)
    area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
             - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
    valid = (torch.amin(z, dim=1) > _Z_EPS) & (area2.abs() > 1e-8)
    inv_area = torch.where(valid, 1.0 / torch.where(
        valid, area2, torch.ones_like(area2)), torch.zeros_like(area2))

    # pad to a chunk multiple with invalid triangles
    n_pad = (-n_tris) % chunk

    def pad(a):
        return torch.cat([a, a.new_zeros((n_pad,) + a.shape[1:])]) \
            if n_pad else a

    sx, sy, inv_z, inv_area, t_alb, nrm = map(
        pad, (sx, sy, inv_z, inv_area, t_alb, nrm))
    valid = pad(valid)

    px = torch.arange(width, dtype=f32, device=dev)[None, :]     # [1, W]
    py = torch.arange(height, dtype=f32, device=dev)[:, None]    # [H, 1]
    big = torch.tensor(BIG, dtype=f32, device=dev)
    z_floor = torch.tensor(1.0 / BIG, dtype=f32, device=dev)
    depth = torch.full((height, width), BIG, dtype=f32, device=dev)
    albedo = torch.zeros((height, width, 3), dtype=f32, device=dev)
    normal = torch.zeros((height, width, 3), dtype=f32, device=dev)
    b = lambda a: a[:, None, None]                         # [K] -> [K, 1, 1]
    for c0 in range(0, n_tris + n_pad, chunk):
        k = slice(c0, c0 + chunk)
        x0, x1, x2 = b(sx[k, 0]), b(sx[k, 1]), b(sx[k, 2])
        y0, y1, y2 = b(sy[k, 0]), b(sy[k, 1]), b(sy[k, 2])
        # barycentrics normalized by the SIGNED area: both windings give
        # non-negative weights inside (double-sided)
        ia = b(inv_area[k])
        w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * ia
        w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * ia
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & b(valid[k])
        izp = (w0 * b(inv_z[k, 0]) + w1 * b(inv_z[k, 1])
               + w2 * b(inv_z[k, 2]))
        zp = 1.0 / torch.maximum(izp, z_floor)
        zc = torch.where(inside, zp, big)                    # [K, H, W]
        zmin = torch.amin(zc, dim=0)                         # [H, W]
        sel = (zc <= zmin[None]) & (zc < big)
        # exact-depth ties go to the first triangle: sel is one-hot
        sel &= torch.cumsum(sel.to(torch.int32), dim=0, dtype=torch.int32) \
            <= 1
        sel32 = sel.to(f32)
        alb_n = torch.zeros_like(albedo)
        nrm_n = torch.zeros_like(normal)
        for kk in range(chunk):
            alb_n = alb_n + sel32[kk][..., None] * t_alb[c0 + kk]
            nrm_n = nrm_n + sel32[kk][..., None] * nrm[c0 + kk]
        win = zmin < depth
        depth = torch.where(win, zmin, depth)
        albedo = torch.where(win[..., None], alb_n, albedo)
        normal = torch.where(win[..., None], nrm_n, normal)
    return albedo, normal, depth


def shade_mesh_gbuffer(albedo, normal, depth, camera_pos, ray_dirs, geom,
                       sun_dir, sun_color, ambient, shadow_bias: float = 1.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lambert-shade a rasterized G-buffer as ops/raycast.render_scene
    shades its hits: flat albedo, |N.L| from the sun (double-sided foliage
    transmits), and one any-hit shadow ray against the analytic occluders,
    the mesh's own proxy boxes included.

    shadow_bias: meters the shadow ray starts toward the sun. A mesh surface
    sits just inside its own proxy box, so an unbiased ray always hits it;
    skipping the first meter stands in for a shadow map's depth bias.

    Returns (color [H, W, 3], hit [H, W] bool)."""
    hit = depth < BIG
    # double-sided: the normal faces the camera
    facing = torch.sum(normal * ray_dirs, dim=-1, keepdim=True)
    n = normal * torch.where(facing > 0.0, -1.0, 1.0)
    hitp = camera_pos + torch.clamp(depth, max=1e8)[..., None] * ray_dirs
    ndl = torch.sum(n * (-sun_dir), dim=-1).abs()
    start = hitp + n * 1e-2 - sun_dir * shadow_bias
    shadow_t, _, _ = raycast.intersect(geom, start,
                                       (-sun_dir).expand(start.shape))
    lit = (shadow_t >= BIG).to(torch.float32)
    color = albedo * (ambient + sun_color * (ndl * lit)[..., None])
    return color, hit
