"""Analytic ray casting over scene primitives: the G-buffer stand-in
(`volumetricrenderer_tpu/ops/raycast.py` `camera_rays`, `intersect`,
`render_scene`) as plain torch; it runs once per scene, not per frame. And
`occluded`, the any-hit test of the plain shadow volume
(`dir_shadow_impl="xla"`). The heightfield and fractional box opacity are
not ported: a geometry with either raises."""

from __future__ import annotations

from typing import Tuple

import torch

from volumetricrenderer_tpu_torch.froxel import dot3, transform_dirs
from volumetricrenderer_tpu_torch.models.geometry import Geometry

BIG = 1e9
EPS = 1e-4


def intersect(geom: Geometry, origins: torch.Tensor, dirs: torch.Tensor,
              include_proxies: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit along each ray: (t [...], albedo [..., 3],
    normal [..., 3]); t == BIG where nothing is hit."""
    if geom.hf_enabled:
        raise NotImplementedError("heightfield ray casting is not ported")
    shape = origins.shape[:-1]
    dev = origins.device
    bt = torch.full(shape, BIG, dtype=torch.float32, device=dev)
    ba = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)
    bn = torch.zeros(shape + (3,), dtype=torch.float32, device=dev)

    def closer(t, albedo, normal):
        nonlocal bt, ba, bn
        hit = t < bt
        bt = torch.where(hit, t, bt)
        ba = torch.where(hit[..., None], albedo, ba)
        bn = torch.where(hit[..., None], normal, bn)

    for i in range(geom.plane_normal.shape[0]):
        n = geom.plane_normal[i]
        denom = dot3(dirs, n)
        safe = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                           denom)
        t = -(dot3(origins, n) + geom.plane_d[i]) / safe
        t = torch.where((t > EPS) & (denom.abs() > 1e-9), t,
                        torch.full_like(t, BIG))
        closer(t, geom.plane_albedo[i].expand(origins.shape),
               n.expand(origins.shape))

    for i in range(geom.sphere_center.shape[0]):
        c = geom.sphere_center[i]
        r = geom.sphere_radius[i]
        oc = origins - c
        a = torch.sum(dirs * dirs, dim=-1)
        b = torch.sum(oc * dirs, dim=-1)
        cq = torch.sum(oc * oc, dim=-1) - r * r
        disc = b * b - a * cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / a
        t1 = (-b + sq) / a
        t = torch.where(t0 > EPS, t0, t1)
        t = torch.where((disc > 0.0) & (t > EPS), t, torch.full_like(t, BIG))
        hitp = origins + t[..., None] * dirs
        closer(t, geom.sphere_albedo[i].expand(origins.shape),
               (hitp - c) / r)

    n_box = geom.box_min.shape[0]
    if not include_proxies:
        n_box -= geom.n_proxy_boxes
    for i in range(n_box):
        safe = torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9),
                           dirs)
        inv = 1.0 / safe
        t0s = (geom.box_min[i] - origins) * inv
        t1s = (geom.box_max[i] - origins) * inv
        tsm = torch.minimum(t0s, t1s)
        tbg = torch.maximum(t0s, t1s)
        tmin = torch.amax(tsm, dim=-1)
        tmax = torch.amin(tbg, dim=-1)
        t = torch.where(tmin > EPS, tmin, tmax)
        t = torch.where((tmax >= tmin) & (t > EPS), t,
                        torch.full_like(t, BIG))
        axis_hit = (tsm == tmin[..., None]).to(torch.float32)
        normal = -torch.sign(dirs) * axis_hit
        nl = torch.linalg.norm(normal, dim=-1, keepdim=True)
        normal = normal / torch.clamp(nl, min=1e-9)
        closer(t, geom.box_albedo[i].expand(origins.shape), normal)

    return bt, ba, bn


def occluded(geom: Geometry, points: torch.Tensor, to_light: torch.Tensor,
             max_dist) -> torch.Tensor:
    """1.0 where the segment points -> points + to_light * max_dist hits
    geometry. points [..., 3]; to_light a unit direction [3] or [..., 3];
    max_dist a float or [...]. Any-hit only."""
    if geom.hf_enabled:
        raise NotImplementedError("heightfield occlusion is not ported")
    if geom.box_fractional:
        raise NotImplementedError("fractional box opacity is not ported")
    origins, dirs = points, to_light
    hit = torch.zeros(points.shape[:-1], dtype=torch.bool,
                      device=points.device)
    for i in range(geom.plane_normal.shape[0]):
        n = geom.plane_normal[i]
        denom = dot3(dirs, n)
        t = -(dot3(origins, n) + geom.plane_d[i]) / torch.where(
            denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        hit = hit | ((t > EPS) & (t < max_dist) & (denom.abs() > 1e-9))
    for i in range(geom.sphere_center.shape[0]):
        oc = origins - geom.sphere_center[i]
        b = dot3(oc, dirs)
        cq = dot3(oc, oc) - geom.sphere_radius[i] ** 2
        disc = b * b - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > EPS, t0, t1)
        hit = hit | ((disc > 0.0) & (t > EPS) & (t < max_dist))
    if geom.box_min.shape[0]:
        inv = 1.0 / torch.where(dirs.abs() < 1e-9,
                                torch.full_like(dirs, 1e-9), dirs)
        for i in range(geom.box_min.shape[0]):
            t0s = (geom.box_min[i] - origins) * inv
            t1s = (geom.box_max[i] - origins) * inv
            tmin = torch.amax(torch.minimum(t0s, t1s), dim=-1)
            tmax = torch.amin(torch.maximum(t0s, t1s), dim=-1)
            t = torch.where(tmin > EPS, tmin, tmax)
            hit = hit | ((tmax >= tmin) & (t > EPS) & (t < max_dist))
    return hit.to(torch.float32)


def camera_rays(width: int, height: int, fov_y: torch.Tensor,
                aspect: torch.Tensor, view_to_world: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel world ray directions with unit view-space z, and screen uv
    (origin bottom-left, pixel centers). Returns ([H, W, 3], [H, W, 2])."""
    dev = view_to_world.device
    u = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5) / height
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    tan_y = torch.tan(fov_y / 2.0)
    tan_x = tan_y * aspect
    vx = (2.0 * uu - 1.0) * tan_x
    vy = (2.0 * vv - 1.0) * tan_y
    view_dirs = torch.stack([vx, vy, torch.ones_like(vx)], dim=-1)
    return transform_dirs(view_to_world, view_dirs), \
        torch.stack([uu, vv], dim=-1)


def render_scene(geom: Geometry, camera_pos: torch.Tensor,
                 ray_dirs: torch.Tensor, sun_dir: torch.Tensor,
                 sun_color: torch.Tensor, ambient: torch.Tensor,
                 far: torch.Tensor, skip_proxy_boxes: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lambert shading with one sun shadow ray: (color [H, W, 3],
    linear view depth [H, W]); misses get depth = far and sky colour."""
    origins = camera_pos.expand(ray_dirs.shape)
    t, albedo, normal = intersect(geom, origins, ray_dirs,
                                  include_proxies=not skip_proxy_boxes)
    hit = t < BIG
    depth = torch.where(hit, t, far)
    hitp = origins + torch.minimum(t, far)[..., None] * ray_dirs
    ndl = torch.clamp(torch.sum(normal * (-sun_dir), dim=-1), min=0.0)
    shadow_t, _, _ = intersect(geom, hitp + normal * 1e-3,
                               (-sun_dir).expand(hitp.shape))
    lit = (shadow_t >= BIG).to(torch.float32)
    color = albedo * (ambient + sun_color * (ndl * lit)[..., None])
    sky = torch.tensor([0.35, 0.45, 0.65], dtype=torch.float32,
                       device=ray_dirs.device) * torch.clamp(
        ray_dirs[..., 1:2] * 0.5 + 0.7, 0.3, 1.0)
    color = torch.where(hit[..., None], color, sky)
    return color, depth
