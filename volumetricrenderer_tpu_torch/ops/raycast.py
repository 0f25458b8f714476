"""Analytic ray casting over scene primitives: the G-buffer stand-in
(`volumetricrenderer_tpu/ops/raycast.py` `camera_rays`, `intersect`,
`render_scene`) as plain torch; it runs once per scene, not per frame, and
the shadow-map bakes cast through `intersect` too. And `occluded`, the
any-hit test of the plain shadow volume (`dir_shadow_impl="xla"`), with its
fractional-opacity form. The procedural heightfield is marched in both:
`intersect` takes 4 * hf_steps samples over the band the ray crosses, then 8
bisections and a finite-difference normal; `occluded` takes hf_steps
midpoint samples (the march of the kernels' any-hit, csrc/common.cuh)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.froxel import dot3, transform_dirs
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.ops.material import (heightfield_band,
                                                       heightfield_occluded,
                                                       heightfield_static,
                                                       pack_heightfield,
                                                       perlin_planes)

BIG = 1e9
EPS = 1e-4


def heightfield_height(geom: Geometry, x: torch.Tensor,
                       z: torch.Tensor) -> torch.Tensor:
    """Terrain height y(x, z) = base + amp * fBm(x, z), in [base,
    base + amp]."""
    u = x * geom.hf_tiling[0] + geom.hf_offset[0]
    v = z * geom.hf_tiling[1] + geom.hf_offset[1]
    return geom.hf_base + geom.hf_amp * perlin_planes(
        u, v, torch.zeros_like(u), geom.hf_octaves, geom.hf_period,
        geom.hf_seed)


def intersect(geom: Geometry, origins: torch.Tensor, dirs: torch.Tensor,
              include_proxies: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest hit along each ray: (t [...], albedo [..., 3],
    normal [..., 3]); t == BIG where nothing is hit. The terrain, last:
    4 * hf_steps samples over its band, the first crossing refined by 8
    bisections, its normal the finite difference of the height at
    +-0.1."""
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

    if geom.hf_enabled:
        t, normal = _hf_intersect(geom, origins, dirs)
        closer(t, geom.hf_albedo.expand(origins.shape), normal)
    return bt, ba, bn


def _hf_intersect(geom: Geometry, origins, dirs):
    """The terrain's (t [...], normal [..., 3]): t == BIG where the ray
    does not reach below the surface within its band."""
    lo, hi = heightfield_band(pack_heightfield(geom), heightfield_static(geom),
                              origins[..., 1], dirs[..., 1], geom.hf_far)
    valid = hi > lo

    def below(t):
        p = origins + t[..., None] * dirs
        return p[..., 1] < heightfield_height(geom, p[..., 0], p[..., 2])

    k = geom.hf_steps * 4
    in_prev = below(lo)
    found = in_prev & valid            # started inside: a hit at lo
    t_lo = t_hi = t_prev = lo
    for i in range(1, k + 1):
        t = lo + (hi - lo) * (float(np.float32(i)) / k)
        inside = below(t)
        new = valid & ~found & ~in_prev & inside
        t_lo = torch.where(new, t_prev, t_lo)
        t_hi = torch.where(new, t, t_hi)
        found = found | new
        t_prev, in_prev = t, inside
    for _ in range(8):
        tm = 0.5 * (t_lo + t_hi)
        im = below(tm)
        t_lo = torch.where(found & ~im, tm, t_lo)
        t_hi = torch.where(found & im, tm, t_hi)
    t = torch.where(found, t_hi, torch.full_like(t_hi, BIG))
    hitp = origins + t_hi[..., None] * dirs
    e = 0.1
    hx, hz = hitp[..., 0], hitp[..., 2]
    n = torch.stack([
        heightfield_height(geom, hx - e, hz)
        - heightfield_height(geom, hx + e, hz),
        torch.full_like(t_hi, 2.0 * e),
        heightfield_height(geom, hx, hz - e)
        - heightfield_height(geom, hx, hz + e)], dim=-1)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    return t, n


def occluded(geom: Geometry, points: torch.Tensor, to_light: torch.Tensor,
             max_dist, include_heightfield: bool = True) -> torch.Tensor:
    """1.0 where the segment points -> points + to_light * max_dist hits
    geometry. points [..., 3]; to_light a unit direction [3] or [..., 3];
    max_dist a float or [...]. Any-hit only. include_heightfield=False skips
    the terrain march (local-light rays without
    heightfield_local_shadows). With box_fractional: the occlusion amount
    1 - prod(1 - opacity_i * hit_i), boxes attenuating by their opacity."""
    if geom.box_fractional:
        return _occluded_fractional(geom, points, to_light, max_dist,
                                    include_heightfield)
    hit = torch.zeros(points.shape[:-1], dtype=torch.bool,
                      device=points.device)
    for h in _prim_hits(geom, points, to_light, max_dist):
        hit = hit | h
    for h in _box_hits(geom, points, to_light, max_dist):
        hit = hit | h
    if geom.hf_enabled and include_heightfield:
        hit = hit | _hf_occluded(geom, points, to_light, max_dist)
    return hit.to(torch.float32)


def _hf_occluded(geom: Geometry, origins, dirs, max_dist) -> torch.Tensor:
    """The terrain march of the kernels' any-hit (hf_steps midpoint samples
    of the band, clamped to min(max_dist, hf_far)), on [..., 3] rays."""
    o = [origins[..., c] for c in range(3)]
    d = [dirs[..., c] for c in range(3)]
    return heightfield_occluded(pack_heightfield(geom), heightfield_static(
        geom), *o, *d, max_dist)


def _occluded_fractional(geom: Geometry, points, to_light, max_dist,
                         include_heightfield: bool) -> torch.Tensor:
    """occluded's fractional-opacity form: planes, spheres and the terrain
    stay solid."""
    f32 = torch.float32
    trans = torch.ones(points.shape[:-1], dtype=f32, device=points.device)
    for h in _prim_hits(geom, points, to_light, max_dist):
        trans = trans * (1.0 - h.to(f32))
    for i, h in enumerate(_box_hits(geom, points, to_light, max_dist)):
        trans = trans * (1.0 - geom.box_opacity[i] * h.to(f32))
    if geom.hf_enabled and include_heightfield:
        trans = trans * (1.0 - _hf_occluded(geom, points, to_light,
                                            max_dist).to(f32))
    return 1.0 - trans


def _prim_hits(geom: Geometry, origins, dirs, max_dist):
    """Per plane, then per sphere: bool hits in (EPS, max_dist)."""
    for i in range(geom.plane_normal.shape[0]):
        n = geom.plane_normal[i]
        denom = dot3(dirs, n)
        t = -(dot3(origins, n) + geom.plane_d[i]) / torch.where(
            denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
        yield (t > EPS) & (t < max_dist) & (denom.abs() > 1e-9)
    for i in range(geom.sphere_center.shape[0]):
        oc = origins - geom.sphere_center[i]
        b = dot3(oc, dirs)
        cq = dot3(oc, oc) - geom.sphere_radius[i] ** 2
        disc = b * b - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = -b - sq
        t1 = -b + sq
        t = torch.where(t0 > EPS, t0, t1)
        yield (disc > 0.0) & (t > EPS) & (t < max_dist)


def _box_hits(geom: Geometry, origins, dirs, max_dist):
    """Per box: bool hits in (EPS, max_dist) (slab method)."""
    if not geom.box_min.shape[0]:
        return
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9),
                            dirs)
    for i in range(geom.box_min.shape[0]):
        t0s = (geom.box_min[i] - origins) * inv
        t1s = (geom.box_max[i] - origins) * inv
        tmin = torch.amax(torch.minimum(t0s, t1s), dim=-1)
        tmax = torch.amin(torch.maximum(t0s, t1s), dim=-1)
        t = torch.where(tmin > EPS, tmin, tmax)
        yield (tmax >= tmin) & (t > EPS) & (t < max_dist)


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
