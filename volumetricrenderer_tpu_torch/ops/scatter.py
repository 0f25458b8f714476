"""In-scatter at the froxels: packed light tables and the radiance +
directional-fold form of the per-slice scatter.

Plain-torch twins of `volumetricrenderer_tpu/ops/pallas/scatter.py`
(`pack_lights`, `pack_dir_lights`, `pack_params`, `light_factor`,
`scatter_slice` with scatter_bake="radiance" and the fused material); the
CUDA counterparts are `light_factor` in `csrc/common.cuh` and the scatter
stage of `csrc/shadow_scatter.cu`.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.dir_shadow import froxel_world
from volumetricrenderer_tpu_torch.ops.material import material_planes
from volumetricrenderer_tpu_torch.ops.phase import PI


def pack_lights(point_lights, spot_lights) -> torch.Tensor:
    """[NL, 16] rows: pos(3) color(3) range mult is_spot sdir(3)
    cos_outer cos_inner_rcp shadow_gate pad."""
    dev = point_lights.position.device
    f = lambda n, v: torch.full((n, 1), v, dtype=torch.float32, device=dev)
    n = point_lights.count
    pts = torch.cat([
        point_lights.position, point_lights.packed_color,
        point_lights.range[:, None],
        point_lights.intensity_multiplier[:, None], f(n, 0.0),
        torch.zeros((n, 3), dtype=torch.float32, device=dev), f(n, 1.0),
        f(n, 1.0), point_lights.has_shadow.to(torch.float32)[:, None],
        f(n, 0.0)], dim=1)
    n = spot_lights.count
    spots = torch.cat([
        spot_lights.position, spot_lights.packed_color,
        spot_lights.range[:, None],
        spot_lights.intensity_multiplier[:, None], f(n, 1.0),
        spot_lights.direction, spot_lights.cos_outer_cone[:, None],
        spot_lights.cos_inner_cone_rcp[:, None],
        spot_lights.has_shadow.to(torch.float32)[:, None], f(n, 0.0)], dim=1)
    return torch.cat([pts, spots], dim=0)


def pack_dir_lights(dir_lights) -> torch.Tensor:
    """[Nd, 8] rows: direction(3) packed_color(3) pad(2)."""
    z = torch.zeros((dir_lights.count, 2), dtype=torch.float32,
                    device=dir_lights.direction.device)
    return torch.cat([dir_lights.direction, dir_lights.packed_color, z], dim=1)


def pack_params(params, view_to_world, camera_pos, jitter) -> torch.Tensor:
    """[1, 24]: v2w rows (12), fp.x fp.y fp.z fp.w near, jitter(3), cam(3),
    y0."""
    m = view_to_world
    dev = m.device
    jit = upload(np.asarray(jitter, np.float32).reshape(3), dev)
    vals = [m[:3].reshape(12),
            torch.stack([params.x, params.y, params.z, params.w,
                         params.near]).to(dev),
            jit, camera_pos.to(dev),
            torch.full((1,), float(params.y0), dtype=torch.float32,
                       device=dev)]
    return torch.cat(vals).to(torch.float32)[None]


def light_factor(q, wx, wy, wz, vdx, vdy, vdz, phg, g2, hg_num):
    """HG phase x falloff x spot cone x range cull for one packed light row
    (accessor q). Returns (factor, ldx, ldy, ldz, dist, shadow_gate,
    cr, cg, cb)."""
    lx_, ly_, lz_ = q(0), q(1), q(2)
    cr, cg, cb = q(3), q(4), q(5)
    rng, mult, is_spot = q(6), q(7), q(8)
    sdx, sdy, sdz = q(9), q(10), q(11)
    cos_outer, cos_inner_rcp, shadow_gate = q(12), q(13), q(14)

    tx = wx - lx_
    ty = wy - ly_
    tz = wz - lz_
    d2 = tx * tx + ty * ty + tz * tz
    inv_d = torch.rsqrt(d2 + 1e-18)
    dist = d2 * inv_d
    ldx, ldy, ldz = tx * inv_d, ty * inv_d, tz * inv_d

    x = d2 / (rng * rng)
    fall = torch.clamp((1.0 - x) * 5.0, 0.0, 1.0) / (1.0 + 25.0 * x) * mult
    cos_angle = ldx * sdx + ldy * sdy + ldz * sdz
    cone_den = torch.clamp(cos_outer - 1.0 / cos_inner_rcp, max=-1e-9)
    t_cone = torch.clamp((cos_angle - 1.0 / cos_inner_rcp) / cone_den,
                         0.0, 1.0)
    cone = 1.0 - t_cone * t_cone * (3.0 - 2.0 * t_cone)
    keep_spot = (cos_angle >= cos_outer).to(torch.float32)
    fall = fall * (1.0 - is_spot + is_spot * cone * keep_spot)
    fall = fall * (dist <= rng).to(torch.float32)

    cos_t = -(vdx * ldx + vdy * ldy + vdz * ldz)
    b = 1.0 + g2 - 2.0 * phg * cos_t
    rb = torch.rsqrt(b)
    return hg_num * rb * rb * rb * fall, ldx, ldy, ldz, dist, shadow_gate, \
        cr, cg, cb


def scatter_slice(par, dirs, med, media_static: tuple, zi,
                  shadow_planes: Sequence[torch.Tensor],
                  radiance_planes: Sequence[torch.Tensor],
                  noise_planes, *, grid_whd: Tuple[int, int, int],
                  n_dir: int, h_glob: int, jitter_dir: bool = False):
    """Scatter planes (ar, ag, ab, ext) at slice(s) zi in radiance mode:
    the upsampled low-rate local-light radiance (rgb) times sigma_s, plus
    each sun's colour x blended shadow x HG phase x sigma_s at the UNJITTERED
    froxel centre (jitter_dir=False), and the luma extinction
    ext = (0.3 sr + 0.59 sg + 0.11 sb + sa) * n_dir. The material is
    evaluated at the jittered world position, its fBm factor taken from the
    upsampled noise_planes (None: evaluated here)."""
    p = lambda i: par[0, i]
    camx, camy, camz = p(20), p(21), p(22)
    wx, wy, wz = froxel_world(par, zi, grid_whd, h_glob)
    sr, sg, sb, s_a, phg = material_planes(med, media_static, wx, wy, wz,
                                           noise_planes=noise_planes)
    ext = (0.3 * sr + 0.59 * sg + 0.11 * sb + s_a) * float(n_dir)
    g2 = phg * phg
    hg_num = (1.0 - g2) / (4.0 * PI)
    ar = radiance_planes[0] * sr
    ag = radiance_planes[1] * sg
    ab = radiance_planes[2] * sb
    if n_dir:
        if jitter_dir:
            cwx, cwy, cwz = wx, wy, wz
        else:
            cwx, cwy, cwz = froxel_world(par, zi, grid_whd, h_glob,
                                         jittered=False)
        dvx = cwx - camx
        dvy = cwy - camy
        dvz = cwz - camz
        inv_dv = torch.rsqrt(dvx * dvx + dvy * dvy + dvz * dvz + 1e-18)
        dvx, dvy, dvz = dvx * inv_dv, dvy * inv_dv, dvz * inv_dv
        for li in range(n_dir):
            q = lambda i: dirs[li, i]
            cos_t = -(dvx * q(0) + dvy * q(1) + dvz * q(2))
            b = 1.0 + g2 - 2.0 * phg * cos_t
            rb = torch.rsqrt(b)
            hg = hg_num * rb * rb * rb
            base = shadow_planes[li] * hg
            ar = ar + base * q(3) * sr
            ag = ag + base * q(4) * sg
            ab = ab + base * q(5) * sb
    return ar, ag, ab, ext
