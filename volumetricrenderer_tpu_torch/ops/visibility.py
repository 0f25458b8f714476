"""The low-rate local-light bakes (radiance + fBm, or per-light
visibility) and their upsample.

Plain-torch twins of `volumetricrenderer_tpu/ops/pallas/visibility.py`
(`low_res_dims`, `upsample_mats`, `low_slice_active`, `bake_world_planes`,
`radiance_view_dirs`, `bake_radiance_plane`, `bake_light_plane`) and of the
z-lerp + separable tent upsample of `scatter_slice`. The CUDA counterparts
are in `csrc/bake_radiance.cu` (kernel K1, which stands for
`bake_radiance_pallas` and for the megakernel's inline bake;
`bake_radiance_fused` below gives it the JAX function's signature),
`csrc/bake_visibility.cu` (kernel K9, which stands for
`bake_visibility_pallas`; wrapper `bake_visibility` below) and
`upsample_low` in `csrc/common.cuh`.

Grid contract: low cell k covers full cells [ss*k, ss*k + ss); its sample
sits at full coordinate ss*k + (ss-1)/2 (+0.5 + jitter). The z-lerp reads
low slices floor(u), floor(u)+1 with u = (z - (ss-1)/2)/ss, clamped; the xy
tent is clamp-to-edge. The slab y-phase is 0 (the port renders whole grids).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel as froxel_lib
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.occlude import any_hit
from volumetricrenderer_tpu_torch.ops.scatter import light_factor


def low_res_dims(grid_whd: Tuple[int, int, int], ss: int):
    w, h, d = grid_whd
    return (-(-w // ss), -(-h // ss), -(-d // ss))        # (WL, HL, DL)


def upsample_mats(n: int, nl: int, ss: int) -> np.ndarray:
    """[n, nl] float32 tent weights with clamp-to-edge."""
    a = np.zeros((n, nl), np.float32)
    for i in range(n):
        u = (i - (ss - 1) / 2.0) / ss
        k = int(np.floor(u))
        t = u - k
        if k < 0:
            k, t = 0, 0.0
        if k >= nl - 1:
            k, t = nl - 1, 0.0
        a[i, k] += 1.0 - t
        if t > 0.0:
            a[i, k + 1] += t
    return a


def tent_taps(n: int, nl: int, ss: int):
    """upsample_mats as two taps per output: (k0 int32 [n], w [2, n]) with
    the second tap at min(k0 + 1, nl - 1)."""
    a = upsample_mats(n, nl, ss)
    k0 = np.argmax(a > 0, axis=1).astype(np.int32)
    k1 = np.minimum(k0 + 1, nl - 1)
    w0 = a[np.arange(n), k0]
    w1 = np.where(k1 > k0, a[np.arange(n), k1], 0.0).astype(np.float32)
    return k0, np.stack([w0, w1]).astype(np.float32)


def low_slice_active(params, view_to_world, positions, ranges,
                     grid_whd: Tuple[int, int, int], ss: int) -> torch.Tensor:
    """[NL, DL] bool: does the world AABB of the full slices that read low
    slice k ([ss*k - ss, ss*k + 2*ss], padded for the jitter) intersect
    light li's range sphere? Skipping an inactive light is exact."""
    w, h, d = grid_whd
    wl, hl, dl = low_res_dims(grid_whd, ss)
    h_glob = params.grid[1]
    dev = positions.device
    y0 = float(params.y0)
    ks = torch.arange(dl, dtype=torch.float32, device=dev)
    z0 = torch.clamp(ss * ks - ss, 0.0, float(d))
    z1 = torch.clamp(ss * ks + 2.0 * ss, 0.0, float(d))
    xs = upload([0.0, float(w)], dev)
    ys = upload([min(max(y0, 0.0), float(h_glob)),
                 min(max(y0 + h + (ss - 1), 0.0), float(h_glob))], dev)
    fx, fy = torch.meshgrid(xs, ys, indexing="ij")
    fx = fx.reshape(1, 4).expand(dl, 4)
    fy = fy.reshape(1, 4).expand(dl, 4)
    corners = [torch.stack([fx, fy, fz[:, None].expand(dl, 4)], dim=-1)
               for fz in (z0, z1)]
    fro = torch.cat(corners, dim=1)                        # [DL, 8, 3]
    world = froxel_lib.transform_points(
        view_to_world, froxel_lib.froxel_to_view(params, fro))
    lo = torch.amin(world, dim=1)
    hi = torch.amax(world, dim=1)
    nearest = torch.clamp(positions[:, None], lo[None], hi[None])
    diff = nearest - positions[:, None]
    d2 = torch.sum(diff * diff, dim=-1)
    return d2 <= (ranges[:, None] ** 2)                    # [NL, DL]


def bake_world_planes(par, zi, grid_whd: Tuple[int, int, int], ss: int,
                      h_glob: int):
    """[HL, WL] jittered world-position planes of low slice(s) zi (an int or
    an int tensor broadcasting against [HL, WL])."""
    w, h, d = grid_whd
    wl, hl, dl = low_res_dims(grid_whd, ss)
    p = lambda i: par[0, i]
    fpx, fpy, fpz, fpw, near = p(12), p(13), p(14), p(15), p(16)
    jx, jy, jz = p(17), p(18), p(19)
    y0 = p(23)
    dev = par.device
    off = (ss - 1) * 0.5
    phase = (-float(y0)) % float(ss)
    zf = torch.as_tensor(zi, device=dev).to(torch.float32)
    fz = float(ss) * zf + off + 0.5 + jz
    vz = (torch.exp(torch.log(fpz) * fz / d) - 1.0) * fpw + near
    xs = torch.arange(wl, dtype=torch.float32, device=dev)[None, :] \
        * float(ss) + off
    ys = torch.arange(hl, dtype=torch.float32, device=dev)[:, None] \
        * float(ss) + off + phase
    ys = torch.clamp(ys + y0, 0.0, h_glob - 1.0)
    vx = (2.0 * (xs + 0.5 + jx) / w - 1.0) * vz / fpx
    vy = (2.0 * (ys + 0.5 + jy) / h_glob - 1.0) * vz / fpy
    wx = p(0) * vx + p(1) * vy + p(2) * vz + p(3)
    wy = p(4) * vx + p(5) * vy + p(6) * vz + p(7)
    wz = p(8) * vx + p(9) * vy + p(10) * vz + p(11)
    return wx, wy, wz


def radiance_view_dirs(par, wx, wy, wz):
    """Normalized camera -> sample directions (camera at par[0, 20:23])."""
    vdx = wx - par[0, 20]
    vdy = wy - par[0, 21]
    vdz = wz - par[0, 22]
    inv = torch.rsqrt(vdx * vdx + vdy * vdy + vdz * vdz + 1e-18)
    return vdx * inv, vdy * inv, vdz * inv


def bake_radiance_plane(lights, li, wx, wy, wz, vdx, vdy, vdz, phg, g2,
                        hg_num, planes, spheres, boxes, *, n_planes: int,
                        n_spheres: int, n_boxes: int):
    """One light's rgb radiance at the low samples: visibility x falloff x
    cone x HG phase x colour (everything but the froxel's sigma_s)."""
    q = lambda i: lights[li, i]
    factor, ldx, ldy, ldz, dist, gate, cr, cg, cb = light_factor(
        q, wx, wy, wz, vdx, vdy, vdz, phg, g2, hg_num)
    occ = any_hit(planes, spheres, boxes, wx, wy, wz, -ldx, -ldy, -ldz,
                  dist - 0.05, n_planes=n_planes, n_spheres=n_spheres,
                  n_boxes=n_boxes)
    base = factor * (1.0 - occ.to(torch.float32) * gate)
    return base * cr, base * cg, base * cb


def bake_light_plane(lights, li, wx, wy, wz, planes, spheres, boxes, *,
                     n_planes: int, n_spheres: int, n_boxes: int):
    """Visibility (1 = lit) of light row li at world positions: one any-hit
    ray to the light, gated by the light's has_shadow."""
    q = lambda i: lights[li, i]
    tx = wx - q(0)
    ty = wy - q(1)
    tz = wz - q(2)
    d2 = tx * tx + ty * ty + tz * tz
    inv_d = torch.rsqrt(d2 + 1e-18)
    dist = d2 * inv_d
    occ = any_hit(planes, spheres, boxes, wx, wy, wz, -tx * inv_d,
                  -ty * inv_d, -tz * inv_d, dist - 0.05, n_planes=n_planes,
                  n_spheres=n_spheres, n_boxes=n_boxes)
    return 1.0 - occ.to(torch.float32) * q(14)


def upsample_low(vol: torch.Tensor, zi, ss: int, tx, ty) -> torch.Tensor:
    """z-lerp + separable tent upsample of low volume channels
    vol [C, DL, HL, WL] to full slice(s) zi: an int -> [C, H, W]; a
    [D, 1, 1] int tensor -> [C, D, H, W]. tx/ty: tent_taps of x and y as
    (k0 long tensor, w [2, n] tensor) on vol's device."""
    dl = vol.shape[1]
    zf = torch.as_tensor(zi, device=vol.device).to(torch.float32)
    zf = zf.reshape(-1) if zf.dim() else zf
    vu = (zf - (ss - 1) * 0.5) / ss
    vkf = torch.clamp(torch.floor(vu), 0.0, dl - 1.0)
    vt = torch.clamp(vu - vkf, 0.0, 1.0)
    ka = vkf.to(torch.long)
    kb = torch.clamp(ka + 1, max=dl - 1)
    va, vb = vol[:, ka], vol[:, kb]
    if zf.dim():
        vt = vt[:, None, None]
    low = va + vt * (vb - va)                      # [C, (D,) HL, WL]
    kx, wxt = tx[0].long(), tx[1]
    kx1 = torch.clamp(kx + 1, max=vol.shape[3] - 1)
    lowx = low[..., kx] * wxt[0] + low[..., kx1] * wxt[1]
    ky, wyt = ty[0].long(), ty[1]
    ky1 = torch.clamp(ky + 1, max=vol.shape[2] - 1)
    return lowx[..., ky, :] * wyt[0][:, None] + lowx[..., ky1, :] \
        * wyt[1][:, None]


def bake_radiance_fused(params, view_to_world, camera_pos, jitter,
                        point_lights, spot_lights, geometry, media, time_x,
                        grid_whd: Tuple[int, int, int], ss: int,
                        bake_noise: bool = False,
                        device="cuda") -> torch.Tensor:
    """`bake_radiance_pallas` of the JAX package on kernel K1: packs the
    tables K1 reads on the CPU (where the scene description must lie) and
    runs ops/frame_fused.bake_radiance on `device`. Returns
    [3 (+ noise media), DL, HL, WL]."""
    from volumetricrenderer_tpu_torch.ops import frame_fused
    tables = frame_fused.frame_tables(
        params, view_to_world, torch.eye(4), jitter, 0.0, None, point_lights,
        spot_lights, geometry, media, time_x, camera_pos, grid_whd, 1, ss,
        bake_noise=bake_noise)
    if torch.device(device).type != "cpu":
        tables = tables.to(device)
    return frame_fused.bake_radiance(tables)


# --------------------------------------------------------------------------
# K9 bake_visibility (csrc/bake_visibility.cu)
# --------------------------------------------------------------------------

def _check_bake_tables(t) -> None:
    if t.ss < 2 or t.active is None or t.lights is None or t.planes is None:
        raise ValueError("the visibility bake needs the low grid, the local "
                         "lights and the geometry: pack the frame tables "
                         "with vis_ss > 1")


def bake_visibility_plain(t) -> torch.Tensor:
    """Twin of K9: [NL, DL, HL, WL] per-light visibility (1 = lit) at the
    low samples of one frame's tables (ops/frame_fused.FrameTables), light
    order of pack_lights. (light, low slice) pairs that low_slice_active
    culls are written 1: the scatter's range cull zeroes them anyway."""
    _check_bake_tables(t)
    wl, hl, dl = t.low_dims
    ms = torch.arange(dl, device=t.spar.device)[:, None, None]
    wx, wy, wz = bake_world_planes(t.spar, ms, t.grid_whd, t.ss, t.h_glob)
    out = []
    for li in range(t.lights.shape[0]):
        vis = bake_light_plane(t.lights, li, wx, wy, wz, t.planes, t.spheres,
                               t.boxes, n_planes=t.n_planes,
                               n_spheres=t.n_spheres, n_boxes=t.n_boxes)
        act = t.active[li].bool()[:, None, None]
        out.append(torch.where(act, vis, torch.ones_like(vis)))
    return torch.stack(out)


def bake_visibility(t) -> torch.Tensor:
    """K9: the low-rate per-light visibility volume [NL, DL, HL, WL]."""
    if t.spar.device.type == "cpu":
        return bake_visibility_plain(t)
    _check_bake_tables(t)
    wl, hl, dl = t.low_dims
    out = torch.empty((t.lights.shape[0], dl, hl, wl), dtype=torch.float32,
                      device=t.spar.device)
    st = t.c_struct()
    cuda.launch("bake_visibility", cuda.ctypes.byref(st), cuda.ptr(out))
    return out


def bake_visibility_fused(params, view_to_world, camera_pos, jitter,
                          point_lights, spot_lights, geometry,
                          grid_whd: Tuple[int, int, int], ss: int,
                          device="cuda") -> torch.Tensor:
    """`bake_visibility_pallas` of the JAX package on kernel K9: packs the
    tables K9 reads on the CPU (where the scene description must lie) and
    runs bake_visibility on `device`."""
    from volumetricrenderer_tpu_torch.ops import frame_fused
    tables = frame_fused.frame_tables(
        params, view_to_world, torch.eye(4), jitter, 0.0, None, point_lights,
        spot_lights, geometry, None, 0.0, camera_pos, grid_whd, 1, ss,
        bake_noise=False)
    if torch.device(device).type != "cpu":
        tables = tables.to(device)
    return bake_visibility(tables)
