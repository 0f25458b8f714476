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
`bake_visibility_pallas`: a run of a low slice's samples a block, its
lights spread over warps, `k9_geometry`; wrapper `bake_visibility` below)
and
`upsample_low` in `csrc/common.cuh`. `bake_noise_channels` (plain torch,
as JAX's `bake_noise_channels_xla` is plain XLA) gives the noise factors at the low grid that ride
K1's radiance into the fused frame when a medium samples a noise texture.

Grid contract: low cell k covers full cells [ss*k, ss*k + ss); its sample
sits at full coordinate ss*k + (ss-1)/2 (+0.5 + jitter). The z-lerp reads
low slices floor(u), floor(u)+1 with u = (z - (ss-1)/2)/ss, clamped; the xy
tent is clamp-to-edge. A slab of an H-sharded frame (parallel/shard_render.py)
starts at global row y0: its low rows sit at local rows ss*k + (ss-1)/2 +
y_phase(y0, ss), on the global ss-grid whatever y0 is, and its y tent
(upsample_mats_y) carries the same phase; y0 = 0 has phase 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel as froxel_lib
from volumetricrenderer_tpu_torch import shadow as shadow_lib
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.material import (noise_factor_planes,
                                                       noise_src, pack_media,
                                                       phase_g_plane)
from volumetricrenderer_tpu_torch.ops.noise import sample_noise
from volumetricrenderer_tpu_torch.ops.occlude import any_hit
from volumetricrenderer_tpu_torch.ops.phase import PI
from volumetricrenderer_tpu_torch.ops.scatter import (light_factor,
                                                      pack_lights)


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


def y_phase(y0, ss: int) -> np.float32:
    """The slab y-phase: (-y0) mod ss in float32, the local row offset that
    puts a slab's low rows on the global ss-grid (JAX `y_phase`)."""
    return np.mod(-np.float32(y0), np.float32(ss))


def upsample_mats_y(n: int, nl: int, ss: int, y0) -> np.ndarray:
    """[n, nl] float32 y tent of a slab starting at global row y0 (JAX
    `upsample_mats_y`): low sample k at local row ss*k + (ss-1)/2 +
    y_phase(y0, ss), clamp-to-edge, every step in float32 in JAX's
    order."""
    f32 = np.float32
    ph = y_phase(y0, ss)
    i = np.arange(n, dtype=f32)
    u = np.clip((i - f32((ss - 1) * 0.5) - ph) / f32(ss), f32(0.0),
                f32(nl - 1))
    j = np.arange(nl, dtype=f32)
    return np.maximum(f32(0.0), f32(1.0) - np.abs(u[:, None] - j[None, :]))


def _two_taps(a: np.ndarray, nl: int):
    n = a.shape[0]
    k0 = np.argmax(a > 0, axis=1).astype(np.int32)
    k1 = np.minimum(k0 + 1, nl - 1)
    w0 = a[np.arange(n), k0]
    w1 = np.where(k1 > k0, a[np.arange(n), k1], 0.0).astype(np.float32)
    return k0, np.stack([w0, w1]).astype(np.float32)


def tent_taps(n: int, nl: int, ss: int):
    """upsample_mats as two taps per output: (k0 int32 [n], w [2, n]) with
    the second tap at min(k0 + 1, nl - 1)."""
    return _two_taps(upsample_mats(n, nl, ss), nl)


def tent_taps_y(n: int, nl: int, ss: int, y0):
    """upsample_mats_y of a slab starting at y0 as tent_taps' two taps."""
    return _two_taps(upsample_mats_y(n, nl, ss, y0), nl)


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
    an int tensor broadcasting against [HL, WL]). par: a pack_params table
    ([1, 24], the phase taken from its y0 par[0, 23]) or the frame tables'
    spar ([1, 25], the slab y-phase packed at par[0, 24])."""
    w, h, d = grid_whd
    wl, hl, dl = low_res_dims(grid_whd, ss)
    p = lambda i: par[0, i]
    fpx, fpy, fpz, fpw, near = p(12), p(13), p(14), p(15), p(16)
    jx, jy, jz = p(17), p(18), p(19)
    y0 = p(23)
    dev = par.device
    off = (ss - 1) * 0.5
    phase = p(24) if par.shape[1] > 24 else float(y_phase(float(y0), ss))
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
                        n_spheres: int, n_boxes: int, hf=None,
                        hf_static=None, fractional: bool = False):
    """One light's rgb radiance at the low samples: visibility x falloff x
    cone x HG phase x colour (everything but the froxel's sigma_s). The
    any-hit's terrain and fractional arms as in ops/occlude.any_hit."""
    q = lambda i: lights[li, i]
    factor, ldx, ldy, ldz, dist, gate, cr, cg, cb = light_factor(
        q, wx, wy, wz, vdx, vdy, vdz, phg, g2, hg_num)
    occ = any_hit(planes, spheres, boxes, wx, wy, wz, -ldx, -ldy, -ldz,
                  dist - 0.05, n_planes=n_planes, n_spheres=n_spheres,
                  n_boxes=n_boxes, hf=hf, hf_static=hf_static,
                  fractional=fractional)
    base = factor * (1.0 - occ.to(torch.float32) * gate)
    return base * cr, base * cg, base * cb


def bake_light_plane(lights, li, wx, wy, wz, planes, spheres, boxes, *,
                     n_planes: int, n_spheres: int, n_boxes: int, hf=None,
                     hf_static=None, fractional: bool = False):
    """Visibility (1 = lit) of light row li at world positions: one any-hit
    ray to the light (terrain and fractional arms as in
    ops/occlude.any_hit), gated by the light's has_shadow."""
    q = lambda i: lights[li, i]
    tx = wx - q(0)
    ty = wy - q(1)
    tz = wz - q(2)
    d2 = tx * tx + ty * ty + tz * tz
    inv_d = torch.rsqrt(d2 + 1e-18)
    dist = d2 * inv_d
    occ = any_hit(planes, spheres, boxes, wx, wy, wz, -tx * inv_d,
                  -ty * inv_d, -tz * inv_d, dist - 0.05, n_planes=n_planes,
                  n_spheres=n_spheres, n_boxes=n_boxes, hf=hf,
                  hf_static=hf_static, fractional=fractional)
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
                        heightfield_shadows: bool = False,
                        device="cuda") -> torch.Tensor:
    """`bake_radiance_pallas` of the JAX package on kernel K1: packs the
    tables K1 reads on the CPU (where the scene description must lie) and
    runs ops/frame_fused.bake_radiance on `device`. Returns
    [3 (+ noise media), DL, HL, WL]."""
    from volumetricrenderer_tpu_torch.ops import frame_fused
    tables = frame_fused.frame_tables(
        params, view_to_world, torch.eye(4), jitter, 0.0, None, point_lights,
        spot_lights, geometry, media, time_x, camera_pos, grid_whd, 1, ss,
        bake_noise=bake_noise, heightfield_local=heightfield_shadows)
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
                               t.boxes, **t.occluders(local=True))
        act = t.active[li].bool()[:, None, None]
        out.append(torch.where(act, vis, torch.ones_like(vis)))
    return torch.stack(out)


# K9's launch (csrc/bake_visibility.cu): a block of K9_WARPS warps owns a
# run of consecutive samples of one low slice, its lights spread over light
# groups of warps.
K9_WARPS = 4


@dataclasses.dataclass(frozen=True)
class K9Geometry:
    blocks: int
    threads: int
    samples: int       # a block's run (a light group's warps x 32)
    groups: int        # light groups: group g takes lights g, g + groups, ...
    runs: int          # runs a low slice
    shared_bytes: int  # static: the samples' world positions


def k9_geometry(n_lights: int,
                low_dims: Tuple[int, int, int]) -> K9Geometry:
    """Mirror of csrc/bake_visibility.cu vr_bake_visibility_geometry: K9's
    launch for the low grid (WL, HL, DL). Its light groups are the least
    power of two that takes every light, at most K9_WARPS; the warps of a
    group hold consecutive runs of 32 samples of the slice (row-major), the
    lanes past the slice's last sample masked."""
    wl, hl, dl = low_dims
    groups = 1
    while groups < n_lights and groups < K9_WARPS:
        groups *= 2
    samples = 32 * (K9_WARPS // groups)
    runs = -(-(wl * hl) // samples)
    return K9Geometry(blocks=runs * dl, threads=32 * K9_WARPS,
                      samples=samples, groups=groups, runs=runs,
                      shared_bytes=4 * 3 * 32 * K9_WARPS)


def k9_form(t, form: Optional[str] = None) -> str:
    """Mirror of csrc/bake_visibility.cu k9_form: the index form of
    cuda.INDEX_FORMS that K9 takes. Its blocks are a 1-D grid, so no slice
    count limits it. The narrow form takes a [NL, DL, HL, WL] volume (and
    with it the cull table [NL, DL]) under 2^31 floats; the wide form any
    size on at most 2^31 - 1 blocks, a low slice's runs under 2^31 samples
    and the lights table [NL, 16] under 2^31 floats. form: a form to force.
    Raises ValueError (cuda.index_form), naming K9, before the launch."""
    n_lights = t.lights.shape[0]
    wl, hl, dl = t.low_dims
    geo = k9_geometry(n_lights, t.low_dims)
    wide = cuda.past_int32("the launch grid's blocks", geo.runs, dl) \
        or cuda.past_int32("a low slice's runs of samples", geo.runs,
                           geo.samples) \
        or cuda.past_int32("the lights table [NL, 16]", n_lights, 16)
    narrow = wide or cuda.past_int32("the [NL, DL, HL, WL] volume",
                                     n_lights, dl, hl, wl)
    return cuda.index_form("K9", narrow, wide, form)


def bake_visibility(t, form: Optional[str] = None) -> torch.Tensor:
    """K9: the low-rate per-light visibility volume [NL, DL, HL, WL]. CUDA
    tables launch the index form k9_form picks (or `form`, forced); a table
    past both is refused before the launch."""
    if t.spar.device.type == "cpu":
        return bake_visibility_plain(t)
    _check_bake_tables(t)
    form = k9_form(t, form)
    cuda.check_cuda(t.spar)
    wl, hl, dl = t.low_dims
    out = torch.empty((t.lights.shape[0], dl, hl, wl), dtype=torch.float32,
                      device=t.spar.device)
    st = t.c_struct()
    cuda.launch("bake_visibility", cuda.ctypes.byref(st), cuda.ptr(out),
                cuda.INDEX_FORMS.index(form), entry="vr_bake_visibility_form")
    return out


def bake_visibility_fused(params, view_to_world, camera_pos, jitter,
                          point_lights, spot_lights, geometry,
                          grid_whd: Tuple[int, int, int], ss: int,
                          heightfield_shadows: bool = False,
                          device="cuda") -> torch.Tensor:
    """`bake_visibility_pallas` of the JAX package on kernel K9: packs the
    tables K9 reads on the CPU (where the scene description must lie) and
    runs bake_visibility on `device`."""
    from volumetricrenderer_tpu_torch.ops import frame_fused
    tables = frame_fused.frame_tables(
        params, view_to_world, torch.eye(4), jitter, 0.0, None, point_lights,
        spot_lights, geometry, None, 0.0, camera_pos, grid_whd, 1, ss,
        bake_noise=False, heightfield_local=heightfield_shadows)
    if torch.device(device).type != "cpu":
        tables = tables.to(device)
    return bake_visibility(tables)


# --------------------------------------------------------------------------
# The local lights' shadow maps at the low grid (shadow_mode="map")
# --------------------------------------------------------------------------

def low_res_world_positions(cfg, params, view_to_world, jitter,
                            ss: int) -> torch.Tensor:
    """[DL, HL, WL, 3] world positions of the low samples (the bakes'
    coordinate contract), for the plain map and noise bakes."""
    d, h, w = cfg.grid_dhw
    wl, hl, dl = low_res_dims((w, h, d), ss)
    dev = view_to_world.device
    off = (ss - 1) * 0.5
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    y0 = float(params.y0)
    zs = ar(dl) * ss + off
    ys = ar(hl) * ss + off + float((-y0) % ss) + y0
    ys = torch.clamp(ys, 0.0, params.grid[1] - 1.0)
    xs = ar(wl) * ss + off
    fz, fy, fx = torch.meshgrid(zs, ys, xs, indexing="ij")
    fro = torch.stack([fx, fy, fz], dim=-1)
    if jitter is not None:
        fro = fro + jitter
    view = froxel_lib.froxel_to_view(params, fro + 0.5)
    return froxel_lib.transform_points(view_to_world, view)


def bake_noise_channels(cfg, params, view_to_world, jitter, media, time_x,
                        ss: int) -> torch.Tensor:
    """[Nn, DL, HL, WL]: the noise factor of each noise-bearing medium
    (material.noise_src != 0), in media order, at the low grid's samples
    (low_res_world_positions; ops/noise.sample_noise: a procedural
    medium's fBm, as K1 bakes it, or a texture medium's exact wrap
    trilinear). Plain torch on the positions' device, as the JAX package's
    bake_noise_channels_xla is plain XLA; its texture sampler's selection
    matmul runs bf16 operands by default, the port samples exactly. Nn is
    at least one."""
    world = low_res_world_positions(cfg, params, view_to_world, jitter, ss)
    return torch.stack([sample_noise(m, world, time_x) for m in media
                        if noise_src(m)])


def _map_visibility(li: int, world, point_lights, spot_lights, cube_shadow,
                    spot_shadow):
    """Light li's (pack_lights order) gated shadow-map visibility at world
    positions; 1 where the light has no map."""
    np_l = point_lights.count
    if li < np_l:
        if cube_shadow is None:
            return torch.ones(world.shape[:-1], device=world.device)
        s = shadow_lib.sample_cube_shadow(
            cube_shadow, li, world - point_lights.position[li])
        g = point_lights.has_shadow[li].to(torch.float32)
    else:
        si = li - np_l
        if spot_shadow is None:
            return torch.ones(world.shape[:-1], device=world.device)
        s = shadow_lib.sample_spot_shadow(spot_shadow, si, world)
        g = spot_lights.has_shadow[si].to(torch.float32)
    return 1.0 + g * (s - 1.0)


def bake_visibility_from_maps(cfg, params, view_to_world, jitter,
                              point_lights, spot_lights, cube_shadow,
                              spot_shadow, ss: int) -> torch.Tensor:
    """[NL, DL, HL, WL] visibility of each local light from its baked cube
    or spot map, sampled at the low grid: what K9 bakes with rays, here for
    shadow_mode="map". Plain torch, as the JAX package runs it in XLA."""
    world = low_res_world_positions(cfg, params, view_to_world, jitter, ss)
    n = point_lights.count + spot_lights.count
    return torch.stack([_map_visibility(li, world, point_lights, spot_lights,
                                        cube_shadow, spot_shadow)
                        for li in range(n)])


def bake_radiance_from_maps(cfg, params, view_to_world, camera_pos, jitter,
                            point_lights, spot_lights, cube_shadow,
                            spot_shadow, media, time_x, ss: int,
                            bake_noise: bool = False) -> torch.Tensor:
    """[3 (+ noise media), DL, HL, WL] local-light radiance at the low grid
    with the visibility of the baked cube and spot maps: what K1 bakes with
    rays, here for shadow_mode="map", every light summed (no slice cull).
    bake_noise appends the fBm factor of each noise-bearing medium, as K1
    does. Plain torch, as the JAX package runs it in XLA."""
    world = low_res_world_positions(cfg, params, view_to_world, jitter, ss)
    wx, wy, wz = world[..., 0], world[..., 1], world[..., 2]
    vdx = wx - camera_pos[0]
    vdy = wy - camera_pos[1]
    vdz = wz - camera_pos[2]
    inv = torch.rsqrt(vdx * vdx + vdy * vdy + vdz * vdz + 1e-18)
    vdx, vdy, vdz = vdx * inv, vdy * inv, vdz * inv
    if media:
        med, media_static = pack_media(media, time_x)
    else:
        med, media_static = torch.zeros((1, 20), device=wx.device), ()
    phg = phase_g_plane(med, media_static, wx, wy, wz)
    g2 = phg * phg
    hg_num = (1.0 - g2) / (4.0 * PI)
    lights = pack_lights(point_lights, spot_lights)
    acc = [torch.zeros_like(wx) for _ in range(3)]
    for li in range(lights.shape[0]):
        q = lambda i: lights[li, i]
        factor, _, _, _, _, _, cr, cg, cb = light_factor(
            q, wx, wy, wz, vdx, vdy, vdz, phg, g2, hg_num)
        base = factor * _map_visibility(li, world, point_lights, spot_lights,
                                        cube_shadow, spot_shadow)
        acc = [a + base * c for a, c in zip(acc, (cr, cg, cb))]
    if bake_noise:
        acc += noise_factor_planes(med, media_static, wx, wy, wz)
    return torch.stack(acc)
