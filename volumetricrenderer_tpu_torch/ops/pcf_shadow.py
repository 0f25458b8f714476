"""The cascaded-PCF sun shadow volume of the shadow-map modes.

Port of `volumetricrenderer_tpu/ops/pallas/pcf_shadow.py`
(`pcf_dir_shadow_pallas`, `_schedule`). Per froxel of the grid it is given
(full rate, or the low-rate grid of dir_shadow_subsample) and per sun: the
split-sphere one-hot cascade select, a 1-tap hardware PCF on the cascade
atlas (4 point compares, lit = ref <= stored, weighted bilinearly), the lerp
to the shadow strength, the square (VolumetricShadowCompute:17) and the
has_shadow gate. It needs the camera-aligned bake (DirShadowData.aligned),
which makes the froxel -> atlas map of one z slice affine with u depending
on froxel x only:

  u = a_u x + c_u,   v = a_v x + b_v y + c_v,   ref = a_r x + b_r y + c_r

  schedule          host prep, plain torch on the CPU: per (slice, cascade)
                    those coefficients, the slices' cascade cull (order,
                    count) and the window-overflow flag, in `_schedule`'s
                    arithmetic (its HIGHEST-precision einsums written as
                    explicit three-term sums)
  pack_tables       schedule for every sun -> PcfTables (one upload)
  pcf_shadow_plain  the twin
  pcf_shadow        kernel K12 (csrc/pcf_shadow.cu): 16x16 tiles of one
                    slice (K12_TILE), every sun in one launch
  pcf_dir_shadow    the JAX function's signature: pack, move, pcf_shadow

The window. The TPU kernel gathers from a 512-texel window per (slice,
cascade), centred on the footprint of the slice inside the cascade's atlas
quadrant, because Mosaic gathers only 128 lanes at a time; `_schedule` flags
an active (slice, cascade) whose footprint leaves its window and the output
of that light is then poisoned with NaN. A GPU thread reads the whole atlas
(4 MB at FULL, resident in L2), so K12 and its twin have no window and clamp
taps to the atlas edge. The flag and the poison are ported as JAX has them,
so an out-of-envelope configuration fails here as it fails there. Where the
flag is clear the two agree except at one place: with an atlas wider than
two windows (2S > 1024) the window is the cascade's quadrant itself, and a
tap up to two texels past the quadrant (the texel snap moves the split
sphere by up to one texel against its quadrant) reads the window's edge
texel on the TPU and the neighbouring texel here, as the gather sampler
`shadow.sample_dir_shadow` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel as froxel_lib
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.scatter import MAX_GRID_Z, tile_grid

MAX_WIN = 512      # the TPU kernel's atlas window (rows and columns)


@dataclasses.dataclass(frozen=True)
class PcfTables:
    """K12's per-frame tables for every sun (leading axis = light)."""
    par: torch.Tensor        # [Nd, 24] `_schedule` par; [22] the has_shadow
    #                          gate, [23] 1 where the light's window
    #                          overflowed and its shadow is consumed
    coef: torch.Tensor       # [Nd, D, C, 8] (a_u c_u a_v b_v c_v a_r b_r c_r)
    order: torch.Tensor      # [Nd, D, C] int32: a slice's active cascades first
    count: torch.Tensor      # [Nd, D] int32: how many are active
    spheres: torch.Tensor    # [Nd, C, 4] split-sphere centre, squared radius
    grid_whd: Tuple[int, int, int]
    h_glob: int

    def to(self, device) -> "PcfTables":
        return cuda.move_tables(self, device)


def _dot(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("cx,dx->dc") as three products and two adds: [D, C]."""
    return (m[None, :, 0] * v[:, None, 0] + m[None, :, 1] * v[:, None, 1]
            + m[None, :, 2] * v[:, None, 2])


def schedule(params, view_to_world, jitter, data, li: int,
             grid_whd: Tuple[int, int, int], win: int):
    """`_schedule` for light li: (par [24], coef [D, C, 8], winb [D, C, 2]
    int32 window block starts (v, u), order [D, C] int32, count [D] int32,
    spheres [C, 4], overflow bool). params' grid depth must be the grid's
    (the low-rate branch passes its own); everything on the CPU."""
    w, h, d = grid_whd
    f32 = torch.float32
    h_glob = params.grid[1]
    s2 = data.atlas.shape[-1]
    r3 = view_to_world[:3, :3]
    t3 = view_to_world[:3, 3]
    jit = torch.tensor(np.asarray(jitter, np.float32).reshape(3))
    jx, jy, jz = jit[0], jit[1], jit[2]

    zs = torch.arange(d, dtype=f32)
    vz = froxel_lib.froxel_z_to_view_z(params, zs + 0.5 + jz)       # [D]
    # world(x, y; z) = c0[z] + x * xdir[z] + y * ydir[z]
    xdir = r3[:, 0][None] * (2.0 * vz / (w * params.x))[:, None]
    ydir = r3[:, 1][None] * (2.0 * vz / (h_glob * params.y))[:, None]
    c0 = (r3[:, 0][None] * ((2.0 * (0.5 + jx) / w - 1.0) * vz
                            / params.x)[:, None]
          + r3[:, 1][None] * ((2.0 * (0.5 + jy) / h_glob - 1.0) * vz
                              / params.y)[:, None]
          + r3[:, 2][None] * vz[:, None] + t3[None])

    mats = data.world_to_uv[li]                                      # [C,3,4]
    coefs = []
    for row, scale, off in ((0, float(s2), -0.5), (1, float(s2), -0.5),
                            (2, 1.0, 0.0)):
        m3 = mats[:, row, :3]
        a = scale * _dot(m3, xdir)
        b = scale * _dot(m3, ydir)
        c = scale * (_dot(m3, c0) + mats[None, :, row, 3]) + off
        coefs.append((a, b, c))
    (a_u, b_u, c_u), (a_v, b_v, c_v), (a_r, b_r, c_r) = coefs
    c_r = c_r - data.bias[li]
    y0 = torch.tensor(float(params.y0), dtype=f32)

    # the footprint of a slice inside a cascade's quadrant, and the window
    # the TPU kernel would gather it from
    sph_c = data.split_spheres[li]                                   # [C, 3]
    margin = 4.0
    quad, qctr = [], []
    for row in (0, 1):
        m3 = mats[:, row, :3]
        ctr = s2 * (torch.sum(m3 * sph_c, dim=1) + mats[:, row, 3]) - 0.5
        qctr.append(ctr)
        quad.append((ctr - s2 / 4 - margin, ctr + s2 / 4 + margin))

    def footprint(a, b, c, qlo, qhi):
        cy = c + b * y0
        corners = torch.stack([cy, cy + a * (w - 1), cy + b * (h - 1),
                               cy + a * (w - 1) + b * (h - 1)])
        raw_lo = torch.amin(corners, 0)
        raw_hi = torch.amax(corners, 0)
        lo = torch.maximum(raw_lo, qlo[None])
        hi = torch.minimum(raw_hi, qhi[None])
        lo = torch.clamp(torch.floor(lo), 0, s2 - 1)
        hi = torch.clamp(torch.floor(torch.maximum(hi, lo)) + 1, 0, s2 - 1)
        return lo, hi, raw_lo, raw_hi

    qblk = (s2 // 2) // 128
    wblk = win // 128

    def window(lo, hi, ctr_q):
        ctr = 0.5 * (lo + hi)
        st = torch.round(ctr / 128.0).to(torch.int32) - win // 256
        if qblk >= wblk:
            q0 = torch.round((ctr_q - s2 / 4) / 128.0).to(torch.int32)
            st = torch.minimum(torch.maximum(st, q0[None]),
                               q0[None] + (qblk - wblk))
        return torch.clamp(st, 0, s2 // 128 - wblk)

    lo_u, hi_u, raw_lo_u, raw_hi_u = footprint(a_u, torch.zeros_like(b_u),
                                               c_u, *quad[0])
    lo_v, hi_v, raw_lo_v, raw_hi_v = footprint(a_v, b_v, c_v, *quad[1])
    winb = torch.stack([window(lo_v, hi_v, qctr[1]),
                        window(lo_u, hi_u, qctr[0])], dim=-1)

    # conservative slice-vs-split-sphere cascade cull
    z0 = torch.clamp(zs - 0.5, 0.0, float(d))
    z1 = torch.clamp(zs + 1.5, 0.0, float(d))
    xs = torch.tensor([0.0, float(w)])
    ys = torch.stack([y0, y0 + h])
    fx, fy = torch.meshgrid(xs, ys, indexing="ij")
    fx = fx.reshape(1, 4).expand(d, 4)
    fy = fy.reshape(1, 4).expand(d, 4)
    corners = [torch.stack([fx, fy, fz[:, None].expand(d, 4)], dim=-1)
               for fz in (z0, z1)]
    fro = torch.cat(corners, dim=1)                                  # [D,8,3]
    world = froxel_lib.transform_points(
        view_to_world, froxel_lib.froxel_to_view(params, fro))
    lo = torch.amin(world, dim=1)
    hi = torch.amax(world, dim=1)
    sph = data.split_spheres[li]
    sqr = data.split_sq_radii[li]
    nearest = torch.clamp(sph[None], lo[:, None], hi[:, None])
    diff = nearest - sph[None]
    d2min = torch.sum(diff * diff, dim=-1)                           # [D, C]
    farthest = torch.where(torch.abs(lo[:, None] - sph[None])
                           > torch.abs(hi[:, None] - sph[None]),
                           lo[:, None], hi[:, None])
    diff = farthest - sph[None]
    d2max = torch.sum(diff * diff, dim=-1)
    may_inside = d2min < sqr[None]
    may_outside_prev = torch.cat(
        [torch.ones((d, 1), dtype=torch.bool),
         d2max[:, :-1] >= sqr[None, :-1]], dim=1)
    active = may_inside & may_outside_prev
    order = torch.argsort((~active).to(torch.int32), dim=1,
                          stable=True).to(torch.int32)
    count = active.sum(dim=1, dtype=torch.int32)

    # a contributing footprint (clipped to the quadrant's content) outside
    # its window: the TPU kernel would clamp it, so the caller poisons
    overflow = False
    if win < s2:
        tol = 2.0

        def oob(raw_lo, raw_hi, ctr, blk):
            lo_f = torch.maximum(raw_lo, (ctr - s2 / 4)[None])
            hi_f = torch.minimum(raw_hi, (ctr + s2 / 4)[None])
            st = (blk * 128).to(f32)
            spill = (lo_f < st - tol) | (hi_f + 1.0 > st + win + tol)
            return spill & (hi_f >= lo_f)

        over = (oob(raw_lo_u, raw_hi_u, qctr[0], winb[..., 1])
                | oob(raw_lo_v, raw_hi_v, qctr[1], winb[..., 0]))
        overflow = bool((over & active).any())

    coef = torch.stack([a_u, c_u, a_v, b_v, c_v, a_r, b_r, c_r], dim=-1)
    v = view_to_world
    par = torch.stack([
        params.x, params.y, params.z, params.w, params.near, jx, jy, jz,
        v[0, 0], v[0, 1], v[0, 2], v[0, 3], v[1, 0], v[1, 1], v[1, 2],
        v[1, 3], v[2, 0], v[2, 1], v[2, 2], v[2, 3], data.strength_r[li],
        y0, torch.tensor(0.0), torch.tensor(0.0)]).to(f32)
    spheres = torch.cat([sph, sqr[:, None]], dim=-1)
    return (par, coef, winb.to(torch.int32), order, count, spheres,
            overflow)


def pack_tables(params, view_to_world, jitter, dir_lights, data,
                grid_whd: Tuple[int, int, int],
                win: int = MAX_WIN) -> PcfTables:
    """The schedule of every sun, on the CPU, where every argument's tables
    must lie. win: the TPU window that decides the overflow flag (the
    smaller of MAX_WIN and the atlas)."""
    if not data.aligned:
        raise ValueError("the cascaded-PCF kernel needs the camera-aligned "
                         "bake (bake_dir_shadows(align_up=...))")
    win = min(win, data.atlas.shape[-1])
    rows = {k: [] for k in ("par", "coef", "order", "count", "spheres")}
    for li in range(dir_lights.count):
        par, coef, _, order, count, spheres, overflow = schedule(
            params, view_to_world, jitter, data, li, grid_whd, win)
        gate = dir_lights.has_shadow[li].to(torch.float32)
        par[22] = gate
        par[23] = float(overflow and bool(gate > 0.0))
        for k, v in (("par", par), ("coef", coef), ("order", order),
                     ("count", count), ("spheres", spheres)):
            rows[k].append(v)
    return PcfTables(**{k: torch.stack(v).contiguous()
                        for k, v in rows.items()},
                     grid_whd=tuple(grid_whd), h_glob=params.grid[1])


def _check(t: PcfTables, atlas: torch.Tensor) -> None:
    n = t.par.shape[0]
    if atlas.dim() != 3 or atlas.shape[0] != n \
            or atlas.shape[1] != atlas.shape[2]:
        raise ValueError(f"atlas {tuple(atlas.shape)} for {n} suns")


def pcf_shadow_plain(t: PcfTables, atlas: torch.Tensor) -> torch.Tensor:
    """Twin of K12: [Nd, D, H, W] squared, gated sun visibility."""
    _check(t, atlas)
    w, h, d = t.grid_whd
    s2 = atlas.shape[-1]
    dev = atlas.device
    f32 = torch.float32
    zi = torch.arange(d, device=dev)
    zs = zi.to(f32)[:, None, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, None, :]
    ys0 = torch.arange(h, dtype=f32, device=dev)[None, :, None]
    outs = []
    for li in range(t.par.shape[0]):
        p = lambda i: t.par[li, i]
        fpx, fpy, fpz, fpw, near = p(0), p(1), p(2), p(3), p(4)
        jx, jy, jz = p(5), p(6), p(7)
        sr = p(20)
        # the jittered world position, for the split-sphere select
        fz = zs + 0.5 + jz
        vz = (torch.exp(torch.log(fpz) * fz / d) - 1.0) * fpw + near
        ys = torch.clamp(ys0 + p(21), 0.0, t.h_glob - 1.0)
        vx = (2.0 * (xs + 0.5 + jx) / w - 1.0) * vz / fpx
        vy = (2.0 * (ys + 0.5 + jy) / t.h_glob - 1.0) * vz / fpy
        wx = p(8) * vx + p(9) * vy + p(10) * vz + p(11)
        wy = p(12) * vx + p(13) * vy + p(14) * vz + p(15)
        wz = p(16) * vx + p(17) * vy + p(18) * vz + p(19)
        sph = t.spheres[li]
        flat = atlas[li].reshape(-1)

        def inside(ci):
            q = lambda j: sph[ci, j][:, None, None]
            dx = wx - q(0)
            dy = wy - q(1)
            dz = wz - q(2)
            return (dx * dx + dy * dy + dz * dz < q(3)).to(f32)

        acc_cmp = torch.zeros((d, h, w), dtype=f32, device=dev)
        acc_mask = torch.zeros_like(acc_cmp)
        order = t.order[li].long()
        for k in range(order.shape[1]):
            ci = order[:, k]
            q = lambda j: t.coef[li, zi, ci, j][:, None, None]
            u_t = q(0) * xs + q(1)
            v_t = q(2) * xs + q(3) * ys + q(4)
            ref = q(5) * xs + q(6) * ys + q(7)
            u0 = torch.floor(u_t)
            v0 = torch.floor(v_t)
            fu = u_t - u0
            fv = v_t - v0
            gu = [torch.clamp(u0.long() + dx, 0, s2 - 1) for dx in (0, 1)]
            gv = [torch.clamp(v0.long() + dy, 0, s2 - 1) for dy in (0, 1)]
            le = lambda dy, dx: (ref <= flat[gv[dy] * s2 + gu[dx]]).to(f32)
            cmp = ((1.0 - fv) * ((1.0 - fu) * le(0, 0) + fu * le(0, 1))
                   + fv * ((1.0 - fu) * le(1, 0) + fu * le(1, 1)))
            prev = inside(torch.clamp(ci - 1, min=0)) \
                * (ci > 0).to(f32)[:, None, None]
            mask = inside(ci) * (1.0 - prev)
            on = (k < t.count[li].long())[:, None, None]
            acc_cmp = torch.where(on, acc_cmp + mask * cmp, acc_cmp)
            acc_mask = torch.where(on, acc_mask + mask, acc_mask)
        # outside every cascade: fully lit
        cmp = acc_cmp + (1.0 - torch.clamp(acc_mask, max=1.0))
        vis = sr + (1.0 - sr) * cmp
        res = 1.0 + p(22) * (vis * vis - 1.0)
        outs.append(torch.where(p(23) > 0.0, res + float("nan"), res))
    return torch.stack(outs)


# K12's tile (csrc/pcf_shadow.cu K12Tile): 16 columns x 16 rows of one
# slice of one sun, a block of 16 x 4 threads, each thread 4 rows of its
# column (rows 4 apart); the launch grid is ops/scatter.tile_grid's over
# the grid (W, H, Nd x D).
K12_TILE = (16, 16)
K12_ROWS_PER_THREAD = 4


def k12_shared_bytes(nc: int) -> int:
    """Mirror of csrc/pcf_shadow.cu k12_floats: a block's dynamic shared
    bytes at nc cascades -- the slice's 3 products and count, and per
    cascade its order entry, 2 constant terms and 4 sphere floats; per
    column 3 products and per cascade 5 terms; per row 3 products and per
    cascade 2 terms."""
    tx, ty = K12_TILE
    return 4 * (4 + 7 * nc + tx * (3 + 5 * nc) + ty * (3 + 2 * nc))


def k12_grid(grid_whd: Tuple[int, int, int], nd: int) -> Tuple[int, int, int]:
    """K12's launch grid for nd suns: a block per tile of each slice of
    each sun."""
    w, h, d = grid_whd
    return tile_grid((w, h, nd * d), K12_TILE)


def k12_form(t: PcfTables, atlas: torch.Tensor,
             form: Optional[str] = None) -> str:
    """Mirror of csrc/pcf_shadow.cu k12_form: the index form of
    cuda.INDEX_FORMS that K12 takes for the tables t and the atlases
    [Nd, S2, S2]. The narrow form (32-bit indices, a (sun, slice) pair a
    launch-grid z index) takes [Nd, D, H, W] volumes, atlases and
    [Nd, D, C, 8] cascade tables under 2^31 floats on at most 65535 pairs;
    the wide form (64-bit indices, the pairs in parts of at most 65535) any
    sun count, size and slice count, with a sun's [D, C, 8] table under
    2^31 floats. Both take at most 65535 tiles of K12_TILE's rows. form: a
    form to force. Raises ValueError, naming K12, before any launch."""
    w, h, d = t.grid_whd
    nd, s2, nc = t.par.shape[0], atlas.shape[-1], t.spheres.shape[1]
    tiles = -(-h // K12_TILE[1])
    wide = (f"{h} rows: {tiles} row tiles past the launch grid's "
            f"{MAX_GRID_Z}" if tiles > MAX_GRID_Z else None) \
        or cuda.past_int32("a sun's cascade table [D, C, 8]", d, nc, 8)
    narrow = wide \
        or cuda.past_int32("the volumes [Nd, D, H, W]", nd, d, h, w) \
        or cuda.past_int32("the atlases [Nd, S2, S2]", nd, s2, s2) \
        or cuda.past_int32("the cascade tables [Nd, D, C, 8]", nd, d, nc, 8) \
        or (f"{nd} suns x {d} slices: {nd * d} (sun, slice) pairs past the "
            f"launch grid's {MAX_GRID_Z}" if nd * d > MAX_GRID_Z else None)
    return cuda.index_form("K12", narrow, wide, form)


def pcf_shadow(t: PcfTables, atlas: torch.Tensor,
               form: Optional[str] = None) -> torch.Tensor:
    """K12: the sun shadow volume [Nd, D, H, W] on t's grid, every sun in
    one launch of the index form k12_form picks (or `form`, forced), which
    refuses, before the launch, what neither form can index."""
    _check(t, atlas)
    if atlas.device.type == "cpu":
        return pcf_shadow_plain(t, atlas)
    form = k12_form(t, atlas, form)
    cuda.check_cuda(atlas, t.par, t.coef, t.spheres)
    cuda.check_cuda(t.order, t.count, dtype=torch.int32)
    w, h, d = t.grid_whd
    nd, nc = t.par.shape[0], t.spheres.shape[1]
    s2 = atlas.shape[-1]
    out = torch.empty((nd, d, h, w), dtype=torch.float32,
                      device=atlas.device)
    cuda.launch("pcf_shadow", cuda.ptr(t.par), cuda.ptr(t.coef),
                cuda.ptr(t.order), cuda.ptr(t.count), cuda.ptr(t.spheres),
                cuda.ptr(atlas), w, h, d, t.h_glob, s2, nc, nd,
                cuda.ptr(out), cuda.INDEX_FORMS.index(form),
                entry="vr_pcf_shadow_form")
    return out


def pcf_dir_shadow(params, view_to_world, jitter, dir_lights, data,
                   grid_whd: Tuple[int, int, int]) -> torch.Tensor:
    """`pcf_dir_shadow_pallas` of the JAX package: [Nd, D, H, W] on the
    atlas's device. The schedule is packed on the CPU from host copies of
    the arguments' small tables."""
    cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else v
    params_h = dataclasses.replace(params, **{
        f: cpu(getattr(params, f)) for f in ("x", "y", "z", "w", "near")})
    lights_h = dataclasses.replace(dir_lights,
                                   has_shadow=dir_lights.has_shadow.cpu())
    t = pack_tables(params_h, cpu(view_to_world), np.asarray(
        cpu(jitter), np.float32), lights_h, data.to("cpu"), grid_whd)
    if data.atlas.device.type != "cpu":
        t = t.to(data.atlas.device)
    return pcf_shadow(t, data.atlas.contiguous())
