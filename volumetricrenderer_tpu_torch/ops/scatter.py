"""In-scatter at the froxels: packed light tables, the per-slice light
schedule, the per-slice scatter and the scatter kernel K6.

Counterpart of `volumetricrenderer_tpu/ops/pallas/scatter.py`: plain-torch
twins of `pack_lights`, `pack_dir_lights`, `pack_params`,
`slice_light_order`, `light_factor` and `scatter_slice`, and `scatter_local`,
the wrapper of the CUDA kernel K6 (`csrc/scatter.cu`) that stands for
`scatter_local_pallas`. The local lights come from one of three sources:
the upsampled low-rate radiance; the per-light loop with one any-hit shadow
ray per froxel and light; or the per-light loop reading the upsampled
low-rate visibility volume of kernel K9. The material is either evaluated
at the froxel from the media table (the extinction plane comes out too) or
read from material volumes (three planes out; the caller adds the
extinction). The shared device code is `light_factor` and `scatter_froxel`
in `csrc/common.cuh`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel as froxel_lib
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.dir_shadow import froxel_world
from volumetricrenderer_tpu_torch.ops.material import material_planes
from volumetricrenderer_tpu_torch.ops.occlude import any_hit
from volumetricrenderer_tpu_torch.ops.phase import PI

# local-light source of K6 (csrc/common.cuh VR_LOCAL_*)
LOCAL_RADIANCE, LOCAL_RAY, LOCAL_BAKED = 0, 1, 2


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


def slice_light_order(params, view_to_world, positions, ranges,
                      grid_whd: Tuple[int, int, int]):
    """Per-slice active-light schedule of the per-light scatter: the world
    AABB of the frustum slab [z - 1, z + 2] (one froxel of padding covers the
    jitter) against each light's range sphere. Skipping a culled light is
    exact: the range cull of light_factor already zeroes it. Returns
    (order [D, NL] int32, the active lights first and each group in ascending
    index; count [D] int32)."""
    w, h, d = grid_whd
    h_glob = params.grid[1]
    dev = positions.device
    y0 = float(params.y0)
    zs = torch.arange(d, dtype=torch.float32, device=dev)
    z0 = torch.clamp(zs - 1.0, 0.0, float(d))
    z1 = torch.clamp(zs + 2.0, 0.0, float(d))
    xs = upload([0.0, float(w)], dev)
    ys = upload([min(max(y0, 0.0), float(h_glob)),
                 min(max(y0 + h, 0.0), float(h_glob))], dev)
    fx, fy = torch.meshgrid(xs, ys, indexing="ij")
    fx = fx.reshape(1, 4).expand(d, 4)
    fy = fy.reshape(1, 4).expand(d, 4)
    corners = [torch.stack([fx, fy, fz[:, None].expand(d, 4)], dim=-1)
               for fz in (z0, z1)]
    fro = torch.cat(corners, dim=1)                        # [D, 8, 3]
    world = froxel_lib.transform_points(
        view_to_world, froxel_lib.froxel_to_view(params, fro))
    lo = torch.amin(world, dim=1)                          # [D, 3]
    hi = torch.amax(world, dim=1)
    nearest = torch.clamp(positions[None], lo[:, None], hi[:, None])
    diff = nearest - positions[None]
    d2 = torch.sum(diff * diff, dim=-1)
    active = d2 <= (ranges[None] ** 2)                     # [D, NL]
    order = torch.argsort((~active).to(torch.int8), dim=1, stable=True)
    return order.to(torch.int32), active.sum(dim=1, dtype=torch.int32)


def schedule_mask(order: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """[D, NL] bool: is light li among the first count[z] of order[z]?"""
    first = torch.arange(order.shape[1], device=order.device)[None] \
        < count[:, None]
    return torch.zeros_like(first).scatter_(1, order.long(), first)


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
                  n_dir: int, h_glob: int, jitter_dir: bool = False,
                  local=None, material=None):
    """Scatter planes (ar, ag, ab, ext) at slice(s) zi: the local lights
    times sigma_s, plus each sun's colour x blended shadow x HG phase x
    sigma_s at the UNJITTERED froxel centre (jitter_dir=False), and the luma
    extinction ext = (0.3 sr + 0.59 sg + 0.11 sb + sa) * n_dir. The material
    is evaluated at the jittered world position, its fBm factor taken from
    the upsampled noise_planes (None: evaluated here); or, with `material` =
    (sr, sg, sb, phg) planes, read from there, and ext is None.

    Local lights, radiance mode: radiance_planes is the upsampled low-rate
    radiance (rgb). Per-light mode (radiance_planes None): `local` is
    (lights [NL, 16], active [NL] planes or scalars broadcasting against the
    slice(s), planes, spheres, boxes, the any-hit's keyword arguments
    (FrameTables.occluders), vis);
    every light adds light_factor x shadow x colour x sigma_s where it is
    active, in ascending light index (the schedule's order), its shadow
    either 1 - any_hit x gate (vis None) or the upsampled low-rate
    visibility plane vis[li]."""
    p = lambda i: par[0, i]
    camx, camy, camz = p(20), p(21), p(22)
    wx, wy, wz = froxel_world(par, zi, grid_whd, h_glob)
    if material is None:
        sr, sg, sb, s_a, phg = material_planes(med, media_static, wx, wy, wz,
                                               noise_planes=noise_planes)
        ext = (0.3 * sr + 0.59 * sg + 0.11 * sb + s_a) * float(n_dir)
    else:
        sr, sg, sb, phg = material
        ext = None
    g2 = phg * phg
    hg_num = (1.0 - g2) / (4.0 * PI)
    if radiance_planes is not None:
        ar = radiance_planes[0] * sr
        ag = radiance_planes[1] * sg
        ab = radiance_planes[2] * sb
    else:
        lights, active, planes, spheres, boxes, occ_kw, vis = local
        vdx = wx - camx
        vdy = wy - camy
        vdz = wz - camz
        inv_vd = torch.rsqrt(vdx * vdx + vdy * vdy + vdz * vdz + 1e-18)
        vdx, vdy, vdz = vdx * inv_vd, vdy * inv_vd, vdz * inv_vd
        ar = ag = ab = torch.zeros_like(wx)
        for li in range(lights.shape[0]):
            q = lambda i: lights[li, i]
            factor, ldx, ldy, ldz, dist, gate, cr, cg, cb = light_factor(
                q, wx, wy, wz, vdx, vdy, vdz, phg, g2, hg_num)
            if vis is None:
                occ = any_hit(planes, spheres, boxes, wx, wy, wz, -ldx, -ldy,
                              -ldz, dist - 0.05, **occ_kw)
                shadow = 1.0 - occ.to(torch.float32) * gate
            else:
                shadow = vis[li]
            base = factor * shadow
            ar = torch.where(active[li], ar + base * cr * sr, ar)
            ag = torch.where(active[li], ag + base * cg * sg, ag)
            ab = torch.where(active[li], ab + base * cb * sb, ab)
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


# --------------------------------------------------------------------------
# K6 scatter (csrc/scatter.cu)
# --------------------------------------------------------------------------

# The blocks of K6 by local source (csrc/scatter.cu K6Tile): (columns, rows)
# of a tile of one slice, or (froxels, 0) for a run of consecutive froxels
# of one slice's rows. K2's are ops/frame_fused.K2_TILE. Both take a slice
# per launch-grid z in their narrow forms (32-bit indices) and the slices in
# parts in their wide forms (k6_form, ops/frame_fused.k2_form).
K6_TILES = {LOCAL_RADIANCE: (128, 0), LOCAL_RAY: (256, 0),
            LOCAL_BAKED: (16, 8)}
INT32_MAX = cuda.INT32_MAX
MAX_GRID_Z = cuda.MAX_GRID_Z

# The fixed forms' counts (csrc/common.cuh VR_MAX_DIR, VR_MAX_NOISE): K2, K5,
# K6 and K7 keep at most MAX_DIR suns' values, K1, K2 and K6 at most
# MAX_NOISE fBm channels, in arrays. A frame with more takes their general
# instantiations, which take any count at the same values.
MAX_DIR = 4
MAX_NOISE = 4


def needs_general(n_dir: int, n_noise: int = 0) -> bool:
    """Mirror of csrc/common.cuh needs_general (and, with n_noise 0, of
    general_suns): whether K2 and K6 (K5 and K7 on the suns alone) take
    their general form."""
    return n_dir > MAX_DIR or n_noise > MAX_NOISE


def sun_inv_bytes(n_dir: int) -> int:
    """Mirror of csrc/common.cuh sun_inv_floats: the general forms' dynamic
    shared bytes of the suns' inverse ray directions, 3 float32 a sun."""
    return 4 * 3 * n_dir


# The slice tiles of K2 and K5 (ops/frame_fused.K2_TILE,
# ops/shadow_blend.K5_TILE), whose reprojection region the suns' inverse
# directions follow in shared memory
SUN_TILE = (16, 16)


def sun_form(kernel: str, n_dir: int, n_noise: int, k: int,
             form: Optional[str] = None,
             region: Optional[str] = None) -> str:
    """Mirror of csrc/common.cuh sun_form_of as K2 ("K2"), K5 ("K5") and K7
    ("K7") take it (their launchers' k2_sun_form, k5_sun_form,
    k7_sun_form): the form of cuda.SUN_FORMS that the kernel takes for
    n_dir suns and n_noise fBm channels (K5 and K7 look at the suns alone)
    at reprojection window k (K7 has no region). "fixed" within the fixed
    forms' counts (needs_general); past them "general", the suns' inverse
    directions in shared memory after the region, where both fit a block's
    shared memory beside the tile's static terms; past that "gen_global",
    the inverses in a device buffer [n_dir, 3] that the launcher fills, the
    region alone in shared memory. In the region_global form
    (ops/temporal.region_form; K2 and K5 past k = 51, or `region`, forced)
    the region is in device memory and the kernel is gen_global's: any
    count takes "gen_global". form: a form to force ("gen_global" takes any
    count; "fixed" and "general" only the counts that take them, in the
    region_shared form). Raises ValueError, naming the kernel, before any
    launch: for a forced form that cannot take the counts or the region
    form, and a forced region_shared form whose region does not fit."""
    from volumetricrenderer_tpu_torch.ops.temporal import (
        MAX_SHARED_BYTES, TILE_STATIC_SHARED, check_shared, region_form,
        region_shared_bytes)
    if form is not None and form not in cuda.SUN_FORMS:
        raise ValueError(f"{kernel}: form {form!r} is none of "
                         f"{cuda.SUN_FORMS}")
    if kernel != "K7" and region_form(kernel, k, region) == "region_global":
        if form not in (None, "gen_global"):
            raise ValueError(f"{kernel}'s {form} form cannot take its "
                             "region_global form: that form reads the suns' "
                             "inverse directions from device memory "
                             "(gen_global)")
        return "gen_global"
    region_bytes = 0 if kernel == "K7" else region_shared_bytes(SUN_TILE, k)
    general = needs_general(n_dir, n_noise if kernel == "K2" else 0)
    fits = lambda nbytes: nbytes + TILE_STATIC_SHARED <= MAX_SHARED_BYTES
    rule = "gen_global" if general and not fits(
        region_bytes + sun_inv_bytes(n_dir)) else \
        "general" if general else "fixed"
    if form is None or form == rule or form == "gen_global":
        return rule if form is None else form
    if form == "general" and general:
        check_shared(region_bytes + sun_inv_bytes(n_dir), kernel,
                     f"{n_dir} suns")
    raise ValueError(f"{kernel}'s {form} form cannot take {n_dir} suns and "
                     f"{n_noise} fBm channels: the counts take its {rule} "
                     "form")


def tile_grid(grid_whd: Tuple[int, int, int],
              tile: Tuple[int, int]) -> Tuple[int, int, int]:
    """The launch grid of K6 or K2 for the array grid (W, H, D) and a block
    `tile` of K6_TILES or K2_TILE: one block per tile of each slice, or per
    run of tile[0] froxels of its rows; the ragged last ones masked."""
    w, h, d = grid_whd
    tx, ty = tile
    if ty == 0:
        return -(-(w * h) // tx), 1, d
    return -(-w // tx), -(-h // ty), d


def tile_planes_why(t) -> Optional[str]:
    """Mirror of csrc/common.cuh tile_planes_fit, what the narrow forms of
    K5, K6 and K7 share: why their [max(4, Nd), D, H, W] planes or their
    slices (one a launch-grid z index) pass a 32-bit index or the launch
    grid, or None where they do not."""
    w, h, d = t.grid_whd
    return cuda.past_int32("the [max(4, Nd), D, H, W] planes",
                           max(4, t.n_dir), w, h, d) \
        or (f"{d} slices past the launch grid's {MAX_GRID_Z}"
            if d > MAX_GRID_Z else None)


def check_tile_indices(t, kernel: str = "K5 and K7",
                       form: Optional[str] = None, rows: int = 16) -> str:
    """The index form of cuda.INDEX_FORMS that the slice tile `kernel` (K5
    or K7, tiles of `rows` rows: ops/shadow_blend.k5_form,
    ops/dir_shadow.k7_form) takes for the frame tables `t`. The narrow form
    (32-bit indices, a slice a launch-grid z index) takes tables whose
    [max(4, Nd), D, H, W] planes hold under 2^31 floats on at most 65535
    slices (tile_planes_why); past that the wide form (64-bit indices, the
    slices in parts of at most 65535) takes any size and slice count, on at
    most 65535 row tiles with the suns' table under 2^31 floats
    (csrc/common.cuh tile_rows_fit). K6 adds its low channels and
    schedule (k6_form). form: a form to force. Raises ValueError, naming
    `kernel`, before any launch where the form cannot take the tables."""
    h = t.grid_whd[1]
    tiles = -(-h // rows)
    wide = (f"{h} rows: {tiles} row tiles past the launch grid's "
            f"{MAX_GRID_Z}" if tiles > MAX_GRID_Z else None) \
        or cuda.past_int32("the suns' table [Nd, 8]", t.n_dir, 8)
    return cuda.index_form(kernel, wide or tile_planes_why(t), wide, form)


def k6_form(t, local: int, form: Optional[str] = None) -> str:
    """Mirror of csrc/scatter.cu k6_form: the index form of
    cuda.INDEX_FORMS that K6 takes for the tables and local source `local`
    (LOCAL_*). The narrow form takes tables whose [max(4, Nd), D, H, W]
    planes (tile_planes_why), the low channels the local source reads (the
    radiance: 3 + n_noise; the visibility: NL; the rays: none) and, in the
    per-light loops, the schedule [D, NL] hold under 2^31 floats, on at
    most 65535 slices; the wide form any slice count and size, on a launch
    grid its block takes (K6_TILES: at most 65535 row tiles, or a run's
    froxel index y * W + x under 2^31) with the suns' and lights' tables
    under 2^31 floats. form: a form to force. Raises ValueError
    (cuda.index_form), naming K6, before any launch."""
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    n_lights = 0 if t.lights is None else t.lights.shape[0]
    ty = K6_TILES[local][1]
    tiles = -(-h // ty) if ty else 0
    grid = (f"{h} rows: {tiles} row tiles past the launch grid's "
            f"{MAX_GRID_Z}" if tiles > MAX_GRID_Z else None) if ty \
        else cuda.past_int32("a slice's froxels [H, W] of a run's index",
                             h, w)
    wide = grid or cuda.past_int32("the suns' table [Nd, 8]", t.n_dir, 8) \
        or cuda.past_int32("the lights table [NL, 16]", n_lights, 16)
    channels = {LOCAL_RADIANCE: 3 + t.n_noise,
                LOCAL_BAKED: n_lights}.get(local, 0)
    narrow = wide or tile_planes_why(t) \
        or cuda.past_int32("the low channels it reads", channels, wl, hl, dl) \
        or (cuda.past_int32("the light schedule [D, NL]", d, n_lights)
            if local != LOCAL_RADIANCE else None)
    return cuda.index_form("K6", narrow, wide, form)


def check_scatter_inputs(t, shadow: torch.Tensor, bake, vis,
                          material) -> None:
    w, h, d = t.grid_whd
    # a scene without a sun passes its one channel of ones, which no
    # scatter reads (write_shadow_volume_dir)
    nd = max(t.n_dir, 1)
    if shadow.shape != (nd, d, h, w):
        raise ValueError(f"shadow {tuple(shadow.shape)} != "
                         f"{(nd, d, h, w)}")
    if bake is not None and vis is not None:
        raise ValueError("pass the radiance bake or the visibility bake, "
                         "not both")
    if bake is None and t.order is None:
        raise ValueError("per-light scatter needs the light schedule: pack "
                         "the frame tables with vis_ss=1 or light_schedule")
    if bake is not None or vis is not None:
        wl, hl, dl = t.low_dims
        n_noise = t.n_noise if material is None else 0
        want = (3 + n_noise, dl, hl, wl) if bake is not None \
            else (t.lights.shape[0], dl, hl, wl)
        low = bake if bake is not None else vis
        if t.ss < 2 or low.shape != want:
            raise ValueError(f"bake volume {tuple(low.shape)} at ss={t.ss}")
    if material is not None:
        mat_a, mat_b = material
        if mat_a.shape != (4, d, h, w) or mat_b.shape != (1, d, h, w):
            raise ValueError(f"material volumes {tuple(mat_a.shape)}, "
                             f"{tuple(mat_b.shape)}")


def local_mode(bake, vis) -> int:
    """The local-light source (LOCAL_*) of K6 and K2 given their radiance
    bake and visibility bake arguments."""
    if bake is not None:
        return LOCAL_RADIANCE
    return LOCAL_BAKED if vis is not None else LOCAL_RAY


def scatter_local_plain(t, shadow: torch.Tensor,
                        bake: Optional[torch.Tensor] = None,
                        vis: Optional[torch.Tensor] = None,
                        material=None) -> torch.Tensor:
    """Twin of K6: scatter planes from the frame's tables and the blended
    shadow volume [Nd, D, H, W]. Local lights: the low-rate radiance (+ fBm)
    volume `bake`; or, with bake None, the per-light loop over the tables'
    schedule, shadowed by the low-rate visibility volume `vis`
    [NL, DL, HL, WL] or, with vis None too, by one any-hit ray each.
    Material: evaluated here from the media table, giving [4, D, H, W]
    (r, g, b, ext); or read from material = (mat_a [4, D, H, W] sigma_s rgb
    and sigma_a, mat_b [1, D, H, W] phase g), giving [3, D, H, W]."""
    # visibility.py imports this module for light_factor
    from volumetricrenderer_tpu_torch.ops.visibility import upsample_low
    check_scatter_inputs(t, shadow, bake, vis, material)
    w, h, d = t.grid_whd
    zs = torch.arange(d, device=shadow.device)[:, None, None]
    radiance = noise = local = planes = None
    if material is not None:
        planes = (material[0][0], material[0][1], material[0][2],
                  material[1][0])
    if bake is not None:
        radiance = upsample_low(bake[:3], zs, t.ss, t.tent_x, t.tent_y)
        if t.n_noise and material is None:
            noise = list(upsample_low(bake[3:3 + t.n_noise], zs, t.ss,
                                      t.tent_x, t.tent_y))
    else:
        active = schedule_mask(t.order, t.count).T[:, :, None, None]
        if vis is not None:
            vis = upsample_low(vis, zs, t.ss, t.tent_x, t.tent_y)
        local = (t.lights, active, t.planes, t.spheres, t.boxes,
                 t.occluders(local=True), vis)
    out = scatter_slice(
        t.spar, t.dirs, t.med, t.media_static, zs, list(shadow), radiance,
        noise, grid_whd=t.grid_whd, n_dir=t.n_dir, h_glob=t.h_glob,
        jitter_dir=t.jitter_dir, local=local, material=planes)
    return torch.stack(out if material is None else out[:3])


def scatter_local(t, shadow: torch.Tensor,
                  bake: Optional[torch.Tensor] = None,
                  vis: Optional[torch.Tensor] = None,
                  material=None, form: Optional[str] = None) -> torch.Tensor:
    """K6: the scatter planes, [4, D, H, W] or, with material volumes,
    [3, D, H, W] (see scatter_local_plain). CUDA tensors launch the index
    form k6_form picks (or `form`, forced)."""
    if shadow.device.type == "cpu":
        return scatter_local_plain(t, shadow, bake, vis, material)
    check_scatter_inputs(t, shadow, bake, vis, material)
    mode = local_mode(bake, vis)
    form = k6_form(t, mode, form)
    low = bake if bake is not None else vis
    cuda.check_cuda(shadow, *(() if low is None else (low,)),
                    *(material or ()))
    if material is None and t.med is None:
        raise ValueError("the fused material needs the media table")
    w, h, d = t.grid_whd
    out = torch.empty((4 if material is None else 3, d, h, w),
                      dtype=torch.float32, device=shadow.device)
    st = t.c_struct()
    mat_a, mat_b = material if material is not None else (None, None)
    cuda.launch("scatter", cuda.ctypes.byref(st), cuda.ptr(shadow),
                cuda.ptr(low) if low is not None else None,
                cuda.ptr(mat_a) if mat_a is not None else None,
                cuda.ptr(mat_b) if mat_b is not None else None,
                cuda.ptr(out), mode, cuda.INDEX_FORMS.index(form),
                entry="vr_scatter_form")
    return out


def scatter_local_fused(params, view_to_world, camera_pos, jitter,
                        point_lights, spot_lights, geometry,
                        grid_whd: Tuple[int, int, int], dir_lights,
                        shadow_volume: torch.Tensor, media, time_x,
                        jitter_dir: bool = False, vis=None,
                        vis_ss: int = 1, vis_radiance: bool = True,
                        material=None,
                        heightfield_shadows: bool = False) -> torch.Tensor:
    """`scatter_local_pallas` of the JAX package with return_planes: packs
    the frame's tables on the CPU and runs scatter_local on shadow_volume's
    device. vis: the low-rate volume at vis_ss -- the radiance (+ fBm) of
    bake_radiance (vis_radiance) or the per-light visibility of
    bake_visibility -- or None for the per-light any-hit loop. media: folded
    into the kernel, giving [4, D, H, W]; or None with material = (mat_a,
    mat_b) volumes, giving [3, D, H, W]."""
    from volumetricrenderer_tpu_torch.ops.frame_fused import frame_tables
    if vis is None:
        vis_ss = 1
    radiance = vis is not None and vis_radiance
    tables = frame_tables(
        params, view_to_world, torch.eye(4), jitter, 0.0, dir_lights,
        point_lights, spot_lights, geometry, media, time_x, camera_pos,
        grid_whd, 1, vis_ss,
        bake_noise=radiance and media is not None and vis.shape[0] > 3,
        jitter_dir=jitter_dir, light_schedule=not radiance,
        heightfield_local=heightfield_shadows)
    if shadow_volume.device.type != "cpu":
        tables = tables.to(shadow_volume.device)
    return scatter_local(tables, shadow_volume,
                         bake=vis if radiance else None,
                         vis=None if radiance else vis, material=material)
