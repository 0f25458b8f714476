"""The render passes of the staged frame.

Counterpart of `volumetricrenderer_tpu/pipeline.py`. Each pass routes on
the config as the JAX pass does: to a kernel wrapper on the frame's packed
tables (ops/frame_fused.FrameTables) where the JAX package runs a Pallas
kernel, to plain torch on the frame's device where it runs plain XLA. A
branch that is not ported raises NotImplementedError naming what is missing.

  write_material_volumes   plain torch (ops/noise.sample_noise: procedural
                           fBm, or a texture's wrap trilinear, at full rate
                           or at 1/texture_noise_subsample^3 tent-upsampled)
  write_shadow_volume_dir  raycast: dir_shadow_impl="pallas": kernel K7;
                           "xla": plain torch over ops/raycast.occluded;
                           shadow maps: the cascaded-PCF kernel K12 (full or
                           low rate, then a plain upsample), or the plain
                           gather sampler shadow.sample_dir_shadow
  write_scatter_volume     scatter_impl="pallas": kernel K6, fed by K1
                           (radiance bake) or K9 (visibility bake) at
                           raycast_shadow_subsample > 1, or in
                           shadow_mode="map" by the plain bakes from the cube
                           and spot maps; the material folded into the kernel
                           or read from material volumes. scatter_impl="xla",
                           a scene without local lights, or map mode without
                           their maps: the plain XLA scatter
                           (write_scatter_xla) over the material volumes
  accumulate               accumulate_impl="pallas" on kernel planes: K8;
                           else the plain shift sample + two-level scan
  temporal_blend_*         reproj_impl="pallas": K10 (shadow, accumulation)
                           or K11 + a plain lerp (material, scatter);
                           "windowed" / "gather": plain torch

Volumes are channel-first: material_a [4, D, H, W] (sigma_s rgb, sigma_a),
material_b [1, D, H, W] (phase g; the JAX package pads it to 4 channels),
scatter [4, D, H, W], accumulation [4, D, H, W]. cfg.grid is the array
grid and params.grid the global one; they differ for a slab of an
H-sharded frame (parallel/shard_render.py), whose local row i is global row
params.y0 + i, clamped to the global grid.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel
from volumetricrenderer_tpu_torch import shadow as shadow_lib
from volumetricrenderer_tpu_torch.config import RenderConfig
from volumetricrenderer_tpu_torch.froxel import FroxelParams
from volumetricrenderer_tpu_torch.models.media import ADDITIVE, BOX
from volumetricrenderer_tpu_torch.ops import raycast
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.dir_shadow import \
    dir_shadow as raycast_dir_shadow
from volumetricrenderer_tpu_torch.ops.falloff import (point_light_falloff,
                                                      spot_light_falloff)
from volumetricrenderer_tpu_torch.ops.frame_fused import (FrameTables,
                                                          bake_radiance)
from volumetricrenderer_tpu_torch.ops.integrate import \
    accumulate as accumulate_kernel
from volumetricrenderer_tpu_torch.ops.material import media_foldable
from volumetricrenderer_tpu_torch.ops.noise import sample_noise
from volumetricrenderer_tpu_torch.ops.pcf_shadow import (PcfTables,
                                                         pcf_shadow)
from volumetricrenderer_tpu_torch.ops.pcf_shadow import \
    pack_tables as pcf_pack_tables
from volumetricrenderer_tpu_torch.ops.phase import (henyey_greenstein,
                                                    rgb_to_gray, smoothstep)
from volumetricrenderer_tpu_torch.ops.sampling import (shift_sample_3d,
                                                       trilinear_sample_3d)
from volumetricrenderer_tpu_torch.ops.scatter import scatter_local
from volumetricrenderer_tpu_torch.ops.scatter_scan import accumulate_blocked
from volumetricrenderer_tpu_torch.ops.temporal import temporal_blend
from volumetricrenderer_tpu_torch.ops.visibility import (
    bake_radiance_from_maps, bake_visibility, bake_visibility_from_maps,
    low_res_world_positions, tent_taps, tent_taps_y)
from volumetricrenderer_tpu_torch.ops.warp import (windowed_warp,
                                                   windowed_warp_plain)


@dataclasses.dataclass(frozen=True)
class FrameGeometry:
    """What the plain-torch passes of one frame read, on the frame's device:
    the froxel params, the view matrices, the jitter [3], the blend weight
    alpha (0 on the first frame) and the array grid (W, H, D) (None: the
    global params.grid; a slab's own rows otherwise)."""
    params: FroxelParams
    view_to_world: torch.Tensor          # [4, 4]
    prev_world_to_view: torch.Tensor     # [4, 4]
    jitter: torch.Tensor                 # [3]
    alpha: float
    grid: Optional[Tuple[int, int, int]] = None

    @functools.cached_property
    def centre_texel(self):
        """reproject_texel at the unjittered centres with no uvw nudge:
        what the material, scatter and plain accumulation blends share."""
        return reproject_texel(self, False, 0.0)


# --------------------------------------------------------------------------
# Shared per-frame geometry
# --------------------------------------------------------------------------

def froxel_world_positions(cfg: RenderConfig, params: FroxelParams,
                           view_to_world: torch.Tensor,
                           jitter: Optional[torch.Tensor]) -> torch.Tensor:
    """World position of every froxel centre [D, H, W, 3] of the array grid
    cfg.grid, optionally jittered."""
    return _world_positions(cfg.grid, params, view_to_world, jitter)


def _world_positions(grid, params, view_to_world, jitter) -> torch.Tensor:
    """Local row i of `grid` is global row params.y0 + i, its centre
    clamped to [0.5, H_glob - 0.5]: the halo rows of a slab at the global
    edges repeat the edge row, as the clamp sampler would. A slab that
    starts at row 0 clamps too (its rows may run past the grid)."""
    centers = froxel.froxel_centers(grid, view_to_world.device)
    if params.y0 != 0 or grid[1] != params.grid[1]:
        cy = torch.clamp(centers[..., 1] + params.y0, 0.5,
                         params.grid[1] - 0.5)
        centers = torch.cat([centers[..., :1], cy[..., None],
                             centers[..., 2:]], dim=-1)
    if jitter is not None:
        centers = centers + jitter
    return froxel.froxel_to_world(params, view_to_world, centers)


def step_lengths(cfg: RenderConfig, params: FroxelParams) -> torch.Tensor:
    """Per-slice view-space dz [D]: view_z(i + 0.5) - view_z(i - 0.5), and
    view_z(0.5) - near for slice 0."""
    d = cfg.volume_depth
    centers = torch.arange(d, dtype=torch.float32,
                           device=params.near.device) + 0.5
    zc = froxel.froxel_z_to_view_z(params, centers)
    return zc - torch.cat([params.near[None], zc[:-1]])


# --------------------------------------------------------------------------
# Material volume
# --------------------------------------------------------------------------

def uses_scatter_kernel(cfg: RenderConfig, n_local: int,
                        local_maps=None) -> bool:
    """Whether the scatter pass runs kernel K6 (the JAX pass's
    `use_pallas_scatter`): scatter_impl="pallas", local lights, and in
    shadow_mode="map" their cube or spot maps (local_maps = (cube, spot);
    None: the maps the renderer bakes for those lights). Otherwise the
    plain XLA scatter serves the frame. The port's scenes always hold a
    geometry, which JAX's condition also asks for."""
    if cfg.scatter_impl != "pallas" or n_local == 0:
        return False
    return (cfg.shadow_mode != "map" or local_maps is None
            or any(m is not None for m in local_maps))


def fuses_material(cfg: RenderConfig, media: Sequence,
                   scatter_kernel: bool = True) -> bool:
    """Whether the scatter kernel evaluates the material itself (the JAX
    pass's `use_fused_material`); otherwise the scatter (the kernel, or
    the plain XLA scatter: scatter_kernel=False) reads material volumes."""
    return bool(cfg.material_impl == "fused" and scatter_kernel and media
                and not cfg.temporal_blend_material
                and media_foldable(media))


def _tent_up(vol: torch.Tensor, dim: int, taps) -> torch.Tensor:
    """vol tent-upsampled along `dim` from the two taps (k0, w) of
    visibility.tent_taps or tent_taps_y: the JAX package's upsample matmul,
    whose rows hold at most these two non-zero weights."""
    k0, wt = taps
    dev = vol.device
    n_l = vol.shape[dim]
    k = upload(np.stack([k0, np.minimum(k0 + 1, n_l - 1)]), dev, torch.int64)
    shape = [1] * vol.dim()
    shape[dim] = k.shape[1]
    wt = upload(wt, dev)
    return (vol.index_select(dim, k[0]) * wt[0].reshape(shape)
            + vol.index_select(dim, k[1]) * wt[1].reshape(shape))


_tent_taps = functools.lru_cache(maxsize=16)(tent_taps)
_tent_taps_y = functools.lru_cache(maxsize=16)(tent_taps_y)


def _sample_noise_lowres(cfg: RenderConfig, params: FroxelParams,
                         view_to_world: torch.Tensor, jitter: torch.Tensor,
                         medium, time_x, ss: int) -> torch.Tensor:
    """A texture medium's noise factor [D, H, W] sampled at the low grid of
    rate ss (visibility.low_res_world_positions) and tent-upsampled in z,
    y (with the slab's phase, as the bakes) and x."""
    d, h, w = cfg.grid_dhw
    world = low_res_world_positions(cfg, params, view_to_world, jitter, ss)
    low = sample_noise(medium, world, time_x)              # [DL, HL, WL]
    dl, hl, wl = low.shape
    up = _tent_up(low, 0, _tent_taps(d, dl, ss))
    up = _tent_up(up, 1, _tent_taps_y(h, hl, ss, float(params.y0)))
    return _tent_up(up, 2, _tent_taps(w, wl, ss))


def write_material_volumes(cfg: RenderConfig, params: FroxelParams,
                           view_to_world: torch.Tensor, jitter: torch.Tensor,
                           time_x, media: Sequence
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential fold over the media at the jittered froxel centres:
    (material_a [4, D, H, W], material_b [1, D, H, W]). A texture medium's
    factor is sampled at 1/texture_noise_subsample^3 of the froxels and
    tent-upsampled where that is above 1 and the grid has every row (not a
    slab's), else at every froxel."""
    d, h, w = cfg.grid_dhw
    dev = view_to_world.device
    mat_a = torch.zeros((4, d, h, w), dtype=torch.float32, device=dev)
    mat_b = torch.zeros((1, d, h, w), dtype=torch.float32, device=dev)
    if not media:
        return mat_a, mat_b
    world_j = froxel_world_positions(cfg, params, view_to_world, jitter)
    tx = float(np.float32(time_x))
    tex_ss = max(int(cfg.texture_noise_subsample), 1) \
        if h == params.grid[1] else 1
    for medium in media:
        a_new = torch.cat([medium.scattering_coef,
                           medium.absorption_coef[None]])[:, None, None, None]
        factor = torch.ones((d, h, w), dtype=torch.float32, device=dev)
        if medium.noise_mode == "procedural" or medium.noise_tex is not None:
            if tex_ss > 1 and medium.noise_mode != "procedural":
                factor = factor * _sample_noise_lowres(
                    cfg, params, view_to_world, jitter, medium, tx, tex_ss)
            else:
                factor = factor * sample_noise(medium, world_j, tx)
        factor = factor * torch.exp(
            -torch.clamp(medium.height_falloff, min=0.0)
            * torch.clamp(world_j[..., 1] - medium.height_base, min=0.0))
        a_new = a_new * factor[None]
        if medium.volume_type == BOX:
            soft = torch.clamp(medium.box_softness, min=1e-6)
            lo = torch.amin(smoothstep(medium.box_min, medium.box_min + soft,
                                       world_j), dim=-1)
            hi = torch.amin(smoothstep(-medium.box_max,
                                       -(medium.box_max - soft), -world_j),
                            dim=-1)
            mask = (lo * hi)[None]
        else:
            mask = torch.ones((1, d, h, w), dtype=torch.float32, device=dev)
        if medium.blend_type == ADDITIVE:
            mat_a = mat_a + a_new * mask
            mat_b = mat_b + medium.phase_g * mask
        else:
            mat_a = mat_a * (1.0 - mask) + a_new * mask
            mat_b = mat_b * (1.0 - mask) + medium.phase_g * mask
    return mat_a, mat_b


# --------------------------------------------------------------------------
# Shadow volume
# --------------------------------------------------------------------------

def uses_pcf_kernel(cfg: RenderConfig, dir_shadow, n_dir: int) -> bool:
    """Whether the sun shadow volume comes from the cascaded-PCF kernel
    (K12): the JAX pass's condition for `pcf_dir_shadow_pallas`, its
    128-multiple atlas included although K12 needs none, so that both
    packages take the same route."""
    return bool(cfg.dir_shadow_impl == "pallas"
                and cfg.shadow_mode in ("map", "map_dir")
                and dir_shadow is not None and dir_shadow.aligned
                and n_dir > 0 and dir_shadow.atlas.shape[-1] % 128 == 0)


def pcf_rate(cfg: RenderConfig) -> int:
    """dir_shadow_subsample where the low-rate PCF branch runs (the grid
    width and depth divide by it), else 1."""
    w, _, d = cfg.grid
    ssd = max(int(cfg.dir_shadow_subsample), 1)
    return ssd if ssd > 1 and w % ssd == 0 and d % ssd == 0 else 1


def pack_pcf_tables(cfg: RenderConfig, params: FroxelParams, view_to_world,
                    jitter, dir_lights, dir_shadow):
    """K12's tables for the frame (ops/pcf_shadow.pack_tables), on the CPU
    like every argument: at full rate, or on the low grid (W/N, H, D/N) with
    the jitter (jx/N, jy, jz/N) and params' depth D/N, whose samples sit
    exactly at the upsample's low-rate positions."""
    w, h, d = cfg.grid
    ssd = pcf_rate(cfg)
    grid = (w // ssd, h, d // ssd)
    params_l = dataclasses.replace(
        params, grid=(params.grid[0], params.grid[1], grid[2]))
    jit = np.asarray(jitter, np.float32).reshape(3) * np.asarray(
        [1.0 / ssd, 1.0, 1.0 / ssd], np.float32)
    return pcf_pack_tables(params_l, view_to_world, jit, dir_lights,
                           dir_shadow, grid)


@functools.lru_cache(maxsize=8)
def _z_lerp_np(d: int, dl: int, ssd: int):
    u = (np.arange(d) - (ssd - 1) * 0.5) / ssd
    ka = np.clip(np.floor(u).astype(np.int64), 0, dl - 1)
    t = np.clip(u - ka, 0.0, 1.0).astype(np.float32)
    return ka, np.minimum(ka + 1, dl - 1), t


def upsample_pcf(cfg: RenderConfig, low: torch.Tensor) -> torch.Tensor:
    """The low-rate shadow volume [Nd, D/N, H, W/N] at full rate: the JAX
    pass's z-lerp, then its x-tent `upsample_mats(W, W/N, N).T` as the two
    taps of visibility.tent_taps (the matrix has at most two non-zero
    weights per column)."""
    w, _, d = cfg.grid
    ssd = pcf_rate(cfg)
    ka, kb, t = _z_lerp_np(d, low.shape[1], ssd)
    dev = low.device
    idx = upload(np.stack([ka, kb]), dev, torch.int64)
    la, lb = low[:, idx[0]], low[:, idx[1]]
    full_z = la + upload(t, dev)[None, :, None, None] * (lb - la)
    return _tent_up(full_z, 3, _tent_taps(w, low.shape[3], ssd))


def write_shadow_volume_dir(cfg: RenderConfig, tables: FrameTables,
                            geo: Optional[FrameGeometry] = None,
                            dir_lights=None, geometry=None, dir_shadow=None,
                            pcf: Optional[PcfTables] = None) -> torch.Tensor:
    """Per-froxel sun visibility, squared and gated, without temporal blend:
    [Nd, D, H, W]. Routed as the JAX pass:

      raycast, dir_shadow_impl="pallas"  kernel K7 on the tables
      raycast, "xla"                     plain torch over raycast.occluded
      map modes, the PCF route           kernel K12 on `pcf` (pack_pcf_tables;
                                         uses_pcf_kernel), upsampled from the
                                         low grid where pcf_rate > 1
      map modes otherwise                the gather sampler
                                         shadow.sample_dir_shadow

    The plain routes need the frame's geometry record and the lights, the
    scene geometry and the shadow data on the frame's device. A scene
    without a sun gets one channel of ones, as the JAX pass pads it."""
    suns = tables.n_dir if tables is not None \
        else getattr(dir_lights, "count", None)
    if suns == 0:
        dev = tables.spar.device if tables is not None \
            else geo.view_to_world.device
        return torch.ones((1,) + tuple(cfg.grid_dhw), dtype=torch.float32,
                          device=dev)
    if cfg.shadow_mode == "raycast" and cfg.dir_shadow_impl == "pallas":
        return raycast_dir_shadow(tables)
    if pcf is not None:
        vol = pcf_shadow(pcf, dir_shadow.atlas)
        return vol if pcf_rate(cfg) == 1 else upsample_pcf(cfg, vol)
    world_j = froxel_world_positions(cfg, geo.params, geo.view_to_world,
                                     geo.jitter)
    channels = []
    for i in range(dir_lights.count):
        if cfg.shadow_mode == "raycast":
            occ = raycast.occluded(geometry, world_j,
                                   -dir_lights.direction[i], 1e4)
            strength_r = 1.0 - dir_lights.shadow_strength[i]
            vis = strength_r + (1.0 - strength_r) * (1.0 - occ)
        else:
            vis = shadow_lib.sample_dir_shadow(dir_shadow, i, world_j)
        vis = vis * vis
        gate = dir_lights.has_shadow[i].to(torch.float32)
        channels.append(1.0 + gate * (vis - 1.0))
    return torch.stack(channels)


# --------------------------------------------------------------------------
# Scatter volume
# --------------------------------------------------------------------------

def write_scatter_volume(cfg: RenderConfig, tables: FrameTables,
                         shadow: torch.Tensor, material=None,
                         geo: Optional[FrameGeometry] = None, scene=None,
                         local_maps=None, time_x=0.0) -> torch.Tensor:
    """In-scatter of every light: [4, D, H, W] (r, g, b, extinction).
    shadow: the (blended) sun visibility [Nd, D, H, W]. The local lights
    come from a low-rate bake where the tables have a low grid (tables.ss >
    1): the summed radiance (scatter_bake="radiance") or the per-light
    visibility, which the scatter's light loop then reads. With
    shadow_mode="map" the bake samples the cube and spot maps local_maps =
    (CubeShadowData or None, SpotShadowData or None) in plain torch and
    needs the frame's geometry record, the scene on the frame's device and
    time_x; otherwise it casts rays: kernel K1 (radiance) or K9. Without a
    low grid each froxel and light casts one any-hit shadow ray. material
    None: the kernel evaluates the media itself and writes the extinction.
    material = (material_a, material_b): it reads them, and the luma
    extinction is added here, once per sun.

    The scene (on the frame's device) decides the route with the config
    and local_maps (uses_scatter_kernel); where the kernel does not serve
    the frame it takes write_scatter_xla instead, over the material
    volumes and the frame's geometry record."""
    maps = local_maps if local_maps is not None else (None, None)
    if not uses_scatter_kernel(cfg, scene.point_lights.count
                               + scene.spot_lights.count, maps):
        return write_scatter_xla(cfg, geo, shadow, material, scene, maps)
    bake = vis = None
    # the radiance bake reads the media's phase g: without media the
    # per-light loop over the visibility bake serves, as in the JAX pass
    radiance = cfg.scatter_bake == "radiance" and bool(scene.media)
    if cfg.shadow_mode == "map":
        cube, spot = maps
        args = (cfg, geo.params, geo.view_to_world)
        lights = (scene.point_lights, scene.spot_lights, cube, spot)
        if radiance:
            bake = bake_radiance_from_maps(
                *args, scene.camera.position, geo.jitter, *lights,
                scene.media, time_x, tables.ss,
                bake_noise=tables.n_noise > 0)
        else:
            vis = bake_visibility_from_maps(*args, geo.jitter, *lights,
                                            tables.ss)
    elif tables.ss > 1:
        if radiance:
            bake = bake_radiance(tables)
        else:
            vis = bake_visibility(tables)
    out = scatter_local(tables, shadow, bake, vis, material)
    if material is None:
        return out
    mat_a = material[0]
    ext = torch.zeros_like(mat_a[3])
    for _ in range(tables.n_dir):
        ext = ext + rgb_to_gray(mat_a[0], mat_a[1], mat_a[2]) + mat_a[3]
    return torch.cat([out, ext[None]])


def write_scatter_xla(cfg: RenderConfig, geo: FrameGeometry,
                      shadow: torch.Tensor, material, scene,
                      local_maps=(None, None)) -> torch.Tensor:
    """The JAX pass's plain XLA scatter, in its term order: [4, D, H, W]
    (r, g, b, extinction). Each sun's colour x blended shadow x HG phase x
    sigma_s (at the unjittered centres unless cfg.jitter_dir_scatter) and
    the luma extinction once per sun; then each point and each spot light,
    in the scene's order: range (and cone) cull, LUT falloff, HG phase, and
    the local shadow -- in shadow_mode "raycast" / "map_dir" one any-hit
    ray a froxel and light (at raycast_shadow_subsample > 1 on the
    ss-subsampled xy grid, nearest-upsampled back), in "map" the light's
    cube or spot map where there is one. material = (material_a [4, D, H,
    W], material_b [1, D, H, W]); shadow [Nd, D, H, W]; local_maps =
    (CubeShadowData or None, SpotShadowData or None); everything on the
    frame's device."""
    d, h, w = cfg.grid_dhw
    mat_a, mat_b = material
    sigma_s = mat_a[:3]
    phase_g = mat_b[0]
    params, v2w = geo.params, geo.view_to_world
    world_c = froxel_world_positions(cfg, params, v2w, None)
    world_j = froxel_world_positions(cfg, params, v2w, geo.jitter)
    camera_pos = scene.camera.position
    geometry = scene.geometry
    ss = max(int(cfg.raycast_shadow_subsample), 1)

    def shadow_ray(light_pos, has_shadow):
        wp = world_j[:, ::ss, ::ss] if ss > 1 else world_j
        to_pos = wp - light_pos
        d2s = froxel.dot3(to_pos, to_pos)
        inv = torch.rsqrt(d2s + 1e-18)
        occ = raycast.occluded(
            geometry, wp, -(to_pos * inv[..., None]), d2s * inv - 0.05,
            include_heightfield=cfg.heightfield_local_shadows)
        if ss > 1:
            occ = occ.repeat_interleave(ss, dim=1).repeat_interleave(
                ss, dim=2)[:, :h, :w]
        return 1.0 - occ * has_shadow.to(torch.float32)

    light = [torch.zeros((d, h, w), dtype=torch.float32,
                         device=world_j.device) for _ in range(3)]
    extinction = torch.zeros_like(light[0])
    dirs = scene.dir_lights
    for _ in range(dirs.count):
        extinction = extinction + rgb_to_gray(*sigma_s) + mat_a[3]

    wp_dir = world_j if cfg.jitter_dir_scatter else world_c
    vd0 = wp_dir - camera_pos
    view_dir0 = vd0 * torch.rsqrt(froxel.dot3(vd0, vd0) + 1e-18)[..., None]
    dir_colors = dirs.packed_color
    for i in range(dirs.count):
        cos_theta = froxel.dot3(view_dir0, -dirs.direction[i])
        vis_hg = shadow[i] * henyey_greenstein(phase_g, cos_theta)
        light = [lc + vis_hg * dir_colors[i, c] * sigma_s[c]
                 for c, lc in enumerate(light)]

    local_raycast = cfg.shadow_mode in ("raycast", "map_dir")
    cube, spot = local_maps
    vdj = world_j - camera_pos
    view_dir_j = vdj * torch.rsqrt(froxel.dot3(vdj, vdj) + 1e-18)[..., None]

    def add_light(color, keep, factor, ldir, vis):
        """light + HG phase x factor x colour x sigma_s (x the local
        shadow vis, where there is one), culled by keep."""
        cos_theta = froxel.dot3(view_dir_j, -ldir)
        base = henyey_greenstein(phase_g, cos_theta) * factor
        contrib = [base * color[c] * sigma_s[c] for c in range(3)]
        if vis is not None:
            contrib = [ct * vis for ct in contrib]
        keep = keep.to(torch.float32)
        return [lc + ct * keep for lc, ct in zip(light, contrib)]

    def gated(vis, has_shadow):
        return 1.0 + has_shadow.to(torch.float32) * (vis - 1.0)

    pts = scene.point_lights
    point_colors = pts.packed_color
    for i in range(pts.count):
        to_pos = world_j - pts.position[i]
        d2 = froxel.dot3(to_pos, to_pos)
        inv_d = torch.rsqrt(d2 + 1e-18)
        dist = d2 * inv_d
        ldir = to_pos * inv_d[..., None]
        falloff = point_light_falloff(dist, pts.range[i],
                                      pts.intensity_multiplier[i])
        vis = None
        if local_raycast:
            vis = shadow_ray(pts.position[i], pts.has_shadow[i])
        elif cube is not None:
            vis = gated(shadow_lib.sample_cube_shadow(cube, i, to_pos),
                        pts.has_shadow[i])
        light = add_light(point_colors[i], dist <= pts.range[i], falloff,
                          ldir, vis)

    sps = scene.spot_lights
    spot_colors = sps.packed_color
    cos_outer, cos_inner_rcp = sps.cos_outer_cone, sps.cos_inner_cone_rcp
    for i in range(sps.count):
        to_pos = world_j - sps.position[i]
        d2 = froxel.dot3(to_pos, to_pos)
        inv_d = torch.rsqrt(d2 + 1e-18)
        dist = d2 * inv_d
        ldir = to_pos * inv_d[..., None]
        cos_angle = froxel.dot3(ldir, sps.direction[i])
        keep = (dist <= sps.range[i]) & (cos_angle >= cos_outer[i])
        falloff = spot_light_falloff(dist, cos_angle, sps.range[i],
                                     cos_outer[i], cos_inner_rcp[i],
                                     sps.intensity_multiplier[i])
        vis = None
        if local_raycast:
            vis = shadow_ray(sps.position[i], sps.has_shadow[i])
        elif spot is not None:
            vis = gated(shadow_lib.sample_spot_shadow(spot, i, world_j),
                        sps.has_shadow[i])
        light = add_light(spot_colors[i], keep, falloff, ldir, vis)
    return torch.stack(light + [extinction])


# --------------------------------------------------------------------------
# Accumulation
# --------------------------------------------------------------------------

def accumulate(cfg: RenderConfig, tables: FrameTables, scatter: torch.Tensor,
               params: Optional[FroxelParams] = None,
               from_kernel_planes: bool = True) -> torch.Tensor:
    """Front-to-back integration of the scatter volume without temporal
    blend: [4, D, H, W] (L_r, L_g, L_b, T). Kernel K8 with
    accumulate_impl="pallas" when the scatter volume is the scatter kernel's
    own planes; once it went through the scatter blend, or with
    accumulate_impl="xla", the plain jittered shift sample and two-level
    scan (needs params on the volume's device)."""
    if cfg.accumulate_impl == "pallas" and from_kernel_planes:
        return accumulate_kernel(tables, scatter)
    sampled = shift_sample_3d(scatter, tables.jitter)
    return accumulate_blocked(sampled[:3], sampled[3],
                              step_lengths(cfg, params))


# --------------------------------------------------------------------------
# Temporal blends
# --------------------------------------------------------------------------

def reproject_texel(geo: FrameGeometry, jittered: bool, uvw_epsilon: float):
    """Current froxel centre -> previous-frame froxel position through the
    world: (texel x, y, z and the xy reprojection success, each
    [D, H, W] of the array grid). Froxel space and the success test are
    global; texel y comes back in local rows (minus params.y0)."""
    w, h, d = geo.params.grid
    world = _world_positions(geo.grid or geo.params.grid, geo.params,
                             geo.view_to_world, None)
    prev_pos = froxel.world_to_froxel(geo.params, geo.prev_world_to_view,
                                      world)
    if jittered:
        prev_pos = prev_pos + geo.jitter
    dims = upload([w, h, d], prev_pos.device)
    uvw = prev_pos / dims + uvw_epsilon
    texel = uvw * dims - 0.5
    in01 = (uvw[..., 0] >= 0.0) & (uvw[..., 0] <= 1.0) \
        & (uvw[..., 1] >= 0.0) & (uvw[..., 1] <= 1.0)
    tx, ty, tz = (texel[..., c].contiguous() for c in range(3))
    if geo.params.y0 != 0:
        ty = ty - geo.params.y0
    return tx, ty, tz, in01.to(torch.float32)


def sample_prev(cfg: RenderConfig, vol: torch.Tensor, tx, ty,
                 tz) -> torch.Tensor:
    """History channels vol [C, D, H, W] resampled at the reprojected texel
    coordinates: "gather" the joint trilinear sample, "windowed" the
    separable windowed warp in plain torch, "pallas" the same warp on
    kernel K11."""
    if cfg.reproj_impl == "gather":
        return trilinear_sample_3d(vol, tx, ty, tz)
    if cfg.reproj_impl == "pallas":
        return windowed_warp(vol, tx, ty, tz, cfg.reproj_window)
    return windowed_warp_plain(vol, tx, ty, tz, cfg.reproj_window)


def temporal_blend_shadow(cfg: RenderConfig, tables: FrameTables,
                          geo: FrameGeometry, shadow: torch.Tensor,
                          prev_shadow: torch.Tensor) -> torch.Tensor:
    """Reproject with the jitter and the 1e-4 uvw nudge; blend weight
    alpha * reprojection success. [Nd, D, H, W]."""
    if cfg.reproj_impl == "pallas":
        return temporal_blend(tables.sbpar, prev_shadow, shadow,
                              tables.grid_whd, tables.h_glob, tables.k,
                              "weight")
    tx, ty, tz, success = reproject_texel(geo, True, 1e-4)
    prev = sample_prev(cfg, prev_shadow, tx, ty, tz)
    return shadow + (prev - shadow) * (geo.alpha * success)


def _blend_at_centres(cfg, geo, cur, prev_vol):
    tx, ty, tz, success = geo.centre_texel
    prev = sample_prev(cfg, prev_vol, tx, ty, tz)
    return cur + (prev - cur) * (geo.alpha * success)


def temporal_blend_scatter(cfg: RenderConfig, geo: FrameGeometry,
                           scatter: torch.Tensor,
                           prev_scatter: torch.Tensor) -> torch.Tensor:
    """The scatter blend (off in the Unity reference): no jitter, weight
    alpha * reprojection success. [4, D, H, W]."""
    return _blend_at_centres(cfg, geo, scatter, prev_scatter)


def temporal_blend_material(cfg: RenderConfig, geo: FrameGeometry,
                            material_a: torch.Tensor,
                            prev_material_a: torch.Tensor) -> torch.Tensor:
    """The material blend (off in the Unity reference), as the scatter
    blend. [4, D, H, W]."""
    return _blend_at_centres(cfg, geo, material_a, prev_material_a)


def temporal_blend_accumulation(cfg: RenderConfig, tables: FrameTables,
                                geo: FrameGeometry,
                                accumulation: torch.Tensor,
                                prev_accumulation: torch.Tensor
                                ) -> torch.Tensor:
    """The accumulation blend: success is warped T != 0, not the uv bound
    test. [4, D, H, W]."""
    if cfg.reproj_impl == "pallas":
        return temporal_blend(tables.abpar, prev_accumulation, accumulation,
                              tables.grid_whd, tables.h_glob, tables.k,
                              "alpha")
    tx, ty, tz, _ = geo.centre_texel
    prev = sample_prev(cfg, prev_accumulation, tx, ty, tz)
    success = (prev[3] != 0.0).to(torch.float32)
    return accumulation + (prev - accumulation) * (geo.alpha * success)
