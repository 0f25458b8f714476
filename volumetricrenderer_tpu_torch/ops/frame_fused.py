"""The production volume phase: shadow -> shadow blend -> scatter ->
integrate -> accumulation blend, with the local lights from a low-rate bake
or from one shadow ray per light.

Port of `volumetricrenderer_tpu/ops/pallas/frame_fused.py`
`frame_volume_fused`. The TPU ran it as one staggered `pallas_call` whose
sequential grid carried the histories and the (L, T) integral in VMEM rings
and baked the low-rate volume into a ring on its own schedule; on the GPU it
is a chain of kernels, held as one unit against the JAX function:

  K1 bake_radiance    low volume [3 + n_noise, DL, HL, WL] (inline radiance
                      bake, ss > 1; with a texture medium K1 bakes the
                      radiance alone and every noise channel comes from
                      ops/visibility.bake_noise_channels), or
  K9 bake_visibility  low volume [NL, DL, HL, WL] (inline visibility bake,
                      ss > 1; ops/visibility.py), or no bake (ss = 1)
  K2 shadow_scatter   new shadow history [Nd, D, H, W] + scatter [4, D, H, W],
                      the local lights from the bake or one ray per light
  K3 integrate_blend  new accumulation [4, D, H, W]

Each wrapper launches its CUDA kernel (csrc/) for CUDA tensors and runs its
plain-torch twin (`*_plain`, same module) for CPU tensors; a CUDA tensor
never falls back to the twin. Histories are written to new buffers. Each
wrapper refuses, by the kernel's name and before any launch, a table whose
arrays the kernel cannot index (check_k1_indices, k2_form, k3_form,
ops/visibility.k9_form); K2, K3 and K9 take a wide form (64-bit indices,
the slices or rows launched in parts) past their narrow one, and `form=`
forces either. Past a block's shared memory (K2 from a reprojection window
of k = 52, K3 from k = 159) K2 and K3 read their reprojection offsets from
device memory (the region_global form: ops/temporal.region_form,
k3_window_form).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops import dir_shadow as dir_shadow_lib
from volumetricrenderer_tpu_torch.ops.integrate import accumulate_plain
from volumetricrenderer_tpu_torch.ops.material import (heightfield_static,
                                                       noise_factor_planes,
                                                       pack_heightfield,
                                                       pack_media,
                                                       phase_g_plane)
from volumetricrenderer_tpu_torch.ops.occlude import pack_boxes
from volumetricrenderer_tpu_torch.ops.phase import PI
from volumetricrenderer_tpu_torch.ops.scatter import (LOCAL_BAKED,
                                                      LOCAL_RADIANCE,
                                                      MAX_GRID_Z, MAX_NOISE,
                                                      check_scatter_inputs,
                                                      local_mode,
                                                      needs_general,
                                                      pack_dir_lights,
                                                      pack_lights,
                                                      pack_params,
                                                      scatter_local_plain,
                                                      slice_light_order,
                                                      sun_form,
                                                      sun_inv_bytes)
from volumetricrenderer_tpu_torch.ops.shadow_blend import (
    dir_shadow_blend_plain)
from volumetricrenderer_tpu_torch.ops.temporal import (
    MAX_SHARED_BYTES, TILE_STATIC_SHARED, check_shared, global_index,
    pack_blend_params, region_form, region_shared_bytes, reproj_offsets, warp)
from volumetricrenderer_tpu_torch.ops.visibility import (bake_radiance_plane,
                                                         bake_visibility,
                                                         bake_world_planes,
                                                         low_res_dims,
                                                         low_slice_active,
                                                         radiance_view_dirs,
                                                         tent_taps,
                                                         tent_taps_y,
                                                         y_phase)


@dataclasses.dataclass(frozen=True)
class FrameTables:
    """Host prep of one frame: the packed tables the kernels read (float32
    or int32 tensors on the frame's device) and the static counts. A table
    is None where the frame has no use for it: the low-grid tables (active,
    tent_x, tent_y) at ss = 1, the full-rate light schedule (order, count)
    where no per-light scatter runs, and the tables of a scene part that was
    not given."""
    spar: torch.Tensor        # [1, 25] pack_params (jittered) + y phase
    sbpar: torch.Tensor       # [1, 24] shadow blend (jitter, eps 1e-4)
    abpar: torch.Tensor       # [1, 28] acc blend (no jitter, eps 0) + jitter
    slights: Optional[torch.Tensor]     # [Nd, 8] dir_shadow.pack_dir_lights
    dirs: Optional[torch.Tensor]        # [Nd, 8] scatter.pack_dir_lights
    lights: Optional[torch.Tensor]      # [NL, 16]
    planes: Optional[torch.Tensor]      # [max(P,1), 4]
    spheres: Optional[torch.Tensor]     # [max(S,1), 4]
    boxes: Optional[torch.Tensor]       # [max(B,1), 8]
    med: Optional[torch.Tensor]         # [M, 20]
    med_static: Optional[torch.Tensor]  # [M, 6] int32
    active: Optional[torch.Tensor]      # [NL, DL] int32 (low_slice_active)
    tent_x: Optional[Tuple[torch.Tensor, torch.Tensor]]  # (k0 [W], w [2, W])
    # (k0 [H], w [2, H]) of the y tent, with the slab's y phase
    tent_y: Optional[Tuple[torch.Tensor, torch.Tensor]]
    order: Optional[torch.Tensor]       # [D, NL] int32 (slice_light_order)
    count: Optional[torch.Tensor]       # [D] int32
    hf: Optional[torch.Tensor]          # [1, 6] pack_heightfield (terrain)
    jitter: np.ndarray        # [3] float32, host copy
    media_static: tuple
    grid_whd: Tuple[int, int, int]
    h_glob: int
    k: int
    ss: int
    n_dir: int
    n_planes: int
    n_spheres: int
    n_boxes: int
    n_noise: int
    jitter_dir: bool
    # the terrain march: (octaves, period, seed, steps, far) where the
    # geometry has a heightfield, else None; hf_local: local-light rays
    # march it too (heightfield_local_shadows); fractional: box opacity
    # below 1 somewhere (the any-hit returns an occlusion amount)
    hf_static: Optional[tuple] = None
    hf_local: bool = False
    fractional: bool = False

    @property
    def low_dims(self):
        """(WL, HL, DL) of the low grid; zeros at ss = 1, which has none."""
        return low_res_dims(self.grid_whd, self.ss) if self.ss > 1 \
            else (0, 0, 0)

    @property
    def texture_noise(self) -> bool:
        """Whether a medium samples a noise texture: its noise channels are
        then made outside the kernels (visibility.bake_noise_channels)."""
        return any(st[0] == 2 for st in self.media_static)

    @property
    def local_source(self) -> str:
        """Where the volume phase takes the local lights from: "radiance"
        (the K1 bake: a low grid and no light schedule), "baked" (the
        per-light loop over the K9 visibility bake: both) or "ray" (the
        per-light loop with one shadow ray each: no low grid)."""
        if self.ss < 2:
            return "ray"
        return "radiance" if self.order is None else "baked"

    def occluders(self, local: bool) -> dict:
        """The any-hit twin's keyword arguments (ops/occlude.any_hit) for a
        sun ray (local False: the terrain whenever there is one) or a
        local-light ray (the terrain only with hf_local)."""
        march = self.hf_static is not None and (self.hf_local or not local)
        return dict(n_planes=self.n_planes, n_spheres=self.n_spheres,
                    n_boxes=self.n_boxes, hf=self.hf,
                    hf_static=self.hf_static if march else None,
                    fractional=self.fractional)

    def to(self, device) -> "FrameTables":
        """The same tables on `device` (cuda.move_tables: one float32 and
        one int32 buffer, copied once)."""
        return cuda.move_tables(self, device)

    def c_struct(self) -> cuda.VrTables:
        """The ctypes mirror of csrc/common.cuh VrTables."""
        w, h, d = self.grid_whd
        wl, hl, dl = self.low_dims
        p = lambda t: None if t is None else cuda.ptr(t)   # None: NULL
        rows = lambda t: 0 if t is None else t.shape[0]
        tent_x = self.tent_x or (None, None)
        tent_y = self.tent_y or (None, None)
        hs = self.hf_static or (0, 0, 0, 0, 0.0)
        return cuda.VrTables(
            p(self.spar), p(self.sbpar), p(self.abpar), p(self.slights),
            p(self.dirs), p(self.lights), p(self.planes), p(self.spheres),
            p(self.boxes), p(self.med), p(self.med_static), p(self.active),
            p(tent_x[0]), p(tent_x[1]), p(tent_y[0]), p(tent_y[1]),
            p(self.order), p(self.count), p(self.hf), self.n_dir,
            rows(self.lights), self.n_planes, self.n_spheres, self.n_boxes,
            rows(self.med), self.n_noise, int(self.jitter_dir), w, h, d,
            self.h_glob, self.k, self.ss, wl, hl, dl, *hs[:4],
            int(self.hf_local), int(self.fractional), hs[4])


@functools.lru_cache(maxsize=16)
def _tent_np(n: int, nl: int, ss: int):
    return tent_taps(n, nl, ss)


@functools.lru_cache(maxsize=32)
def _tent_y_np(n: int, nl: int, ss: int, phase: float):
    # the phase alone shapes the table: (-y0) mod ss == phase
    return tent_taps_y(n, nl, ss, -phase)


def frame_tables(params, view_to_world, prev_world_to_view, jitter, alpha,
                 dir_lights, point_lights, spot_lights, geometry, media,
                 time_x, camera_pos, grid_whd: Tuple[int, int, int], k: int,
                 vis_ss: int, bake_noise: bool,
                 jitter_dir: bool = False,
                 light_schedule: Optional[bool] = None,
                 heightfield_local: bool = False) -> FrameTables:
    """Pack every table of one frame: plain torch on the CPU, where the
    scene description must lie (FrameTables.to moves the result).

    grid_whd is the array grid, params.grid the global one: they differ for
    a slab of an H-sharded frame, whose global row offset params.y0 the
    tables carry (spar[0, 23], sbpar and abpar) with its y phase
    (visibility.y_phase, spar[0, 24]), which K1 and K9 add to their low
    rows and the y tent carries.

    vis_ss > 1 packs the low grid of the low-rate bakes (active, tent taps);
    vis_ss = 1 has no low grid. light_schedule packs the full-rate light
    schedule of the per-light scatter (order, count); by default only at
    vis_ss = 1, and the per-light scatter over the baked visibility asks for
    it beside the low grid. A scene part passed as None (dir_lights, the
    local lights, geometry, media) leaves its tables None: the
    single-kernel wrappers pack only what their kernel reads. A geometry's
    heightfield packs the terrain row, which every sun ray marches and the
    local-light rays only with heightfield_local (the config's
    heightfield_local_shadows)."""
    w, h, d = grid_whd
    if view_to_world.device.type != "cpu":
        raise ValueError("frame tables are packed on the host: pass the "
                         "scene description on the CPU")
    nd = dir_lights.count if dir_lights is not None else 0
    jit = np.asarray(jitter, np.float32).reshape(3)
    if camera_pos is None:
        camera_pos = torch.zeros(3)
    phase = y_phase(params.y0, vis_ss)
    spar = torch.cat([pack_params(params, view_to_world, camera_pos, jit),
                      torch.tensor([[phase]], dtype=torch.float32)], dim=1)
    sbpar = pack_blend_params(params, view_to_world, prev_world_to_view, jit,
                              alpha, 1e-4)
    abpar = pack_blend_params(params, view_to_world, prev_world_to_view,
                              np.zeros(3, np.float32), alpha, 0.0)
    abpar = torch.cat([abpar, torch.tensor([[jit[0], jit[1], jit[2], 0.0]],
                                           dtype=torch.float32)], dim=1)

    planes = spheres = boxes = hf = hf_static = None
    n_planes = n_spheres = n_boxes = 0
    fractional = False
    if geometry is not None:
        fractional = bool(geometry.box_fractional)
        if geometry.hf_enabled:
            hf = pack_heightfield(geometry).contiguous()
            hf_static = heightfield_static(geometry)
        planes = torch.cat([geometry.plane_normal, geometry.plane_d[:, None]],
                           dim=-1)
        spheres = torch.cat([geometry.sphere_center,
                             geometry.sphere_radius[:, None]], dim=-1)
        boxes = pack_boxes(geometry)
        n_planes, n_spheres, n_boxes = (planes.shape[0], spheres.shape[0],
                                        boxes.shape[0])
        z = lambda c: torch.zeros((1, c), dtype=torch.float32)
        planes = (planes if n_planes else z(4)).contiguous()
        spheres = (spheres if n_spheres else z(4)).contiguous()
        boxes = (boxes if n_boxes else z(8)).contiguous()

    med = med_static = None
    media_static = ()
    if media:
        med, media_static = pack_media(media, time_x)
        med = med.contiguous()
        med_static = torch.tensor([[int(v) for v in st]
                                   for st in media_static], dtype=torch.int32)
    # the noise channels ride the radiance volume: without one (ss = 1) the
    # scatter evaluates the Perlin per froxel
    n_noise = sum(1 for st in media_static if st[0]) \
        if bake_noise and vis_ss > 1 else 0

    lights = active = order = count = tent_x = tent_y = None
    if vis_ss > 1:
        wl, hl, dl = low_res_dims(grid_whd, vis_ss)

        def tent(taps):
            k0, wt = taps
            return (torch.as_tensor(k0, dtype=torch.int32),
                    torch.as_tensor(wt, dtype=torch.float32))

        tent_x = tent(_tent_np(w, wl, vis_ss))
        tent_y = tent(_tent_y_np(h, hl, vis_ss, float(phase)))
    if point_lights is not None:
        lights = pack_lights(point_lights, spot_lights).contiguous()
        positions = torch.cat([point_lights.position, spot_lights.position])
        ranges = torch.cat([point_lights.range, spot_lights.range])
        if vis_ss > 1:
            active = low_slice_active(params, view_to_world, positions,
                                      ranges, grid_whd,
                                      vis_ss).to(torch.int32).contiguous()
        if light_schedule is None:
            light_schedule = vis_ss == 1
        if light_schedule:
            order, count = slice_light_order(params, view_to_world,
                                             positions, ranges, grid_whd)
            order, count = order.contiguous(), count.contiguous()

    return FrameTables(
        spar=spar.contiguous(), sbpar=sbpar.contiguous(),
        abpar=abpar.contiguous(),
        slights=dir_shadow_lib.pack_dir_lights(dir_lights).contiguous()
        if nd else None,
        dirs=pack_dir_lights(dir_lights).contiguous() if nd else None,
        lights=lights, planes=planes, spheres=spheres, boxes=boxes, med=med,
        med_static=med_static, active=active, tent_x=tent_x, tent_y=tent_y,
        order=order, count=count, hf=hf, jitter=jit,
        media_static=media_static,
        grid_whd=grid_whd, h_glob=params.grid[1], k=k, ss=vis_ss, n_dir=nd,
        n_planes=n_planes, n_spheres=n_spheres, n_boxes=n_boxes,
        n_noise=n_noise, jitter_dir=jitter_dir, hf_static=hf_static,
        hf_local=bool(heightfield_local), fractional=fractional)


# --------------------------------------------------------------------------
# K1 bake_radiance (csrc/bake_radiance.cu)
# --------------------------------------------------------------------------

def bake_radiance_plain(t: FrameTables) -> torch.Tensor:
    """Twin of K1: [3 + n_noise, DL, HL, WL] low-rate radiance + fBm."""
    wl, hl, dl = t.low_dims
    dev = t.spar.device
    ms = torch.arange(dl, device=dev)[:, None, None]
    wx, wy, wz = bake_world_planes(t.spar, ms, t.grid_whd, t.ss, t.h_glob)
    vdx, vdy, vdz = radiance_view_dirs(t.spar, wx, wy, wz)
    phg = phase_g_plane(t.med, t.media_static, wx, wy, wz)
    g2 = phg * phg
    hg_num = (1.0 - g2) / (4.0 * PI)
    acc = [torch.zeros_like(wx) for _ in range(3)]
    for li in range(t.lights.shape[0]):
        rgb = bake_radiance_plane(t.lights, li, wx, wy, wz, vdx, vdy, vdz,
                                  phg, g2, hg_num, t.planes, t.spheres,
                                  t.boxes, **t.occluders(local=True))
        act = t.active[li].bool()[:, None, None]
        acc = [torch.where(act, a + c, a) for a, c in zip(acc, rgb)]
    noise = noise_factor_planes(t.med, t.media_static, wx, wy, wz) \
        if t.n_noise else []
    return torch.stack(acc + noise)


# K1's launch (csrc/bake_radiance.cu): blocks of K1_WARPS warps, each owning
# a patch of samples of one low slice, a warp's 32 samples K1_WX columns x
# 32 / K1_WX rows, in at most K1_WARPS light groups; the lights of a pass,
# one ballot.
K1_WARPS = 4
K1_PASS = 32
K1_WX = 16
K1_TERMS = 9
K1_OCT = 4


@dataclasses.dataclass(frozen=True)
class K1Geometry:
    blocks: int
    threads: int
    samples: int        # low samples a block, 32 x K1_WARPS / groups
    groups: int         # light groups: warps of a sample share its lights
    passes: int         # passes of K1_PASS lights, the sums carried over
    shared_bytes: int   # dynamic: per-sample terms, one pass's pairs and
    #                     K1_OCT fBm octaves a channel, and past MAX_NOISE
    #                     channels the fBm items (K1_OCT + 2 int32 a
    #                     channel; none with one group: a thread per sample)
    columns: int        # a block's patch of its low slice
    rows: int


def k1_groups(n_lights: int, n_noise: int) -> int:
    """Mirror of csrc/bake_radiance.cu k1_groups: the light groups of a K1
    launch, the least power of two that takes the first pass's items (its
    lights and the fBm channels), at most K1_WARPS."""
    items = min(n_lights, K1_PASS) + n_noise
    groups = 1
    while groups < items and groups < K1_WARPS:
        groups *= 2
    return groups


def k1_shared_bytes(n_lights: int, n_noise: int, groups: int) -> int:
    """Mirror of csrc/bake_radiance.cu k1_shared: the fixed and general
    forms' dynamic shared bytes, per sample of the block its terms, one
    pass's pairs and K1_OCT fBm octaves a channel, and past MAX_NOISE
    channels the fBm items (K1_OCT + 2 int32 a channel); none with one
    light group (a thread per sample)."""
    if groups == 1:
        return 0
    return 4 * 32 * (K1_WARPS // groups) * (
        K1_TERMS + min(n_lights, K1_PASS) + n_noise * K1_OCT) \
        + (4 * n_noise * (K1_OCT + 2) if n_noise > MAX_NOISE else 0)


def k1_chunked_bytes(n_lights: int, chunk: int, samples: int) -> int:
    """Mirror of csrc/bake_radiance.cu k1_chunked_shared: the chunked
    form's dynamic shared bytes with `chunk` staged fBm channels (the
    general form's, their items always in shared memory)."""
    return 4 * ((K1_TERMS + min(n_lights, K1_PASS) + chunk * K1_OCT)
                * samples + chunk * (K1_OCT + 2))


def k1_chunk_of(n_lights: int, n_noise: int, samples: int) -> int:
    """Mirror of csrc/bake_radiance.cu k1_chunk_of: the most fBm channels
    whose octaves and items fit a block's shared memory beside the
    per-sample terms and one pass's pairs, at most n_noise."""
    room = (MAX_SHARED_BYTES - TILE_STATIC_SHARED) // 4 \
        - k1_chunked_bytes(n_lights, 0, samples) // 4
    return min(n_noise, room // (K1_OCT * samples + K1_OCT + 2))


def k1_plan(n_lights: int, n_noise: int,
            chunk: Optional[int] = None) -> Tuple[str, int]:
    """Mirror of csrc/bake_radiance.cu vr_bake_radiance_plan: the form of
    cuda.FORM_NAMES["bake_radiance"] that K1 takes for n_lights local
    lights and n_noise fBm channels, and the channels it stages in shared
    memory. "fixed" up to MAX_NOISE channels; past them "general", the fBm
    items in dynamic shared memory after the octaves; past the channels
    whose octaves and items fit a block's shared memory, "chunked": the
    first k1_chunk_of channels staged as the general form stages them, each
    channel past them a whole item (k1_chunks). chunk: the chunked form
    forced with that many staged channels. Raises ValueError, naming K1,
    for a forced chunk the launch cannot take (one light group has no
    items to spread)."""
    groups = k1_groups(n_lights, n_noise)
    samples = 32 * (K1_WARPS // groups)
    most = k1_chunk_of(n_lights, n_noise, samples)
    if chunk is not None:
        if groups == 1 or not 0 <= chunk <= most:
            raise ValueError(
                f"K1's chunked form cannot stage {chunk} of {n_noise} fBm "
                f"channels at {n_lights} lights: it spreads its items over "
                f"light groups ({groups}) and stages at most {most}")
        return "chunked", chunk
    if n_noise <= MAX_NOISE:
        return "fixed", n_noise
    if groups > 1 and k1_shared_bytes(n_lights, n_noise, groups) \
            + TILE_STATIC_SHARED > MAX_SHARED_BYTES:
        return "chunked", most
    return "general", n_noise


def k1_geometry(n_lights: int, n_noise: int,
                low_dims: Tuple[int, int, int],
                chunk: Optional[int] = None) -> K1Geometry:
    """Mirror of csrc/bake_radiance.cu vr_bake_radiance_geometry: K1's
    launch for the low grid (WL, HL, DL) in the form k1_plan picks (chunk:
    the chunked form forced, as there). Its light groups are k1_groups';
    the warps of a group lie one below the other, so that a block owns a
    patch of its low slice, the ragged patches at the slice's edges masked.
    Past MAX_NOISE channels the general form's fBm items sit in dynamic
    shared memory after the octaves; the chunked form's shared memory holds
    its staged channels' (k1_chunked_bytes)."""
    wl, hl, dl = low_dims
    groups = k1_groups(n_lights, n_noise)
    sw = K1_WARPS // groups
    cols, rows = K1_WX, sw * (32 // K1_WX)
    form, staged = k1_plan(n_lights, n_noise, chunk)
    return K1Geometry(
        blocks=-(-wl // cols) * -(-hl // rows) * dl, threads=32 * K1_WARPS,
        samples=32 * sw, groups=groups,
        passes=max(1, -(-n_lights // K1_PASS)),
        shared_bytes=k1_chunked_bytes(n_lights, staged, 32 * sw)
        if form == "chunked" else k1_shared_bytes(n_lights, n_noise, groups),
        columns=cols, rows=rows)


def k1_chunks(n_lights: int, n_noise: int,
              chunk: Optional[int] = None) -> tuple:
    """The chunk plan of a K1 launch (k1_plan) over n_noise fBm channels:
    (first channel, count) of the channels staged in shared memory and, in
    the chunked form, of the whole-channel items past them, in channel
    order."""
    staged = k1_plan(n_lights, n_noise, chunk)[1]
    return ((0, staged),) if staged == n_noise \
        else ((0, staged), (staged, n_noise - staged))


def check_k1_indices(t: FrameTables) -> None:
    """Refuse, naming K1, the tables whose arrays K1 cannot index (mirror
    of csrc/bake_radiance.cu k1_fits). K1 writes its [3 + n_noise, DL, HL,
    WL] volume at 64-bit offsets on a 1-D grid of blocks, so neither that
    volume's size nor the slice count limits it, and it has no wide form;
    it indexes the cull table [NL, DL] and the lights table [NL, 16] in 32
    bits, on at most 2^31 - 1 blocks. Raises ValueError."""
    n_lights = 0 if t.lights is None else t.lights.shape[0]
    dl = t.low_dims[2]
    why = (cuda.past_int32("the cull table [NL, DL]", n_lights, dl)
           or cuda.past_int32("the lights table [NL, 16]", n_lights, 16)
           or cuda.past_int32("the launch grid's blocks", k1_geometry(
               n_lights, t.n_noise, t.low_dims).blocks))
    if why is not None:
        raise ValueError(f"K1 cannot take the table: {why}")


def k1_tables(t: FrameTables) -> FrameTables:
    """The tables K1 is launched on: `t`, or with a texture medium `t`
    without noise channels (n_noise 0), so that K1 writes the radiance
    channels alone; its channel stride is the low grid's size whatever the
    channel count, so the radiance lands in the first three channels of
    the [3 + n_noise] volume that K2 then reads with t's n_noise."""
    return dataclasses.replace(t, n_noise=0) if t.texture_noise else t


def bake_radiance(t: FrameTables,
                  noise: Optional[torch.Tensor] = None,
                  form: Optional[str] = None,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """K1: the low-rate radiance (+ fBm) volume [3 + n_noise, DL, HL, WL].
    With a texture medium and noise channels (the fused frame), `noise`
    [n_noise, DL, HL, WL] (visibility.bake_noise_channels) fills channels
    3.. and K1 bakes channels 0-2 (k1_tables); otherwise noise is None.
    CUDA tables launch the form k1_geometry picks; form="chunked" forces
    the chunked form, with `chunk` staged channels (None: the most that
    fit); "fixed" and "general" take only the counts that take them."""
    k1 = k1_tables(t)
    wl, hl, dl = t.low_dims
    want = None if k1.n_noise == t.n_noise else (t.n_noise, dl, hl, wl)
    got = None if noise is None else tuple(noise.shape)
    if got != want:
        raise ValueError(f"noise channels {got}: the tables want {want} "
                         "(a texture medium's noise comes from "
                         "visibility.bake_noise_channels)")
    if t.spar.device.type == "cpu":
        out = bake_radiance_plain(k1)
        return out if noise is None else torch.cat([out, noise])
    n_lights = 0 if k1.lights is None else k1.lights.shape[0]
    names = cuda.FORM_NAMES["bake_radiance"]
    if form is not None and form not in names:
        raise ValueError(f"K1: form {form!r} is none of {names}")
    rule, staged = k1_plan(n_lights, k1.n_noise)
    if form == "chunked":  # chunk None: the most that fit
        if chunk is None:
            chunk = k1_chunk_of(n_lights, k1.n_noise, 32 * (
                K1_WARPS // k1_groups(n_lights, k1.n_noise)))
        rule, staged = k1_plan(n_lights, k1.n_noise, chunk)
    elif form not in (None, rule):
        raise ValueError(f"K1's {form} form cannot take {k1.n_noise} fBm "
                         f"channels: the counts take its {rule} form")
    check_shared(k1_geometry(n_lights, k1.n_noise, t.low_dims,
                             staged if rule == "chunked" else None
                             ).shared_bytes,
                 "K1", f"{k1.n_noise} fBm channels")
    check_k1_indices(k1)
    cuda.check_cuda(t.spar)
    out = torch.empty((3 + t.n_noise, dl, hl, wl), dtype=torch.float32,
                      device=t.spar.device)
    if noise is not None:
        cuda.check_cuda(noise)
        out[3:].copy_(noise)
    st = k1.c_struct()
    if form == "chunked":
        cuda.launch("bake_radiance", cuda.ctypes.byref(st), cuda.ptr(out),
                    staged, entry="vr_bake_radiance_chunked")
    else:
        cuda.launch("bake_radiance", cuda.ctypes.byref(st), cuda.ptr(out))
    return out


# --------------------------------------------------------------------------
# K2 shadow_scatter (csrc/shadow_scatter.cu)
# --------------------------------------------------------------------------

def shadow_scatter_plain(t: FrameTables, prev_shadow: torch.Tensor,
                         bake: Optional[torch.Tensor] = None,
                         vis: Optional[torch.Tensor] = None):
    """Twin of K2: (blended shadow [Nd, D, H, W], scatter [4, D, H, W]): the
    twins of K5 and of K6 chained, K6 in the mode of the local source (the
    radiance bake, the visibility bake `vis` or, both None, rays)."""
    blended = dir_shadow_blend_plain(t, prev_shadow)
    return blended, scatter_local_plain(t, blended, bake, vis)


# K2's block (csrc/shadow_scatter.cu K2Tile): 16 columns x 16 rows of one
# slice, in every local source; its shadow half is K5's
# (ops/shadow_blend.K5_TILE, ops/temporal.region_shared_bytes).
K2_TILE = (16, 16)


def k2_shared_bytes(k: int, n_dir: int = 0, n_noise: int = 0) -> int:
    """The dynamic shared bytes of a K2 launch at reprojection window k:
    its tile's reprojection region (temporal.region_shared_bytes) and, in
    the general form (scatter.needs_general: more than MAX_DIR suns or
    MAX_NOISE fBm channels), the suns' inverse ray directions."""
    return region_shared_bytes(K2_TILE, k) + (
        sun_inv_bytes(n_dir) if needs_general(n_dir, n_noise) else 0)


def k2_form(t: FrameTables, local: int, form: Optional[str] = None) -> str:
    """Mirror of csrc/shadow_scatter.cu k2_form: the index form of
    cuda.INDEX_FORMS that K2 takes for the tables and local source `local`
    (scatter.LOCAL_*). The narrow form takes tables whose [max(4, Nd), D, H,
    W] planes, the low channels the local source reads (the radiance: 3 +
    n_noise; the visibility: NL; the rays: none) and the per-light loops'
    schedule [D, NL] hold under 2^31 floats, on at most 65535 slices; the
    wide form any slice count and size, on at most 65535 tiles of 16 rows,
    with the suns' and lights' tables under 2^31 floats. form: a form to
    force. Raises ValueError (cuda.index_form) where it cannot take them."""
    w, h, d = t.grid_whd
    wl, hl, dl = t.low_dims
    n_lights = 0 if t.lights is None else t.lights.shape[0]
    tiles = -(-h // K2_TILE[1])
    wide = (f"{h} rows: {tiles} row tiles past the launch grid's "
            f"{MAX_GRID_Z}" if tiles > MAX_GRID_Z else None) \
        or cuda.past_int32("the suns' table [Nd, 8]", t.n_dir, 8) \
        or cuda.past_int32("the lights table [NL, 16]", n_lights, 16)
    channels = {LOCAL_RADIANCE: 3 + t.n_noise,
                LOCAL_BAKED: n_lights}.get(local, 0)
    narrow = wide \
        or cuda.past_int32("the [max(4, Nd), D, H, W] planes",
                           max(4, t.n_dir), w, h, d) \
        or cuda.past_int32("the low channels it reads", channels, wl, hl, dl) \
        or (cuda.past_int32("the light schedule [D, NL]", d, n_lights)
            if local != LOCAL_RADIANCE else None) \
        or (f"{d} slices past the launch grid's {MAX_GRID_Z}"
            if d > MAX_GRID_Z else None)
    return cuda.index_form("K2", narrow, wide, form)


def shadow_scatter(t: FrameTables, prev_shadow: torch.Tensor,
                   bake: Optional[torch.Tensor] = None,
                   vis: Optional[torch.Tensor] = None,
                   form=None):
    """K2: new shadow history and the scatter planes. Local lights: the
    low-rate radiance (+ fBm) volume `bake` of K1; or, with bake None, the
    tables' per-slice light schedule, each light shadowed by the low-rate
    visibility volume `vis` of K9 or, with vis None too, by one any-hit ray
    per froxel. CUDA tensors launch the index form k2_form picks, the
    region form temporal.region_form picks (past k = 51 the reprojection
    offsets in device memory, in the wide index form) and the sun form
    scatter.sun_form picks (the suns' inverse directions in device memory
    past a block's shared memory: gen_global); `form`, one of
    cuda.INDEX_FORMS, cuda.SUN_FORMS or cuda.REGION_FORMS or a tuple of at
    most one of each, forces them."""
    if t.n_dir == 0:
        raise ValueError("K2 blends the suns' shadow: a scene without a sun "
                         "takes the staged route")
    check_scatter_inputs(t, prev_shadow, bake, vis, None)
    if prev_shadow.device.type == "cpu":
        return shadow_scatter_plain(t, prev_shadow, bake, vis)
    mode = local_mode(bake, vis)
    index, suns, region = cuda.split_form("K2", form, cuda.SUN_FORMS,
                                          cuda.REGION_FORMS)
    region = region_form("K2", t.k, region)
    index = k2_form(t, mode, global_index("K2", region, index))
    suns = sun_form("K2", t.n_dir, t.n_noise, t.k, suns, region)
    low = bake if bake is not None else vis
    cuda.check_cuda(prev_shadow, *(() if low is None else (low,)))
    w, h, d = t.grid_whd
    out_sh = torch.empty_like(prev_shadow)
    out_sc = torch.empty((4, d, h, w), dtype=torch.float32,
                         device=prev_shadow.device)
    st = t.c_struct()
    args = (cuda.ctypes.byref(st), cuda.ptr(prev_shadow),
            cuda.ptr(low) if low is not None else None, cuda.ptr(out_sh),
            cuda.ptr(out_sc), mode)
    if suns == "gen_global":  # region_global's too
        inv = torch.empty((t.n_dir, 3), dtype=torch.float32,
                          device=prev_shadow.device)
    if region == "region_global":
        plane = torch.empty((4, d, h, w), dtype=torch.float32,
                            device=prev_shadow.device)
        cuda.launch("shadow_scatter", *args, cuda.ptr(inv), cuda.ptr(plane),
                    entry="vr_shadow_scatter_region")
    elif suns == "gen_global":
        cuda.launch("shadow_scatter", *args, cuda.ptr(inv),
                    cuda.INDEX_FORMS.index(index),
                    entry="vr_shadow_scatter_global")
    else:
        cuda.launch("shadow_scatter", *args, cuda.INDEX_FORMS.index(index),
                    entry="vr_shadow_scatter_form")
    return out_sh, out_sc


# --------------------------------------------------------------------------
# K3 integrate_blend (csrc/integrate_blend.cu)
# --------------------------------------------------------------------------

def integrate_blend_plain(t: FrameTables, scatter: torch.Tensor,
                          prev_acc: torch.Tensor) -> torch.Tensor:
    """Twin of K3: the blended accumulation [4, D, H, W]: the twin of K8,
    then the alpha-mode blend (success = warped T != 0) against the history
    warped with the unjittered reprojection."""
    vals = accumulate_plain(t, scatter)
    zs = torch.arange(t.grid_whd[2], device=scatter.device)[:, None, None]
    aox, aoy, aoz, _ = reproj_offsets(t.abpar, zs, t.grid_whd, t.h_glob, t.k,
                                      with_jitter=False)
    warped = warp(prev_acc, aox, aoy, aoz, t.k)
    wgt = t.abpar[0, 20] * (warped[3] != 0.0).to(torch.float32)
    return vals + wgt * (warped - vals)


# K3's tile (csrc/integrate_blend.cu K3_TX): 16 columns of one row, the
# slices a loop of each block
K3_TX = 16


def k3_form(t: FrameTables, form: Optional[str] = None) -> str:
    """Mirror of csrc/integrate_blend.cu k3_form: the index form of
    cuda.INDEX_FORMS that K3 takes. The narrow form takes [4, D, H, W]
    planes under 2^31 floats on at most 65535 rows (a row a launch-grid y
    index); the wide form any size and row count, at most 2^31 - 1 tiles
    of K3_TX columns. form: a form to force. Raises ValueError
    (cuda.index_form), naming K3, before the launch."""
    w, h, d = t.grid_whd
    wide = cuda.past_int32("the column tiles", -(-w // K3_TX))
    narrow = wide or cuda.past_int32("the [4, D, H, W] planes", 4, w, h, d) \
        or (f"{h} rows past the launch grid's {MAX_GRID_Z}"
            if h > MAX_GRID_Z else None)
    return cuda.index_form("K3", narrow, wide, form)


# K3's static shared memory (csrc/integrate_blend.cu integrate_blend_kernel:
# xyb [4][K3_ZC + 1][K3_TX], lrgb [3][K3_ZC][K3_TX], fac, tr and tcar
# [K3_ZC][K3_TX], vzc_s and dz_s [K3_ZC], float32) and its chunk of slices
K3_ZC = 32
K3_STATIC_SHARED = 4 * (4 * (K3_ZC + 1) * K3_TX + 3 * K3_ZC * K3_TX
                        + 3 * K3_ZC * K3_TX + 2 * K3_ZC)


def k3_shared_bytes(k: int) -> int:
    """Mirror of csrc/integrate_blend.cu k3_shared: K3's dynamic shared
    bytes at reprojection window k, per slice of a chunk the x, y and two
    z offsets of the K3_TX + 2k + 1 columns its warp reads and the view
    y of its 2k + 2 rows, float32."""
    return 4 * K3_ZC * (4 * (K3_TX + 2 * k + 1) + 2 * k + 2)


def k3_window_form(k: int, form: Optional[str] = None) -> str:
    """Mirror of csrc/integrate_blend.cu k3_region_form: the form of
    cuda.REGION_FORMS that K3 takes at reprojection window k.
    "region_shared" where a chunk's offsets (k3_shared_bytes) fit a block's
    shared memory beside K3_STATIC_SHARED, up to k = 158; "region_global"
    from k = 159: a pre-pass writes the offsets of every froxel to a [4, D,
    H, W] plane in device memory and phase 3's warp reads them there.
    form: a form to force ("region_global" takes any window). Raises
    ValueError, naming K3, before any launch: for a form of another name
    and a forced region_shared whose offsets do not fit (its launcher's
    cudaFuncSetAttribute would fail)."""
    if form is not None and form not in cuda.REGION_FORMS:
        raise ValueError(f"K3: form {form!r} is none of {cuda.REGION_FORMS}")
    fits = k3_shared_bytes(k) + K3_STATIC_SHARED <= MAX_SHARED_BYTES
    if form == "region_shared" and not fits:
        raise ValueError(f"reprojection window {k}: K3's {k3_shared_bytes(k)}"
                         f" bytes of dynamic shared memory do not fit a "
                         f"block's shared memory beside its "
                         f"{K3_STATIC_SHARED} static bytes")
    return form or ("region_shared" if fits else "region_global")


def integrate_blend(t: FrameTables, scatter: torch.Tensor,
                    prev_acc: torch.Tensor, form=None) -> torch.Tensor:
    """K3: integrate the scatter planes and blend with the history. CUDA
    tensors launch the index form k3_form picks and the region form
    k3_window_form picks (past k = 158 the offsets in device memory, in the
    wide index form); `form`, one of cuda.INDEX_FORMS or cuda.REGION_FORMS
    or a pair of one of each, forces them."""
    w, h, d = t.grid_whd
    for name, v in (("scatter", scatter), ("prev_acc", prev_acc)):
        if v.shape != (4, d, h, w):
            raise ValueError(f"{name} {tuple(v.shape)} != {(4, d, h, w)}")
    if scatter.device.type == "cpu":
        return integrate_blend_plain(t, scatter, prev_acc)
    index, window = cuda.split_form("K3", form, cuda.REGION_FORMS)
    window = k3_window_form(t.k, window)
    index = k3_form(t, global_index("K3", window, index))
    cuda.check_cuda(scatter, prev_acc)
    out = torch.empty_like(prev_acc)
    st = t.c_struct()
    if window == "region_global":
        plane = torch.empty((4, d, h, w), dtype=torch.float32,
                            device=prev_acc.device)
        cuda.launch("integrate_blend", cuda.ctypes.byref(st),
                    cuda.ptr(scatter), cuda.ptr(prev_acc), cuda.ptr(out),
                    cuda.ptr(plane), entry="vr_integrate_blend_region")
        return out
    cuda.launch("integrate_blend", cuda.ctypes.byref(st), cuda.ptr(scatter),
                cuda.ptr(prev_acc), cuda.ptr(out),
                cuda.INDEX_FORMS.index(index), entry="vr_integrate_blend_form")
    return out


def volume_phase(t: FrameTables, prev_shadow: torch.Tensor,
                 prev_acc: torch.Tensor,
                 noise: Optional[torch.Tensor] = None):
    """The bake of the tables' local source (K1, K9 or none), K2, K3 on one
    frame's tables. prev_shadow [Nd, D, H, W], prev_acc [4, D, H, W] (L_r,
    L_g, L_b, T); noise: a texture medium's frame's noise channels for
    bake_radiance. Returns (blended shadow [Nd, D, H, W], blended
    accumulation [4, D, H, W])."""
    bake = vis = None
    if t.local_source == "radiance":
        bake = bake_radiance(t, noise)
    elif t.local_source == "baked":
        vis = bake_visibility(t)
    shadow, scatter = shadow_scatter(t, prev_shadow, bake, vis)
    return shadow, integrate_blend(t, scatter, prev_acc)


def frame_volume_fused(params, view_to_world, prev_world_to_view, jitter,
                       alpha, dir_lights, point_lights, spot_lights, geometry,
                       media, time_x, camera_pos, prev_shadow: torch.Tensor,
                       prev_acc: torch.Tensor,
                       grid_whd: Tuple[int, int, int], k: int,
                       vis_ss: int = 2, vis_radiance: bool = False,
                       bake_noise: bool = False,
                       inline_vis_bake: bool = False,
                       jitter_dir: bool = False,
                       heightfield_shadows: bool = False):
    """The whole volume phase with the JAX function's arguments: the host
    prep (frame_tables, scene description on the CPU), its tables moved to
    the histories' device, then volume_phase. As there, inline_vis_bake
    bakes the local lights at vis_ss -- their radiance (+ fBm with
    bake_noise) with vis_radiance, else their visibility -- and without it
    each froxel casts one shadow ray per light (the volume passed as `vis`
    in JAX is not taken: the port bakes it here). heightfield_shadows: the
    local-light rays march the terrain too (the sun's always do)."""
    radiance = bool(inline_vis_bake and vis_radiance)
    tables = frame_tables(params, view_to_world, prev_world_to_view, jitter,
                          alpha, dir_lights, point_lights, spot_lights,
                          geometry, media, time_x, camera_pos, grid_whd, k,
                          vis_ss if inline_vis_bake else 1,
                          bake_noise and radiance, jitter_dir,
                          light_schedule=not radiance,
                          heightfield_local=heightfield_shadows)
    if prev_shadow.device.type != "cpu":
        tables = tables.to(prev_shadow.device)
    return volume_phase(tables, prev_shadow, prev_acc)
