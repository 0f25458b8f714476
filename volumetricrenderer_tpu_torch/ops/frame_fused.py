"""The production volume phase: shadow -> shadow blend -> scatter ->
integrate -> accumulation blend, with the low-rate radiance + fBm bake.

Port of `volumetricrenderer_tpu/ops/pallas/frame_fused.py`
`frame_volume_fused` (inline radiance path). The TPU ran it as one staggered
`pallas_call` whose sequential grid carried the histories and the (L, T)
integral in VMEM rings; on the GPU it is a chain of three kernels, held as
one unit against the JAX function:

  K1 bake_radiance    low volume [3 + n_noise, DL, HL, WL]
  K2 shadow_scatter   new shadow history [Nd, D, H, W] + scatter [4, D, H, W]
  K3 integrate_blend  new accumulation [4, D, H, W]

Each wrapper launches its CUDA kernel (csrc/) for CUDA tensors and runs its
plain-torch twin (`*_plain`, same module) for CPU tensors; a CUDA tensor
never falls back to the twin. Histories are written to new buffers.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops import dir_shadow as dir_shadow_lib
from volumetricrenderer_tpu_torch.ops.integrate import (make_xy_blend,
                                                        slice_depths)
from volumetricrenderer_tpu_torch.ops.material import (noise_factor_planes,
                                                       pack_media,
                                                       phase_g_plane)
from volumetricrenderer_tpu_torch.ops.occlude import pack_boxes
from volumetricrenderer_tpu_torch.ops.phase import PI
from volumetricrenderer_tpu_torch.ops.scatter import (pack_dir_lights,
                                                      pack_lights,
                                                      pack_params,
                                                      scatter_slice)
from volumetricrenderer_tpu_torch.ops.temporal import (pack_blend_params,
                                                       reproj_offsets, warp)
from volumetricrenderer_tpu_torch.ops.visibility import (bake_radiance_plane,
                                                         bake_world_planes,
                                                         low_res_dims,
                                                         low_slice_active,
                                                         radiance_view_dirs,
                                                         tent_taps,
                                                         upsample_low)

MAX_DIR = 4     # csrc/common.cuh VR_MAX_DIR
MAX_NOISE = 4   # csrc/common.cuh VR_MAX_NOISE


@dataclasses.dataclass(frozen=True)
class FrameTables:
    """Host prep of one frame: the packed tables the kernels read (float32
    or int32 tensors on the frame's device) and the static counts."""
    spar: torch.Tensor        # [1, 24] pack_params (jittered)
    sbpar: torch.Tensor       # [1, 24] shadow blend (jitter, eps 1e-4)
    abpar: torch.Tensor       # [1, 28] acc blend (no jitter, eps 0) + jitter
    slights: torch.Tensor     # [Nd, 8] dir_shadow.pack_dir_lights
    dirs: torch.Tensor        # [Nd, 8] scatter.pack_dir_lights
    lights: torch.Tensor      # [NL, 16]
    planes: torch.Tensor      # [max(P,1), 4]
    spheres: torch.Tensor     # [max(S,1), 4]
    boxes: torch.Tensor       # [max(B,1), 8]
    med: torch.Tensor         # [M, 20]
    med_static: torch.Tensor  # [M, 6] int32
    active: torch.Tensor      # [NL, DL] int32 (low_slice_active)
    tent_x: Tuple[torch.Tensor, torch.Tensor]   # (k0 [W], w [2, W])
    tent_y: Tuple[torch.Tensor, torch.Tensor]   # (k0 [H], w [2, H])
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

    @property
    def low_dims(self):
        return low_res_dims(self.grid_whd, self.ss)

    def to(self, device) -> "FrameTables":
        """The same tables on `device`: packed into one float32 and one
        int32 buffer, copied once (pinned and asynchronous from the CPU to
        CUDA), and split back into views."""
        device = torch.device(device)
        names, tensors = [], []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                names.append((f.name, None))
                tensors.append(v)
            elif isinstance(v, tuple) and v and isinstance(v[0],
                                                           torch.Tensor):
                for i, t in enumerate(v):
                    names.append((f.name, i))
                    tensors.append(t)
        if any(t.dtype not in (torch.float32, torch.int32) for t in tensors):
            raise TypeError("FrameTables holds float32 and int32 tensors")
        moved = {}
        for dtype in (torch.float32, torch.int32):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            if flat.device.type == "cpu" and device.type == "cuda":
                flat = flat.pin_memory().to(device, non_blocking=True)
            else:
                flat = flat.to(device)
            for i, part in zip(idx, flat.split(
                    [tensors[i].numel() for i in idx])):
                moved[i] = part.view(tensors[i].shape)
        fields = {}
        for i, (name, sub) in enumerate(names):
            if sub is None:
                fields[name] = moved[i]
            else:
                fields.setdefault(name, []).append(moved[i])
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()}
        return dataclasses.replace(self, **fields)

    def c_struct(self) -> cuda.VrTables:
        """The ctypes mirror of csrc/common.cuh VrTables."""
        w, h, d = self.grid_whd
        wl, hl, dl = self.low_dims
        p = cuda.ptr
        return cuda.VrTables(
            p(self.spar), p(self.sbpar), p(self.abpar), p(self.slights),
            p(self.dirs), p(self.lights), p(self.planes), p(self.spheres),
            p(self.boxes), p(self.med), p(self.med_static), p(self.active),
            p(self.tent_x[0]), p(self.tent_x[1]), p(self.tent_y[0]),
            p(self.tent_y[1]), self.n_dir, self.lights.shape[0],
            self.n_planes, self.n_spheres, self.n_boxes, self.med.shape[0],
            self.n_noise, int(self.jitter_dir), w, h, d, self.h_glob, self.k,
            self.ss, wl, hl, dl)


@functools.lru_cache(maxsize=16)
def _tent_np(n: int, nl: int, ss: int):
    return tent_taps(n, nl, ss)


def frame_tables(params, view_to_world, prev_world_to_view, jitter, alpha,
                 dir_lights, point_lights, spot_lights, geometry, media,
                 time_x, camera_pos, grid_whd: Tuple[int, int, int], k: int,
                 vis_ss: int, bake_noise: bool,
                 jitter_dir: bool = False) -> FrameTables:
    """Pack every table of one frame: plain torch on the CPU, where the
    scene description must lie (FrameTables.to moves the result)."""
    w, h, d = grid_whd
    if view_to_world.device.type != "cpu":
        raise ValueError("frame tables are packed on the host: pass the "
                         "scene description on the CPU")
    nd = dir_lights.count
    if not 0 < nd <= MAX_DIR:
        raise NotImplementedError(f"{nd} directional lights: the port takes "
                                  f"1 to {MAX_DIR}")
    jit = np.asarray(jitter, np.float32).reshape(3)
    spar = pack_params(params, view_to_world, camera_pos, jit)
    sbpar = pack_blend_params(params, view_to_world, prev_world_to_view, jit,
                              alpha, 1e-4)
    abpar = pack_blend_params(params, view_to_world, prev_world_to_view,
                              np.zeros(3, np.float32), alpha, 0.0)
    abpar = torch.cat([abpar, torch.tensor([[jit[0], jit[1], jit[2], 0.0]],
                                           dtype=torch.float32)], dim=1)
    lights = pack_lights(point_lights, spot_lights)
    positions = torch.cat([point_lights.position, spot_lights.position])
    ranges = torch.cat([point_lights.range, spot_lights.range])

    planes = torch.cat([geometry.plane_normal, geometry.plane_d[:, None]],
                       dim=-1)
    spheres = torch.cat([geometry.sphere_center,
                         geometry.sphere_radius[:, None]], dim=-1)
    boxes = pack_boxes(geometry)
    n_planes, n_spheres, n_boxes = (planes.shape[0], spheres.shape[0],
                                    boxes.shape[0])
    z = lambda c: torch.zeros((1, c), dtype=torch.float32)
    planes = planes if n_planes else z(4)
    spheres = spheres if n_spheres else z(4)
    boxes = boxes if n_boxes else z(8)
    med, media_static = pack_media(media, time_x)
    n_noise = sum(1 for st in media_static if st[0]) if bake_noise else 0
    if n_noise > MAX_NOISE:
        raise NotImplementedError(f"{n_noise} noise media: the port takes at "
                                  f"most {MAX_NOISE}")

    wl, hl, dl = low_res_dims(grid_whd, vis_ss)
    active = low_slice_active(params, view_to_world, positions, ranges,
                              grid_whd, vis_ss).to(torch.int32)

    def tent(n, nl):
        k0, wt = _tent_np(n, nl, vis_ss)
        return (torch.as_tensor(k0, dtype=torch.int32),
                torch.as_tensor(wt, dtype=torch.float32))

    return FrameTables(
        spar=spar.contiguous(), sbpar=sbpar.contiguous(),
        abpar=abpar.contiguous(),
        slights=dir_shadow_lib.pack_dir_lights(dir_lights).contiguous(),
        dirs=pack_dir_lights(dir_lights).contiguous(),
        lights=lights.contiguous(), planes=planes.contiguous(),
        spheres=spheres.contiguous(), boxes=boxes.contiguous(),
        med=med.contiguous(),
        med_static=torch.tensor([[int(v) for v in st]
                                 for st in media_static], dtype=torch.int32),
        active=active.contiguous(), tent_x=tent(w, wl), tent_y=tent(h, hl),
        jitter=jit, media_static=media_static, grid_whd=grid_whd,
        h_glob=params.grid[1], k=k, ss=vis_ss, n_dir=nd, n_planes=n_planes,
        n_spheres=n_spheres, n_boxes=n_boxes, n_noise=n_noise,
        jitter_dir=jitter_dir)


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
                                  t.boxes, n_planes=t.n_planes,
                                  n_spheres=t.n_spheres, n_boxes=t.n_boxes)
        act = t.active[li].bool()[:, None, None]
        acc = [torch.where(act, a + c, a) for a, c in zip(acc, rgb)]
    noise = noise_factor_planes(t.med, t.media_static, wx, wy, wz) \
        if t.n_noise else []
    return torch.stack(acc + noise)


def bake_radiance(t: FrameTables) -> torch.Tensor:
    """K1: the low-rate radiance (+ fBm) volume."""
    if t.spar.device.type == "cpu":
        return bake_radiance_plain(t)
    wl, hl, dl = t.low_dims
    out = torch.empty((3 + t.n_noise, dl, hl, wl), dtype=torch.float32,
                      device=t.spar.device)
    st = t.c_struct()
    cuda.launch("bake_radiance", cuda.ctypes.byref(st), cuda.ptr(out))
    return out


# --------------------------------------------------------------------------
# K2 shadow_scatter (csrc/shadow_scatter.cu)
# --------------------------------------------------------------------------

def shadow_scatter_plain(t: FrameTables, prev_shadow: torch.Tensor,
                         bake: torch.Tensor):
    """Twin of K2: (blended shadow [Nd, D, H, W], scatter [4, D, H, W])."""
    w, h, d = t.grid_whd
    zs = torch.arange(d, device=prev_shadow.device)[:, None, None]
    cur = dir_shadow_lib.dir_shadow_slice(
        t.spar, t.slights, t.planes, t.spheres, t.boxes, zs,
        grid_whd=t.grid_whd, n_lights=t.n_dir, n_planes=t.n_planes,
        n_spheres=t.n_spheres, n_boxes=t.n_boxes, max_dist=1e4,
        h_glob=t.h_glob)
    ox, oy, oz, succ = reproj_offsets(t.sbpar, zs, t.grid_whd, t.h_glob, t.k,
                                      with_jitter=True)
    swgt = t.sbpar[0, 20] * succ
    warped = warp(prev_shadow, ox, oy, oz, t.k)
    blended = [cur[li] + swgt * (warped[li] - cur[li])
               for li in range(t.n_dir)]
    noise = list(upsample_low(bake[3:3 + t.n_noise], zs, t.ss, t.tent_x,
                              t.tent_y)) if t.n_noise else None
    radiance = upsample_low(bake[:3], zs, t.ss, t.tent_x, t.tent_y)
    ar, ag, ab, ext = scatter_slice(
        t.spar, t.dirs, t.med, t.media_static, zs, blended, radiance, noise,
        grid_whd=t.grid_whd, n_dir=t.n_dir, h_glob=t.h_glob,
        jitter_dir=t.jitter_dir)
    return torch.stack(blended), torch.stack([ar, ag, ab, ext])


def shadow_scatter(t: FrameTables, prev_shadow: torch.Tensor,
                   bake: torch.Tensor):
    """K2: new shadow history and the scatter planes."""
    w, h, d = t.grid_whd
    if prev_shadow.shape != (t.n_dir, d, h, w):
        raise ValueError(f"prev_shadow {tuple(prev_shadow.shape)} != "
                         f"{(t.n_dir, d, h, w)}")
    wl, hl, dl = t.low_dims
    if bake.shape != (3 + t.n_noise, dl, hl, wl):
        raise ValueError(f"bake volume {tuple(bake.shape)}")
    if prev_shadow.device.type == "cpu":
        return shadow_scatter_plain(t, prev_shadow, bake)
    cuda.check_cuda(prev_shadow, bake)
    out_sh = torch.empty_like(prev_shadow)
    out_sc = torch.empty((4, d, h, w), dtype=torch.float32,
                         device=prev_shadow.device)
    st = t.c_struct()
    cuda.launch("shadow_scatter", cuda.ctypes.byref(st),
                cuda.ptr(prev_shadow), cuda.ptr(bake), cuda.ptr(out_sh),
                cuda.ptr(out_sc))
    return out_sh, out_sc


# --------------------------------------------------------------------------
# K3 integrate_blend (csrc/integrate_blend.cu)
# --------------------------------------------------------------------------

def integrate_blend_plain(t: FrameTables, scatter: torch.Tensor,
                          prev_acc: torch.Tensor) -> torch.Tensor:
    """Twin of K3: the blended accumulation [4, D, H, W]."""
    w, h, d = t.grid_whd
    dev = scatter.device
    ox, oy, oz = (float(v) for v in t.jitter)
    xyb = make_xy_blend(ox, oy)(scatter)                    # [4, D, H, W]
    xyb_up = torch.cat([xyb[:, 1:], xyb[:, -1:]], dim=1)
    sampled = xyb + torch.tensor(oz, dtype=torch.float32) * (xyb_up - xyb)
    ap = lambda i: t.abpar[0, i]
    vz_lo, vz_hi = slice_depths(ap(14), ap(15), ap(16),
                                torch.arange(d, device=dev), d)
    dz = (vz_hi - vz_lo)[:, None, None]
    od = sampled[3] * dz
    tr = torch.exp(-od)
    small = od < 1e-2
    safe_sigma = torch.where(small, torch.ones_like(od), sampled[3])
    factor = torch.where(small, dz * (1.0 - 0.5 * od * (1.0 - od / 3.0)),
                         (1.0 - tr) / safe_sigma)
    vals = torch.empty_like(scatter)
    carry = [torch.zeros((h, w), dtype=torch.float32, device=dev)
             for _ in range(3)] + [torch.ones((h, w), dtype=torch.float32,
                                              device=dev)]
    for z in range(d):
        tc = carry[3]
        carry = [carry[c] + tc * sampled[c, z] * factor[z] for c in range(3)] \
            + [tc * tr[z]]
        for c in range(4):
            vals[c, z] = carry[c]
    zs = torch.arange(d, device=dev)[:, None, None]
    aox, aoy, aoz, _ = reproj_offsets(t.abpar, zs, t.grid_whd, t.h_glob, t.k,
                                      with_jitter=False)
    warped = warp(prev_acc, aox, aoy, aoz, t.k)
    wgt = ap(20) * (warped[3] != 0.0).to(torch.float32)
    return vals + wgt * (warped - vals)


def integrate_blend(t: FrameTables, scatter: torch.Tensor,
                    prev_acc: torch.Tensor) -> torch.Tensor:
    """K3: integrate the scatter planes and blend with the history."""
    w, h, d = t.grid_whd
    for name, v in (("scatter", scatter), ("prev_acc", prev_acc)):
        if v.shape != (4, d, h, w):
            raise ValueError(f"{name} {tuple(v.shape)} != {(4, d, h, w)}")
    if scatter.device.type == "cpu":
        return integrate_blend_plain(t, scatter, prev_acc)
    cuda.check_cuda(scatter, prev_acc)
    out = torch.empty_like(prev_acc)
    st = t.c_struct()
    cuda.launch("integrate_blend", cuda.ctypes.byref(st), cuda.ptr(scatter),
                cuda.ptr(prev_acc), cuda.ptr(out))
    return out


def volume_phase(t: FrameTables, prev_shadow: torch.Tensor,
                 prev_acc: torch.Tensor):
    """K1 -> K2 -> K3 on one frame's tables. prev_shadow [Nd, D, H, W],
    prev_acc [4, D, H, W] (L_r, L_g, L_b, T). Returns (blended shadow
    [Nd, D, H, W], blended accumulation [4, D, H, W])."""
    bake = bake_radiance(t)
    shadow, scatter = shadow_scatter(t, prev_shadow, bake)
    return shadow, integrate_blend(t, scatter, prev_acc)


def frame_volume_fused(params, view_to_world, prev_world_to_view, jitter,
                       alpha, dir_lights, point_lights, spot_lights, geometry,
                       media, time_x, camera_pos, prev_shadow: torch.Tensor,
                       prev_acc: torch.Tensor,
                       grid_whd: Tuple[int, int, int], k: int, vis_ss: int,
                       bake_noise: bool, jitter_dir: bool = False):
    """The whole volume phase with the JAX function's arguments: the host
    prep (frame_tables, scene description on the CPU), its tables moved to
    the histories' device, then volume_phase."""
    tables = frame_tables(params, view_to_world, prev_world_to_view, jitter,
                          alpha, dir_lights, point_lights, spot_lights,
                          geometry, media, time_x, camera_pos, grid_whd, k,
                          vis_ss, bake_noise, jitter_dir)
    if prev_shadow.device.type != "cpu":
        tables = tables.to(prev_shadow.device)
    return volume_phase(tables, prev_shadow, prev_acc)
