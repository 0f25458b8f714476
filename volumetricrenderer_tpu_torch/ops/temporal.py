"""Temporal reprojection: blend parameters, the windowed reprojection
offsets, the separable tent warp and the standalone temporal blend.

Plain-torch twins of `volumetricrenderer_tpu/ops/pallas/temporal.py`
(`pack_blend_params`, `_reproj_offsets`, `_tent_weights`, `_tent_pass`), and
`temporal_blend`, the wrapper of the CUDA kernel K10
(`csrc/temporal_blend.cu`) that stands for `fused_temporal_blend`, with its
twin.
The warp is three sequential 1-D tent passes (z, then y, then x), each
weighting its taps by the offset at ITS OWN output point (SPEC.md
"Reprojection sampling"), so output (z, y, x) is

  sum_dx wx(offx[z,y,x]) sum_dy wy(offy[z,y,cx]) sum_dz wz(offz[z,cy,cx])
      prev[cz, cy, cx]

with clamped neighbours cz, cy, cx. The CUDA counterparts (`reproj_view_l`,
`warp8_by` in `csrc/common.cuh`) evaluate exactly this as an 8-tap gather.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.scatter import MAX_GRID_Z

MODES = ("weight", "alpha")
# csrc/temporal_blend.cu dispatches warp8_by<1..4>: the weight mode's
# channels go in launches of up to MAX_CHANNELS; the alpha mode, whose
# weight reads the last channel, takes 1 to MAX_CHANNELS
MAX_CHANNELS = 4


def pack_blend_params(params, view_to_world, prev_world_to_view, jitter,
                      alpha, uvw_epsilon: float) -> torch.Tensor:
    """[1, 24]: combined view -> prev-view matrix rows (12), fp x/y/z/w/near
    (5), jitter (3), alpha, eps, y0, pad."""
    dev = view_to_world.device
    m = torch.matmul(prev_world_to_view, view_to_world)
    tail = np.concatenate([np.asarray(jitter, np.float32).reshape(3),
                           np.asarray([alpha, uvw_epsilon, params.y0, 0.0],
                                      np.float32)])
    return torch.cat([
        m[:3].reshape(12),
        torch.stack([params.x, params.y, params.z, params.w,
                     params.near]).to(dev),
        upload(tail, dev)]).to(torch.float32)[None]


def reproj_offsets(bpar, zi, grid_whd: Tuple[int, int, int], h_glob: int,
                   k: int, with_jitter: bool):
    """Froxel -> view -> prev view -> prev froxel at the UNJITTERED froxel
    centre of slice(s) zi; returns (off_x, off_y, off_z, success) with the
    offsets clipped to the +-k window after the clamps to the volume, and
    success = the global-uvw xy test taken before the clamps."""
    w, h, d = grid_whd
    p = lambda i: bpar[0, i]
    fpx, fpy, fpz, fpw, near = p(12), p(13), p(14), p(15), p(16)
    jx, jy, jz = p(17), p(18), p(19)
    eps, y0 = p(21), p(22)
    dev = bpar.device

    zf = torch.as_tensor(zi, device=dev).to(torch.float32)
    vz = (torch.exp(torch.log(fpz) * (zf + 0.5) / d) - 1.0) * fpw + near
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base_y = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    ys = torch.clamp(base_y + y0, 0.0, h_glob - 1.0)
    vx = (2.0 * (xs + 0.5) / w - 1.0) * vz / fpx
    vy = (2.0 * (ys + 0.5) / h_glob - 1.0) * vz / fpy

    pvx = p(0) * vx + p(1) * vy + p(2) * vz + p(3)
    pvy = p(4) * vx + p(5) * vy + p(6) * vz + p(7)
    pvz = p(8) * vx + p(9) * vy + p(10) * vz + p(11)

    pfz = d * torch.log(torch.clamp((pvz - near) / fpw + 1.0, min=1e-8)) \
        / torch.log(fpz)
    pfx = w * (fpx * pvx / pvz + 1.0) / 2.0
    pfy = h_glob * (fpy * pvy / pvz + 1.0) / 2.0
    if with_jitter:
        pfx = pfx + jx
        pfy = pfy + jy
        pfz = pfz + jz

    tx = pfx + eps * w - 0.5
    ty = pfy + eps * h_glob - 0.5 - y0
    tz = pfz + eps * d - 0.5

    ux = pfx / w + eps
    uy = pfy / h_glob + eps
    success = ((ux >= 0.0) & (ux <= 1.0) & (uy >= 0.0)
               & (uy <= 1.0)).to(torch.float32)

    tz = torch.clamp(tz, 0.0, d - 1.0)
    ty = torch.clamp(ty, 0.0, h - 1.0)
    tx = torch.clamp(tx, 0.0, w - 1.0)
    off_z = torch.clamp(tz - zf, -k, k)
    off_y = torch.clamp(ty - base_y, -k, k)
    off_x = torch.clamp(tx - xs, -k, k)
    return off_x, off_y, off_z, success


def tent_weights(off, k: int):
    """Per-tap tent weights max(0, 1 - |off - dd|) for dd in [-k, k]."""
    return [torch.clamp(1.0 - torch.abs(off - dd), min=0.0)
            for dd in range(-k, k + 1)]


def tent_pass(vol: torch.Tensor, ws, dim: int, k: int) -> torch.Tensor:
    """1-D windowed tent along `dim` with clamp-to-edge taps; ws from
    tent_weights (one weight tensor per tap, shaped like the output)."""
    n = vol.shape[dim]
    idx = torch.arange(n, device=vol.device)
    acc = torch.zeros_like(vol)
    for t, dd in enumerate(range(-k, k + 1)):
        src = vol.index_select(dim, torch.clamp(idx + dd, 0, n - 1))
        acc = acc + src * ws[t]
    return acc


def warp(prev: torch.Tensor, off_x, off_y, off_z, k: int) -> torch.Tensor:
    """Separable windowed warp of history channels prev [C, D, H, W] with
    offsets shaped [D, H, W]: the z pass, then y, then x."""
    acc = tent_pass(prev, tent_weights(off_z, k), 1, k)
    acc = tent_pass(acc, tent_weights(off_y, k), 2, k)
    return tent_pass(acc, tent_weights(off_x, k), 3, k)


# --------------------------------------------------------------------------
# The slice tiles' reprojection region (csrc/common.cuh region_floats)
# --------------------------------------------------------------------------

# A block's shared memory on the H100 is 227 KB; the slice tiles hold under
# 1 KB there besides their region's (K2's and K5's tile terms, common.cuh
# TileTerms; K10's two slice scalars).
MAX_SHARED_BYTES = 232448
TILE_STATIC_SHARED = 1024


def region_shared_bytes(tile: Tuple[int, int], k: int) -> int:
    """Mirror of csrc/common.cuh region_floats: the dynamic shared bytes of
    a slice tile's launch at reprojection window k. A block's reprojection
    region is the tile and k rows and columns before it, k + 1 after (the
    reach of the warp's taps): the (ox, oy, oz, success) of each of its
    cells, then reproj_vx of its columns and reproj_vy of its rows,
    float32."""
    nx, ny = tile[0] + 2 * k + 1, tile[1] + 2 * k + 1
    return 4 * (4 * nx * ny + nx + ny)


def check_region(k: int, tile_shared: int, kernel: str) -> None:
    """Refuse a reprojection window whose region (tile_shared bytes) does
    not fit a block's shared memory: K11's, which has no other form, and a
    forced region_shared form (region_form). Raises ValueError."""
    if tile_shared + TILE_STATIC_SHARED > MAX_SHARED_BYTES:
        raise ValueError(f"reprojection window {k}: {kernel}'s region does "
                         f"not fit a block's shared memory")


# The slice tile of K2, K5 and K10 (ops/frame_fused.K2_TILE,
# ops/shadow_blend.K5_TILE, K10_TILE): 16 columns x 16 rows of one slice
REGION_TILE = (16, 16)


def region_form(kernel: str, k: int, form: Optional[str] = None) -> str:
    """Mirror of csrc/common.cuh region_form_of as K2 ("K2"), K5 ("K5")
    and K10 ("K10") take it (their launchers' k2_region_form,
    k5_region_form, k10_region_form): the form of cuda.REGION_FORMS that
    the kernel takes at reprojection window k. "region_shared" where the
    region of their REGION_TILE (region_shared_bytes) fits a block's shared
    memory beside the tile's static terms, up to k = 51; "region_global"
    from k = 52: a pre-pass writes the reprojection offsets of every froxel
    to a [4, D, H, W] plane in device memory and the kernel's warp reads
    them there. form: a form to force ("region_global" takes any window).
    Raises ValueError, naming the kernel, before any launch: for a form of
    another name and a forced region_shared whose region does not fit."""
    if form is not None and form not in cuda.REGION_FORMS:
        raise ValueError(f"{kernel}: form {form!r} is none of "
                         f"{cuda.REGION_FORMS}")
    nbytes = region_shared_bytes(REGION_TILE, k)
    if form == "region_shared":
        check_region(k, nbytes, kernel)
    if form is not None:
        return form
    return "region_shared" if nbytes + TILE_STATIC_SHARED \
        <= MAX_SHARED_BYTES else "region_global"


def global_index(kernel: str, region: str, index: Optional[str]):
    """The index form to ask a launch in region form `region` for: the
    region_global forms are instantiated in the wide index form alone
    (64-bit indices, the slices or rows in parts), so they take "wide" and
    refuse a forced "narrow" by name, before any launch (ValueError);
    region_shared keeps `index`."""
    if region != "region_global":
        return index
    if index == "narrow":
        raise ValueError(f"{kernel}'s region_global form has no narrow "
                         "index form: it indexes in 64 bits")
    return "wide"


def check_shared(nbytes: int, kernel: str, what: str) -> None:
    """Refuse a launch whose dynamic shared memory (nbytes, for `what`)
    does not fit a block's beside the tile's static shared memory. Raises
    ValueError."""
    if nbytes + TILE_STATIC_SHARED > MAX_SHARED_BYTES:
        raise ValueError(f"{what}: {kernel}'s {nbytes} bytes of dynamic "
                         f"shared memory do not fit a block's shared memory")


def volume_form(kernel: str, shape: Tuple[int, ...], rows: int,
                form: Optional[str] = None) -> str:
    """The index form of cuda.INDEX_FORMS that one launch of K10 or K11
    (tiles of `rows` rows) takes for its volume [C, D, H, W] (one channel
    group), as their launchers' k10_form and k11_form: the narrow form
    (32-bit indices, a slice a launch-grid z index) takes volumes under
    2^31 floats on at most 65535 slices; the wide form (64-bit indices, the
    slices in parts of at most 65535) any size and slice count. Both take at
    most 65535 row tiles. form: a form to force. Raises ValueError, naming
    `kernel`, before any launch where the form cannot take the volume."""
    c, d, h, w = shape
    tiles = -(-h // rows)
    wide = (f"{h} rows: {tiles} row tiles past the launch grid's "
            f"{MAX_GRID_Z}" if tiles > MAX_GRID_Z else None)
    narrow = wide or cuda.past_int32(
        f"the volume {tuple(shape)}", c, d, h, w) \
        or (f"{d} slices past the launch grid's {MAX_GRID_Z}"
            if d > MAX_GRID_Z else None)
    return cuda.index_form(kernel, narrow, wide, form)


# --------------------------------------------------------------------------
# K10 temporal_blend (csrc/temporal_blend.cu)
# --------------------------------------------------------------------------

# K10's block (csrc/temporal_blend.cu K10Tile): a 16 x 16 tile of one slice,
# K5's (ops/shadow_blend.K5_TILE) without the sun rays, with K5's
# reprojection region. Its launch grid is ops/scatter.tile_grid's.
K10_TILE = (16, 16)


def k10_shared_bytes(k: int) -> int:
    return region_shared_bytes(K10_TILE, k)


def k10_form(shape: Tuple[int, ...], form: Optional[str] = None) -> str:
    """Mirror of csrc/temporal_blend.cu k10_form: the index form of one K10
    launch on a channel group's [C, D, H, W] volumes (volume_form). form: a
    form to force. Raises ValueError, naming K10, before any launch."""
    return volume_form("K10", shape, K10_TILE[1], form)


def channel_groups(n_ch: int, mode: str):
    """K10's launches over n_ch channels: (first channel, channels) of each.
    The weight mode blends each channel alone, so launches of up to
    MAX_CHANNELS give one launch's values; the alpha mode's weight reads
    the last channel, so it takes one launch of 1 to MAX_CHANNELS. Raises
    ValueError for a count the mode does not take."""
    if mode == "weight" and n_ch > 0:
        return [(c0, min(MAX_CHANNELS, n_ch - c0))
                for c0 in range(0, n_ch, MAX_CHANNELS)]
    if not 0 < n_ch <= MAX_CHANNELS:
        raise ValueError(f"{n_ch} channels in mode {mode!r}: the kernel "
                         f"takes 1 to {MAX_CHANNELS}")
    return [(0, n_ch)]


def _check_blend(bpar, prev, cur, grid_whd, mode) -> None:
    w, h, d = grid_whd
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    if bpar.shape != (1, 24) and bpar.shape != (1, 28):
        raise ValueError(f"blend params {tuple(bpar.shape)}")
    if prev.shape != cur.shape or prev.dim() != 4 \
            or prev.shape[1:] != (d, h, w):
        raise ValueError(f"prev {tuple(prev.shape)}, cur {tuple(cur.shape)}:"
                         f" expected two [C, {d}, {h}, {w}]")


def temporal_blend_plain(bpar, prev: torch.Tensor, cur: torch.Tensor,
                         grid_whd: Tuple[int, int, int], h_glob: int, k: int,
                         mode: str) -> torch.Tensor:
    """Twin of K10: cur + wgt * (warped prev - cur) over channels
    [C, D, H, W], the history warped at the analytic reprojection offsets of
    the pack_blend_params table bpar. Mode "weight" (the shadow blend; the
    offsets take the jitter): wgt = alpha * success_xy. Mode "alpha" (the
    accumulation blend; no jitter): wgt = alpha * (warped last channel
    != 0)."""
    _check_blend(bpar, prev, cur, grid_whd, mode)
    zs = torch.arange(grid_whd[2], device=prev.device)[:, None, None]
    ox, oy, oz, success = reproj_offsets(bpar, zs, grid_whd, h_glob, k,
                                         with_jitter=mode == "weight")
    warped = warp(prev, ox, oy, oz, k)
    if mode == "weight":
        wgt = bpar[0, 20] * success
    else:
        wgt = bpar[0, 20] * (warped[-1] != 0.0).to(torch.float32)
    return cur + wgt * (warped - cur)


def temporal_blend(bpar, prev: torch.Tensor, cur: torch.Tensor,
                   grid_whd: Tuple[int, int, int], h_glob: int, k: int,
                   mode: str, form=None) -> torch.Tensor:
    """K10: reproject, warp and blend in one pass, written to a new buffer.
    bpar: a pack_blend_params table on the volumes' device (the frame
    tables' sbpar for the shadow blend, abpar for the accumulation
    blend). The weight mode takes any channel count, one launch per group
    of up to MAX_CHANNELS (channel_groups). CUDA tensors launch each group
    in the index form k10_form picks for it and the region form
    region_form picks (past k = 51 the offsets in device memory, one plane
    for all groups, in the wide index form); `form`, one of
    cuda.INDEX_FORMS or cuda.REGION_FORMS or a pair of one of each, forces
    them."""
    if prev.device.type == "cpu":
        return temporal_blend_plain(bpar, prev, cur, grid_whd, h_glob, k,
                                    mode)
    _check_blend(bpar, prev, cur, grid_whd, mode)
    index, region = cuda.split_form("K10", form, cuda.REGION_FORMS)
    region = region_form("K10", k, region)
    index = global_index("K10", region, index)
    groups = channel_groups(prev.shape[0], mode)
    # each launch indexes its own group's channels (region_global: each
    # group's wide form, checked here)
    forms = [k10_form((nc, *prev.shape[1:]), index) for _, nc in groups]
    cuda.check_cuda(bpar, prev, cur)
    w, h, d = grid_whd
    out = torch.empty_like(cur)
    if region == "region_global":
        plane = torch.empty((4, d, h, w), dtype=torch.float32,
                            device=prev.device)
        for g, (c0, nc) in enumerate(groups):
            cuda.launch("temporal_blend", cuda.ptr(bpar),
                        cuda.ptr(prev[c0:c0 + nc]),
                        cuda.ptr(cur[c0:c0 + nc]), cuda.ptr(out[c0:c0 + nc]),
                        cuda.ptr(plane), int(g == 0), nc, w, h, d,
                        int(h_glob), int(k), MODES.index(mode),
                        entry="vr_temporal_blend_region")
        return out
    for (c0, nc), f in zip(groups, forms):
        cuda.launch("temporal_blend", cuda.ptr(bpar),
                    cuda.ptr(prev[c0:c0 + nc]), cuda.ptr(cur[c0:c0 + nc]),
                    cuda.ptr(out[c0:c0 + nc]), nc, w, h, d, int(h_glob),
                    int(k), MODES.index(mode), cuda.INDEX_FORMS.index(f),
                    entry="vr_temporal_blend_form")
    return out


def fused_temporal_blend(params, view_to_world, prev_world_to_view, jitter,
                         alpha, prev: torch.Tensor, cur: torch.Tensor,
                         grid_whd: Tuple[int, int, int], k: int, mode: str,
                         uvw_epsilon: float = 0.0) -> torch.Tensor:
    """`fused_temporal_blend` of the JAX package on kernel K10: prev and cur
    are [C, D, H, W] (the JAX function takes and returns tuples of planes,
    and can emit them in a padded TPU layout that the port has no use for).
    Packs the blend table on the CPU, where the matrices must lie, and runs
    temporal_blend on the volumes' device."""
    jit = jitter if mode == "weight" else np.zeros(3, np.float32)
    bpar = pack_blend_params(params, view_to_world, prev_world_to_view, jit,
                             alpha, uvw_epsilon).contiguous()
    if prev.device.type != "cpu":
        bpar = upload(bpar, prev.device)
    return temporal_blend(bpar, prev, cur, grid_whd, params.grid[1], k, mode)
