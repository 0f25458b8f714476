"""Raycast sun shadow and its temporal blend in one pass.

Counterpart of `volumetricrenderer_tpu/ops/pallas/shadow_blend.py`:
`dir_shadow_blend` is the wrapper of the CUDA kernel K5
(`csrc/shadow_blend.cu`) that stands for `dir_shadow_blend_fused`, with its
plain-torch twin. The unblended shadow volume never exists; the blended
output is also the next frame's history.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.dir_shadow import dir_shadow_plain
from volumetricrenderer_tpu_torch.ops.scatter import (check_tile_indices,
                                                      needs_general,
                                                      sun_form,
                                                      sun_inv_bytes)
from volumetricrenderer_tpu_torch.ops.temporal import (
    global_index, region_form, region_shared_bytes, reproj_offsets, warp)


def _check_history(t, prev_shadow: torch.Tensor) -> None:
    w, h, d = t.grid_whd
    if prev_shadow.shape != (t.n_dir, d, h, w):
        raise ValueError(f"prev_shadow {tuple(prev_shadow.shape)} != "
                         f"{(t.n_dir, d, h, w)}")


def dir_shadow_blend_plain(t, prev_shadow: torch.Tensor) -> torch.Tensor:
    """Twin of K5: the blended shadow volume [Nd, D, H, W]. Weight-mode
    blend cur + alpha * success * (warped - cur), the history warped with the
    jittered reprojection and the 1e-4 uvw nudge (tables' sbpar)."""
    _check_history(t, prev_shadow)
    zs = torch.arange(t.grid_whd[2], device=prev_shadow.device)[:, None, None]
    cur = dir_shadow_plain(t)
    ox, oy, oz, succ = reproj_offsets(t.sbpar, zs, t.grid_whd, t.h_glob, t.k,
                                      with_jitter=True)
    swgt = t.sbpar[0, 20] * succ
    warped = warp(prev_shadow, ox, oy, oz, t.k)
    return cur + swgt * (warped - cur)


# K5's block (csrc/shadow_blend.cu K5Tile): 16 columns x 16 rows of one
# slice, the tile of K2 (ops/frame_fused.K2_TILE), whose shadow half K5 is
# (csrc/common.cuh tile_region, tile_blend), with its reprojection region
# (ops/temporal.region_shared_bytes) and, in the general form (more than
# scatter.MAX_DIR suns), the suns' inverse ray directions after it.
K5_TILE = (16, 16)


def k5_shared_bytes(k: int, n_dir: int = 0) -> int:
    return region_shared_bytes(K5_TILE, k) + (
        sun_inv_bytes(n_dir) if needs_general(n_dir) else 0)


def k5_form(t, form: Optional[str] = None) -> str:
    """Mirror of csrc/shadow_blend.cu k5_form: the index form of
    cuda.INDEX_FORMS that K5 takes for the tables t. The narrow form takes
    [max(4, Nd), D, H, W] histories under 2^31 floats on at most 65535
    slices; the wide form any size and slice count, on at most 65535 tiles
    of K5_TILE's rows (ops/scatter.check_tile_indices). form: a form to
    force. Raises ValueError, naming K5, before any launch."""
    return check_tile_indices(t, "K5", form, K5_TILE[1])


def dir_shadow_blend(t, prev_shadow: torch.Tensor,
                     form=None) -> torch.Tensor:
    """K5: raycast shadow + temporal blend, written to a new buffer (the
    warp reads neighbours of the history). CUDA tensors launch the index
    form k5_form picks, the region form ops/temporal.region_form picks
    (past k = 51 the reprojection offsets in device memory, in the wide
    index form) and the sun form ops/scatter.sun_form picks (the suns'
    inverse directions in device memory past a block's shared memory:
    gen_global); `form`, one of cuda.INDEX_FORMS, cuda.SUN_FORMS or
    cuda.REGION_FORMS or a tuple of at most one of each, forces them."""
    if prev_shadow.device.type == "cpu":
        return dir_shadow_blend_plain(t, prev_shadow)
    _check_history(t, prev_shadow)
    index, suns, region = cuda.split_form("K5", form, cuda.SUN_FORMS,
                                          cuda.REGION_FORMS)
    region = region_form("K5", t.k, region)
    index = k5_form(t, global_index("K5", region, index))
    suns = sun_form("K5", t.n_dir, 0, t.k, suns, region)
    cuda.check_cuda(prev_shadow)
    out = torch.empty_like(prev_shadow)
    st = t.c_struct()
    if suns == "gen_global":  # region_global's too
        inv = torch.empty((t.n_dir, 3), dtype=torch.float32,
                          device=prev_shadow.device)
    if region == "region_global":
        w, h, d = t.grid_whd
        plane = torch.empty((4, d, h, w), dtype=torch.float32,
                            device=prev_shadow.device)
        cuda.launch("shadow_blend", cuda.ctypes.byref(st),
                    cuda.ptr(prev_shadow), cuda.ptr(out), cuda.ptr(inv),
                    cuda.ptr(plane), entry="vr_shadow_blend_region")
    elif suns == "gen_global":
        cuda.launch("shadow_blend", cuda.ctypes.byref(st),
                    cuda.ptr(prev_shadow), cuda.ptr(out), cuda.ptr(inv),
                    cuda.INDEX_FORMS.index(index),
                    entry="vr_shadow_blend_global")
    else:
        cuda.launch("shadow_blend", cuda.ctypes.byref(st),
                    cuda.ptr(prev_shadow), cuda.ptr(out),
                    cuda.INDEX_FORMS.index(index),
                    entry="vr_shadow_blend_form")
    return out


def dir_shadow_blend_fused(params, view_to_world, prev_world_to_view, jitter,
                           alpha, dir_lights, geometry,
                           prev_shadow: torch.Tensor,
                           grid_whd: Tuple[int, int, int],
                           k: int) -> torch.Tensor:
    """`dir_shadow_blend_fused` of the JAX package: packs the tables this
    kernel reads on the CPU (no local lights, no media) and runs
    dir_shadow_blend on prev_shadow's device."""
    from volumetricrenderer_tpu_torch.ops.frame_fused import frame_tables
    tables = frame_tables(
        params, view_to_world, prev_world_to_view, jitter, alpha, dir_lights,
        None, None, geometry, None, 0.0, None, grid_whd, k, 1,
        bake_noise=False)
    if prev_shadow.device.type != "cpu":
        tables = tables.to(prev_shadow.device)
    return dir_shadow_blend(tables, prev_shadow)
