"""Raycast sun shadow at the jittered froxel centre.

Counterpart of `volumetricrenderer_tpu/ops/pallas/dir_shadow.py`: the
plain-torch twin of `dir_shadow_slice`, and `dir_shadow`, the wrapper of the
CUDA kernel K7 (`csrc/dir_shadow.cu`) that stands for `dir_shadow_pallas`.
The per-froxel device code is `sun_shadow` in `csrc/common.cuh`, shared with
the shadow_blend and shadow_scatter kernels; K7 runs it in 16 x 16 tiles of
one slice (`K7_TILE`), K5's tile without the reprojection region.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.occlude import any_hit


def pack_dir_lights(dir_lights) -> torch.Tensor:
    """[Nd, 8]: direction(3), 1 - shadow_strength, shadow gate, pad(3)."""
    n = dir_lights.count
    z = torch.zeros((n, 3), dtype=torch.float32,
                    device=dir_lights.direction.device)
    return torch.cat([dir_lights.direction,
                      (1.0 - dir_lights.shadow_strength)[:, None],
                      dir_lights.has_shadow.to(torch.float32)[:, None], z],
                     dim=-1)


def froxel_world(par, zi, grid_whd: Tuple[int, int, int], h_glob: int,
                 jittered: bool = True):
    """World position planes of slice(s) zi at the (jittered) froxel centre
    from a pack_params table. zi: an int, or an int tensor shaped to
    broadcast against [H, W] (e.g. [D, 1, 1] for the whole volume)."""
    w, h, d = grid_whd
    p = lambda i: par[0, i]
    fpx, fpy, fpz, fpw, near = p(12), p(13), p(14), p(15), p(16)
    jx, jy, jz = (p(17), p(18), p(19)) if jittered else (0.0, 0.0, 0.0)
    dev = par.device
    zf = torch.as_tensor(zi, device=dev).to(torch.float32)
    fz = zf + 0.5 + jz
    vz = (torch.exp(torch.log(fpz) * fz / d) - 1.0) * fpw + near
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    ys = torch.clamp(ys + p(23), 0.0, h_glob - 1.0)
    vx = (2.0 * (xs + 0.5 + jx) / w - 1.0) * vz / fpx
    vy = (2.0 * (ys + 0.5 + jy) / h_glob - 1.0) * vz / fpy
    wx = p(0) * vx + p(1) * vy + p(2) * vz + p(3)
    wy = p(4) * vx + p(5) * vy + p(6) * vz + p(7)
    wz = p(8) * vx + p(9) * vy + p(10) * vz + p(11)
    return wx, wy, wz


def dir_shadow_slice(par, lights, planes, spheres, boxes, zi, *,
                     grid_whd: Tuple[int, int, int], n_lights: int,
                     n_planes: int, n_spheres: int, n_boxes: int,
                     max_dist: float, h_glob: int, hf=None, hf_static=None,
                     fractional: bool = False):
    """Gated visibility^2 planes, one per dir light, at slice(s) zi; the
    terrain (hf, hf_static) and the fractional any-hit as in
    ops/occlude.any_hit."""
    wx, wy, wz = froxel_world(par, zi, grid_whd, h_glob)
    out = []
    for li in range(n_lights):
        q = lambda i: lights[li, i]
        strength_r, gate = q(3), q(4)
        occ = any_hit(planes, spheres, boxes, wx, wy, wz, -q(0), -q(1),
                      -q(2), max_dist, n_planes=n_planes,
                      n_spheres=n_spheres, n_boxes=n_boxes, hf=hf,
                      hf_static=hf_static, fractional=fractional)
        vis = strength_r + (1.0 - strength_r) * (1.0 - occ.to(torch.float32))
        vis = vis * vis
        out.append(1.0 + gate * (vis - 1.0))
    return out


# --------------------------------------------------------------------------
# K7 dir_shadow (csrc/dir_shadow.cu)
# --------------------------------------------------------------------------

def dir_shadow_plain(t) -> torch.Tensor:
    """Twin of K7: the unblended shadow volume [Nd, D, H, W] of one frame's
    tables (ops/frame_fused.FrameTables)."""
    zs = torch.arange(t.grid_whd[2], device=t.spar.device)[:, None, None]
    return torch.stack(dir_shadow_slice(
        t.spar, t.slights, t.planes, t.spheres, t.boxes, zs,
        grid_whd=t.grid_whd, n_lights=t.n_dir, max_dist=1e4,
        h_glob=t.h_glob, **t.occluders(local=False)))


# K7's block (csrc/dir_shadow.cu K7Tile): 16 columns x 16 rows of one slice,
# K5's tile (ops/shadow_blend.K5_TILE) without its reprojection region. Its
# launch grid is ops/scatter.tile_grid's.
K7_TILE = (16, 16)


def k7_shared_bytes(n_dir: int) -> int:
    """The dynamic shared bytes of a K7 launch with n_dir suns: none in the
    fixed form, the suns' inverse ray directions in the general one (more
    than scatter.MAX_DIR suns)."""
    from volumetricrenderer_tpu_torch.ops.scatter import (needs_general,
                                                          sun_inv_bytes)
    return sun_inv_bytes(n_dir) if needs_general(n_dir) else 0


def k7_form(t, form: Optional[str] = None) -> str:
    """Mirror of csrc/dir_shadow.cu k7_form: the index form of
    cuda.INDEX_FORMS that K7 takes for the tables t. The narrow form takes
    a [max(4, Nd), D, H, W] volume under 2^31 floats on at most 65535
    slices; the wide form any size and slice count, on at most 65535 tiles
    of K7_TILE's rows (ops/scatter.check_tile_indices). form: a form to
    force. Raises ValueError, naming K7, before any launch."""
    from volumetricrenderer_tpu_torch.ops.scatter import check_tile_indices
    return check_tile_indices(t, "K7", form, K7_TILE[1])


def dir_shadow(t, form=None) -> torch.Tensor:
    """K7: the unblended raycast shadow volume [Nd, D, H, W]. CUDA tables
    launch the index form k7_form picks and the sun form
    ops/scatter.sun_form picks (the suns' inverse directions in device
    memory past a block's shared memory: gen_global); `form`, one of
    cuda.INDEX_FORMS or cuda.SUN_FORMS or a pair of one of each, forces
    them. Refuses, before any launch, tables neither index form takes."""
    if t.spar.device.type == "cpu":
        return dir_shadow_plain(t)
    from volumetricrenderer_tpu_torch.ops.scatter import sun_form
    index, suns = cuda.split_form("K7", form, cuda.SUN_FORMS)
    index = k7_form(t, index)
    suns = sun_form("K7", t.n_dir, 0, t.k, suns)
    cuda.check_cuda(t.spar)
    w, h, d = t.grid_whd
    out = torch.empty((t.n_dir, d, h, w), dtype=torch.float32,
                      device=t.spar.device)
    st = t.c_struct()
    if suns == "gen_global":
        inv = torch.empty((t.n_dir, 3), dtype=torch.float32,
                          device=t.spar.device)
        cuda.launch("dir_shadow", cuda.ctypes.byref(st), cuda.ptr(out),
                    cuda.ptr(inv), cuda.INDEX_FORMS.index(index),
                    entry="vr_dir_shadow_global")
    else:
        cuda.launch("dir_shadow", cuda.ctypes.byref(st), cuda.ptr(out),
                    cuda.INDEX_FORMS.index(index), entry="vr_dir_shadow_form")
    return out
