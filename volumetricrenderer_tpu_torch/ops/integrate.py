"""The jittered sample of the scatter planes and the front-to-back
integration.

Counterpart of `volumetricrenderer_tpu/ops/pallas/integrate.py`: plain-torch
twins of `make_xy_blend` (3-tap clamped tent for a constant jitter offset)
and of the expm1/Taylor slice integral, and `accumulate`, the wrapper of the
CUDA kernel K8 (`csrc/integrate.cu`) that stands for
`accumulate_fused_pallas`. `integrate_blend_fused` gives kernel K3
(ops/frame_fused.integrate_blend) the signature of the JAX package's
function of that name. The shared device code is `xy_blend4`, `slice_dz`
and `slice_terms` in `csrc/common.cuh`; K8 runs them in tiles of columns
whose slices go in chunks (`k8_geometry`), as K3 does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from volumetricrenderer_tpu_torch.ops import cuda


def make_xy_blend(ox: float, oy: float):
    """xy_blend(plane [..., H, W]): the 3-tap clamped tent at offset
    (ox, oy) in (-1, 1), x first then y."""
    wxm, wx0, wxp = max(-ox, 0.0), 1.0 - abs(ox), max(ox, 0.0)
    wym, wy0, wyp = max(-oy, 0.0), 1.0 - abs(oy), max(oy, 0.0)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)

    def shift(p, dim, s):
        n = p.shape[dim]
        idx = torch.clamp(torch.arange(n, device=p.device) + s, 0, n - 1)
        return p.index_select(dim, idx)

    def xy_blend(plane):
        w = [f32(v).to(plane.device)
             for v in (wxm, wx0, wxp, wym, wy0, wyp)]
        px = w[0] * shift(plane, -1, -1) + w[1] * plane \
            + w[2] * shift(plane, -1, 1)
        return w[3] * shift(px, -2, -1) + w[4] * px + w[5] * shift(px, -2, 1)

    return xy_blend


def slice_depths(fpz, fpw, near, z: torch.Tensor, d: int):
    """(vz_lo, vz_hi) view depths of the faces of slice(s) z; vz_lo = near at
    z = 0."""
    zf = z.to(torch.float32)
    vz_hi = (torch.exp(torch.log(fpz) * (zf + 0.5) / d) - 1.0) * fpw + near
    vz_lo = torch.where(
        zf > 0.0, (torch.exp(torch.log(fpz) * (zf - 0.5) / d) - 1.0) * fpw
        + near, near)
    return vz_lo, vz_hi


# --------------------------------------------------------------------------
# K8 integrate (csrc/integrate.cu)
# --------------------------------------------------------------------------

def _check_scatter(t, scatter: torch.Tensor) -> None:
    w, h, d = t.grid_whd
    if scatter.shape != (4, d, h, w):
        raise ValueError(f"scatter {tuple(scatter.shape)} != {(4, d, h, w)}")


def accumulate_plain(t, scatter: torch.Tensor) -> torch.Tensor:
    """Twin of K8: the accumulation [4, D, H, W] (L_r, L_g, L_b, T) of the
    scatter planes [4, D, H, W] (r, g, b, ext), no temporal blend. The sample
    of slice z is the xy tent at the jitter offset, lerped in z with slice
    z + 1 (the top slice with itself)."""
    _check_scatter(t, scatter)
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
    return vals


@dataclasses.dataclass(frozen=True)
class K8Geometry:
    """K8's block (csrc/integrate.cu K8Tile, vr_integrate_geometry): a tile
    of `columns` consecutive columns in `rows` consecutive rows whose slices
    go `slices` at a time, `threads` threads (warp 0 carries, the others
    compute the next chunk's terms) and `shared_bytes` of dynamic shared
    memory: two terms buffers [5, slices, columns x rows], the xy blend
    [4, slices + 1, columns x rows] and slice_dz [slices], float32."""
    columns: int
    rows: int
    slices: int
    threads: int
    shared_bytes: int


def k8_geometry() -> K8Geometry:
    columns, rows, slices = 16, 2, 16
    tile = columns * rows
    floats = 2 * 5 * slices * tile + 4 * (slices + 1) * tile + slices
    return K8Geometry(columns, rows, slices, 256, 4 * floats)


def k8_blocks(grid_whd: Tuple[int, int, int]) -> int:
    """K8's 1-D launch grid: one block per tile, a row of tiles after
    another, the ragged last ones masked."""
    w, h, _ = grid_whd
    geo = k8_geometry()
    return -(-w // geo.columns) * -(-h // geo.rows)


def k8_chunks(d: int) -> List[Tuple[int, int]]:
    """(first slice, slices) of each chunk a block takes in turn: full
    chunks, then the rest."""
    zc = k8_geometry().slices
    return [(z0, min(zc, d - z0)) for z0 in range(0, d, zc)]


def k8_form(t, form: Optional[str] = None) -> str:
    """Mirror of csrc/integrate.cu k8_form: the index form of
    cuda.INDEX_FORMS that K8 takes for the tables t. The narrow form takes
    [4, D, H, W] planes under 2^31 floats; the wide form any size, on a
    1-D launch grid of at most 2^31 - 1 tiles (k8_blocks). The slices are a
    loop of each block: their count limits neither. form: a form to force.
    Raises ValueError (cuda.index_form), naming K8, before any launch."""
    w, h, d = t.grid_whd
    wide = cuda.past_int32("the tiles of its 1-D launch grid",
                           k8_blocks(t.grid_whd))
    narrow = wide or cuda.past_int32("the [4, D, H, W] planes", 4, w, h, d)
    return cuda.index_form("K8", narrow, wide, form)


def accumulate(t, scatter: torch.Tensor,
               form: Optional[str] = None) -> torch.Tensor:
    """K8: integrate the scatter planes front to back, no temporal blend.
    CUDA tensors launch the index form k8_form picks (or `form`, forced)."""
    if scatter.device.type == "cpu":
        return accumulate_plain(t, scatter)
    _check_scatter(t, scatter)
    form = k8_form(t, form)
    cuda.check_cuda(scatter)
    out = torch.empty_like(scatter)
    st = t.c_struct()
    cuda.launch("integrate", cuda.ctypes.byref(st), cuda.ptr(scatter),
                cuda.ptr(out), cuda.INDEX_FORMS.index(form),
                entry="vr_integrate_form")
    return out


def integrate_blend_fused(scatter: torch.Tensor, prev_acc: torch.Tensor,
                          jitter, params, view_to_world, prev_world_to_view,
                          alpha, grid_whd: Tuple[int, int, int],
                          k: int) -> torch.Tensor:
    """`integrate_blend_fused` of the JAX package on kernel K3: scatter and
    prev_acc are [4, D, H, W] (the JAX function takes and returns tuples of
    four planes). Packs the tables K3 reads on the CPU and runs
    ops/frame_fused.integrate_blend on scatter's device."""
    from volumetricrenderer_tpu_torch.ops import frame_fused
    tables = frame_fused.frame_tables(
        params, view_to_world, prev_world_to_view, jitter, alpha, None, None,
        None, None, None, 0.0, None, grid_whd, k, 1, bake_noise=False)
    if scatter.device.type != "cpu":
        tables = tables.to(scatter.device)
    return frame_fused.integrate_blend(tables, scatter, prev_acc)
