"""The quarter-res SSR march: kernel K13 and its plain-torch twin.

Counterpart of `volumetricrenderer_tpu/ops/pallas/ssr.py`
(`ssr_march_pallas`, whose `_kernel` runs every direction bin's taps over
edge-padded VMEM copies of the planes) and of the XLA loop in
`volumetricrenderer_tpu/post.py` `_ssr_p` that it is held to.
`ssr_march` launches K13 (`csrc/ssr_march.cu`) on CUDA tensors and runs
`ssr_march_reference`, the XLA loop term for term (every bin over the whole
plane, masked by its `sel`), on CPU tensors. K13 gives each pixel one
thread, in 2-D tiles (K13_TILE), that walks only its own bin's taps to the
first hit, reusing the last tap's 1/z where the host flagged it
(`pack_taps`): every term it skips adds 0 * a finite value, so both
compute the same function, bit for bit, for finite planes.

Inputs are [hq, wq] float32 planes from post._ssr_p's geometry stage: the
view depth dq, the three colour planes, invz0 = 1 / dq, the 1/z gradient g
per pixel of march, the direction bin (an integer-valued float) and the
valid mask (0 or 1). `offsets` is post._ssr_offsets(cfg): per bin, the
(t_prev, t, oy, ox) taps. Returns (refl_r, refl_g, refl_b, hit_w, hit_t).

Under grad the march is `SsrMarchFn`: forward K13's RECORD instance
(`ssr_march(..., record=True)`), which also writes the hit record, an int32 plane
holding each pixel's first-hit tap index in its bin (-1 for none or not
valid); backward K15 (`ssr_march_grad`, csrc/ssr_march_grad.cu), the
adjoint of the JAX package's XLA march: the outputs depend on the colour
planes only through the first hit's read (weight 1), so each pixel's
colour cotangent goes to that one source pixel, gathered per source pixel
without atomics. Its twin `ssr_march_grad_plain` adds the same terms in
the same order. Depth, 1/z, its gradient, the bins and the mask reach the
outputs only through comparisons and get no gradient, and hit_w and hit_t
carry none, as under jax.grad.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops import cuda


def ssr_march_reference(dq, colors: Sequence, invz0, g, bin_idx, valid,
                        offsets: tuple, thickness: float, max_px: float,
                        record: bool = False) -> Tuple[torch.Tensor, ...]:
    """Twin of K13: the JAX package's XLA march loop (post._ssr_p), all
    bins over the whole plane, each masked by its sel. record=True also
    returns the hit record (int32 [hq, wq]) from the same weights: the tap
    index where a pixel's wgt is 1 in its own bin, -1 where it is never 1
    or sel is 0 (K13's RECORD instance)."""
    # post imports this module: its edge-clamped shift is bound here
    from volumetricrenderer_tpu_torch.post import _shift2_p as _shift
    hq, wq = dq.shape
    z = lambda: torch.zeros((hq, wq), dtype=torch.float32, device=dq.device)
    yy = torch.arange(hq, device=dq.device)[:, None]
    xx = torch.arange(wq, device=dq.device)[None, :]
    refl = [z(), z(), z()]
    hitw, hitt = z(), z()
    none = torch.full((hq, wq), -1, dtype=torch.int32, device=dq.device)
    hit_k = none
    for b, taps in enumerate(offsets):
        sel = (bin_idx == b).to(torch.float32) * valid
        not_hit = torch.ones_like(dq)
        acc = [z(), z(), z()]
        aw, at = z(), z()
        first = none
        for k, (t_prev, t, oy, ox) in enumerate(taps):
            zs = _shift(dq, oy, ox)
            invz = invz0 + g * t
            z_ray = torch.where(invz > 1e-4,
                                1.0 / torch.clamp(invz, min=1e-4),
                                torch.full_like(invz, 1e9))
            invz_p = invz0 + g * t_prev
            z_prev = torch.where(invz_p > 1e-4,
                                 1.0 / torch.clamp(invz_p, min=1e-4),
                                 torch.full_like(invz_p, 1e9))
            onscreen = ((yy + oy >= 0) & (yy + oy < hq)
                        & (xx + ox >= 0) & (xx + ox < wq)).to(torch.float32)
            hit = ((z_ray >= zs) & (z_prev <= zs + thickness)
                   ).to(torch.float32) * onscreen
            wgt = not_hit * hit
            for c in range(3):
                acc[c] = acc[c] + wgt * _shift(colors[c], oy, ox)
            aw = aw + wgt
            at = at + wgt * (t / max_px)
            not_hit = not_hit * (1.0 - hit)
            if record:
                first = torch.where(wgt != 0.0, k, first)
        for c in range(3):
            refl[c] = refl[c] + sel * acc[c]
        hitw = hitw + sel * aw
        hitt = hitt + sel * at
        if record:
            hit_k = torch.where(sel != 0.0, first, hit_k)
    out = (refl[0], refl[1], refl[2], hitw, hitt)
    return out + (hit_k,) if record else out


# K13's launch (csrc/ssr_march.cu): a block a tile of (columns, rows) of
# quarter-res pixels, a thread a pixel; the tap counts a bin that its fixed
# instances unroll for (past them the GEN instance's runtime loop); the
# table's bytes a block takes in static shared memory (past that the table
# stays in device memory)
K13_TILE = (32, 4)
K13_UNROLL = (16, 32)
K13_OFF = 2048          # the offset bias of a packed row
K13_MAX_SHARED = 48 * 1024
# the forms (cuda.SIZE_FORMS' order): the instance and the table's place
K13_FORMS = cuda.SIZE_FORMS["ssr_march"][:3]


def k13_unroll(max_taps: int) -> int:
    """Mirror of csrc/ssr_march.cu k13_unroll: the fixed instance's tap
    count for a table of max_taps rows a bin, 0 past the largest (the GEN
    instance's runtime loop: ssr_steps from about 48)."""
    for n in K13_UNROLL:
        if max_taps <= n:
            return n
    return 0


def k13_shared_bytes(n_bins: int, max_taps: int) -> int:
    """Mirror of k13_shared_bytes: a block's copy of the table, its float4
    rows and its int32 counts."""
    return 16 * n_bins * max_taps + 4 * n_bins


def k13_form(n_bins: int, max_taps: int, form: str = None) -> str:
    """Mirror of k13_form: the form of K13_FORMS that K13's launcher takes
    for a table of n_bins x max_taps rows, the first in K13_FORMS' order
    that can take it -- the fixed instances up to 32 taps a bin, GEN past
    them; the table in static shared memory up to 48 KB, past that in
    device memory (GEN). form: a form to force instead, which raises
    ValueError where it cannot take the table."""
    smem = k13_shared_bytes(n_bins, max_taps)
    shared = smem <= K13_MAX_SHARED
    fits = {"fixed": k13_unroll(max_taps) > 0 and shared, "gen": shared,
            "gen_global": True}
    if form is None:
        return next(f for f in K13_FORMS if fits[f])
    if not fits.get(form, False):
        raise ValueError(f"K13 form {form!r} cannot take {n_bins} bins of "
                         f"{max_taps} taps ({smem} B): one of {K13_FORMS} "
                         "that fits")
    return form


def k13_grid(hq: int, wq: int) -> Tuple[int, int]:
    """K13's launch grid (column tiles, row tiles) on [hq, wq] planes."""
    tx, ty = K13_TILE
    return (-(-wq // tx), -(-hq // ty))


def pack_taps(offsets: tuple, max_px: float):
    """K13's tap table: float32 [n_bins, max_taps, 4] rows (t_prev, t,
    t / max_px, packed), each as the twin rounds it to float32, packed the
    int32 bits of (oy + K13_OFF) | (ox + K13_OFF) << 12 | reuse << 24, where
    reuse flags a tap whose t_prev equals the previous tap's t (the kernel
    then reuses that tap's 1/z: the same division); and int32 [n_bins] tap
    counts. Raises ValueError for an offset K13 cannot pack."""
    n_taps = max(max((len(b) for b in offsets), default=0), 1)
    rows = np.zeros((len(offsets), n_taps, 4), np.float32)
    bits = rows.view(np.int32)
    for b, taps in enumerate(offsets):
        for i, (t_prev, t, oy, ox) in enumerate(taps):
            if max(abs(oy), abs(ox)) >= K13_OFF:
                raise ValueError(f"SSR tap offset ({oy}, {ox}): K13 packs "
                                 f"offsets below {K13_OFF}")
            rows[b, i, :3] = (t_prev, t, t / max_px)
            reuse = i > 0 and rows[b, i, 0] == rows[b, i - 1, 1]
            bits[b, i, 3] = ((oy + K13_OFF) | (ox + K13_OFF) << 12
                             | int(reuse) << 24)
    counts = np.array([len(b) for b in offsets], np.int32)
    return rows, counts


def _by_identity(fn):
    """fn(offsets, *rest) cached first by the identity of `offsets`, a tap
    table's tuple (post._ssr_offsets returns one per config), then by
    fn's own cache by value: hashing a tuple of thousands of taps on every
    call costs host time that grows with the table and, at 128 bins of 54
    taps, passes the kernels' own. The cache holds the tuple, so its id is
    not reused while it is cached."""
    seen = {}

    @functools.wraps(fn)
    def run(offsets, *rest):
        key = (id(offsets), *rest)
        hit = seen.get(key)
        if hit is None or hit[0] is not offsets:
            if len(seen) >= 16:
                seen.clear()
            hit = seen[key] = (offsets, fn(offsets, *rest))
        return hit[1]
    return run


@_by_identity
@functools.lru_cache(maxsize=8)
def tap_table(offsets: tuple, max_px: float, device: torch.device):
    """pack_taps' table and counts on `device`. Uploaded once per config:
    two copies a call would cost K13's wrapper three times the kernel's
    device time."""
    rows, counts = pack_taps(offsets, max_px)
    return (cuda.upload(rows, device),
            cuda.upload(counts, device, torch.int32))


def ssr_march(dq, colors: Sequence, invz0, g, bin_idx, valid,
              offsets: tuple, thickness: float, max_px: float,
              record: bool = False, form: str = None
              ) -> Tuple[torch.Tensor, ...]:
    """K13: the SSR march of `ssr_march_pallas` (the JAX signature, less
    `interpret`). CPU tensors take the twin; CUDA tensors launch the kernel
    once, in the form k13_form picks from the table's size (or `form`,
    forced), or raise. record=True launches K13's RECORD instance (counted
    as K13), which also returns the hit record (int32 [hq, wq]) last."""
    if dq.device.type == "cpu":
        return ssr_march_reference(dq, colors, invz0, g, bin_idx, valid,
                                   offsets, thickness, max_px, record)
    planes = [p.contiguous() for p in (dq, *colors, invz0, g, bin_idx,
                                       valid)]
    hq, wq = dq.shape
    for p in planes:
        if p.shape != (hq, wq):
            raise ValueError(f"plane {tuple(p.shape)} != {(hq, wq)}")
    n_bins = len(offsets)
    max_taps = max(max((len(b) for b in offsets), default=0), 1)
    form = -1 if form is None else \
        K13_FORMS.index(k13_form(n_bins, max_taps, form))
    cuda.check_cuda(*planes)
    taps, counts = tap_table(offsets, float(max_px), dq.device)
    outs = [torch.empty_like(planes[0]) for _ in range(5)]
    if record:
        outs.append(torch.empty((hq, wq), dtype=torch.int32,
                                device=dq.device))
    cuda.launch("ssr_march", *(cuda.ptr(p) for p in planes), cuda.ptr(taps),
                cuda.ptr(counts), n_bins, max_taps, hq, wq,
                float(np.float32(thickness)), *(cuda.ptr(o) for o in outs),
                *(() if record else (None,)), form,
                entry="vr_ssr_march_form")
    return tuple(outs)


# the JAX package's name for the same function
ssr_march_pallas = ssr_march


def _shift_zero(p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = p[y - dy, x - dx], +0 where that leaves the plane."""
    hq, wq = p.shape
    out = torch.zeros_like(p)
    if abs(dy) >= hq or abs(dx) >= wq:
        return out
    out[max(dy, 0):hq + min(dy, 0), max(dx, 0):wq + min(dx, 0)] = \
        p[max(-dy, 0):hq + min(-dy, 0), max(-dx, 0):wq + min(-dx, 0)]
    return out


def ssr_march_grad_plain(grads: Sequence, bin_idx, hit_k, offsets: tuple
                         ) -> Tuple[torch.Tensor, ...]:
    """Twin of K15: the colour planes' gradient of the march from the
    cotangents of its three colour outputs. Per bin b and tap k, in order,
    each plane adds the cotangent of the pixels whose bin is b and whose
    hit record is k, shifted by the tap's offset onto the pixel it read
    (+0 where none did)."""
    out = [torch.zeros_like(grads[0]) for _ in range(3)]
    for b, taps in enumerate(offsets):
        in_bin = bin_idx == b
        for k, (_, _, oy, ox) in enumerate(taps):
            mask = in_bin & (hit_k == k)
            for c in range(3):
                out[c] = out[c] + _shift_zero(
                    torch.where(mask, grads[c], 0.0), oy, ox)
    return tuple(out)


# K15's launch (csrc/ssr_march_grad.cu): a block a tile of (columns, rows)
# of source pixels, a thread two rows of a column; its shared copy of the
# table's per-tap offsets in static shared memory up to K15_MAX_SHARED
# bytes, opted in up to K15_MAX_OPTIN, past that none (the offsets read
# from the table in device memory); int16 codes up to K15_MAX_NARROW bins x
# taps, int32 past them (only in device memory: such a table passes the
# opt-in limit)
K15_TILE = (32, 16)
K15_MAX_SHARED = 48 * 1024
K15_MAX_OPTIN = 232448
K15_MAX_NARROW = 32767
K15_FORMS = cuda.SIZE_FORMS["ssr_march_grad"]


@_by_identity
@functools.lru_cache(maxsize=8)
def tap_extent(offsets: tuple) -> Tuple[int, int, int, int]:
    """(oy_lo, oy_hi, ox_lo, ox_hi): the least and largest offset of the
    table's taps on each axis, 0 for a table without taps."""
    oys = [t[2] for b in offsets for t in b] or [0]
    oxs = [t[3] for b in offsets for t in b] or [0]
    return min(oys), max(oys), min(oxs), max(oxs)


def k15_shared_bytes(n_bins: int, max_taps: int) -> int:
    """Mirror of k15_shared_bytes: two int32 offsets a tap (in the code
    plane and in the colour planes) and the int32 counts."""
    return 8 * n_bins * max_taps + 4 * n_bins


def k15_form(n_bins: int, max_taps: int, form: str = None) -> str:
    """Mirror of k15_form: the form of K15_FORMS for a table of n_bins x
    max_taps rows, the first in K15_FORMS' order that can take it -- the
    offsets in static shared memory ("fixed") up to 48 KB, opted in
    ("optin") up to K15_MAX_OPTIN, past that read from the table in device
    memory ("global"); int16 codes up to K15_MAX_NARROW bins x taps, int32
    ("global_wide") past them. form: a form to force instead, which
    raises ValueError where it cannot take the table."""
    smem = k15_shared_bytes(n_bins, max_taps)
    narrow = n_bins * max_taps <= K15_MAX_NARROW
    fits = dict(zip(K15_FORMS, (narrow and smem <= K15_MAX_SHARED,
                                narrow and smem <= K15_MAX_OPTIN, narrow,
                                True)))
    if form is None:
        return next(f for f in K15_FORMS if fits[f])
    if not fits.get(form, False):
        raise ValueError(f"K15 form {form!r} cannot take {n_bins} bins of "
                         f"{max_taps} taps ({smem} B): one of {K15_FORMS} "
                         "that fits")
    return form


def k15_code_shape(hq: int, wq: int, span_y: int,
                   span_x: int) -> Tuple[int, int]:
    """Mirror of k15_code_shape: K15's code plane, [hq, wq] rounded
    up to whole K15_TILE tiles and grown by the offsets' span on each
    axis."""
    tx, ty = K15_TILE
    return -(-hq // ty) * ty + span_y, -(-wq // tx) * tx + span_x


def ssr_march_grad(grads: Sequence, bin_idx, hit_k, offsets: tuple,
                   max_px: float, form: str = None
                   ) -> Tuple[torch.Tensor, ...]:
    """K15: the gradient of the march's colour outputs with respect
    to its colour planes, from their cotangents `grads`, the bin plane and
    the hit record. CPU tensors take the twin; CUDA tensors launch the
    kernel once (its code plane, then its gather, on a scratch plane of
    k15_code_shape) in the form k15_form picks from the table's size (or
    `form`, forced), or raise: the launch names the form it mirrors, whose
    code plane it allocates. max_px picks K13's cached table (K15 reads its
    offsets only)."""
    if bin_idx.device.type == "cpu":
        return ssr_march_grad_plain(grads, bin_idx, hit_k, offsets)
    planes = [p.contiguous() for p in (*grads, bin_idx)]
    hit_k = hit_k.contiguous()
    hq, wq = bin_idx.shape
    for p in (*planes, hit_k):
        if p.shape != (hq, wq):
            raise ValueError(f"plane {tuple(p.shape)} != {(hq, wq)}")
    n_bins = len(offsets)
    max_taps = max(max((len(b) for b in offsets), default=0), 1)
    oy_lo, oy_hi, ox_lo, ox_hi = tap_extent(offsets)
    form = k15_form(n_bins, max_taps, form)
    cuda.check_cuda(*planes)
    cuda.check_cuda(hit_k, dtype=torch.int32)
    taps, counts = tap_table(offsets, float(max_px), bin_idx.device)
    codes = torch.empty(k15_code_shape(hq, wq, oy_hi - oy_lo,
                                       ox_hi - ox_lo),
                        dtype=torch.int32 if form == "global_wide"
                        else torch.int16, device=bin_idx.device)
    outs = [torch.empty_like(planes[0]) for _ in range(3)]
    cuda.launch("ssr_march_grad", *(cuda.ptr(p) for p in planes[:4]),
                cuda.ptr(hit_k), cuda.ptr(taps), cuda.ptr(counts), n_bins,
                max_taps, hq, wq, oy_lo, oy_hi, ox_lo, ox_hi,
                cuda.ptr(codes), K15_FORMS.index(form),
                *(cuda.ptr(o) for o in outs), entry="vr_ssr_march_grad_form")
    return tuple(outs)


class SsrMarchFn(torch.autograd.Function):
    """The march under grad: apply(dq, r, g, b, invz0, g_z, bin_idx, valid,
    offsets, thickness, max_px) -> (refl_r, refl_g, refl_b, hit_w, hit_t).
    The forward launches K13's RECORD instance on detached inputs (a kernel
    takes no tensor that requires grad); the backward launches K15 for the
    three colour planes and gives the other inputs no gradient. hit_w and
    hit_t are not differentiable."""

    @staticmethod
    def forward(ctx, dq, cr, cg, cb, invz0, g, bin_idx, valid, offsets,
                thickness, max_px):
        d = [t.detach() for t in (dq, cr, cg, cb, invz0, g, bin_idx, valid)]
        *outs, hit_k = ssr_march(d[0], d[1:4], *d[4:], offsets, thickness,
                                 max_px, record=True)
        ctx.save_for_backward(d[6], hit_k)
        ctx.args = (offsets, max_px)
        ctx.mark_non_differentiable(outs[3], outs[4])
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_r, g_g, g_b, _g_w, _g_t):
        bin_idx, hit_k = ctx.saved_tensors
        offsets, max_px = ctx.args
        need = ctx.needs_input_grad[1:4]
        grads = (None, None, None)
        if any(need):
            grads = ssr_march_grad([g_r, g_g, g_b], bin_idx, hit_k, offsets,
                                   max_px)
            grads = tuple(gc if n else None for gc, n in zip(grads, need))
        return (None, *grads) + (None,) * 7


def ssr_march_differentiable(dq, colors: Sequence, invz0, g, bin_idx, valid,
                             offsets: tuple, thickness: float, max_px: float
                             ) -> Tuple[torch.Tensor, ...]:
    """ssr_march with the colour planes' gradient (SsrMarchFn)."""
    return SsrMarchFn.apply(dq, *colors, invz0, g, bin_idx, valid, offsets,
                            thickness, max_px)
