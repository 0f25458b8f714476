"""Front-to-back transmittance integration outside the kernels.

Counterpart of `volumetricrenderer_tpu/ops/scatter_scan.py` on channel-first
volumes: the per-slice analytic integral and the two-level scan that the
plain accumulation (`accumulate_impl="xla"`, or any frame whose scatter
volume went through the scatter blend) runs. The recurrence is linear in
(L, T) with the associative composition

    (L1, T1) (+) (L2, T2) = (L1 + T1 * L2, T1 * T2)

and `associative_scan` combines in the tree order of
`jax.lax.associative_scan` (pairs of neighbours, recursively), so that the
sums round as they do there. Kernel K8 (ops/integrate.py) integrates the
same planes sequentially with another Taylor guard and rounds differently.
"""

from __future__ import annotations

from typing import Tuple

import torch


def slice_integral(in_scatter: torch.Tensor, extinction: torch.Tensor,
                   step_length: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, T) of one slice: T = exp(-sigma dz), S = inScatter (1 - T) / sigma
    with the sigma -> 0 limit inScatter dz (1 - sigma dz / 2). in_scatter
    [D, 3, H, W], extinction [D, H, W], step_length broadcastable to it."""
    od = extinction * step_length
    t = torch.exp(-od)
    small = od < 1e-5
    safe_sigma = torch.where(small, torch.ones_like(extinction), extinction)
    generic = -torch.expm1(-od) / safe_sigma
    taylor = step_length * (1.0 - 0.5 * od)
    factor = torch.where(small, taylor, generic)
    return in_scatter * factor[:, None], t


def _combine(a, b):
    return a[0] + a[1][:, None] * b[0], a[1] * b[1]


def associative_scan(elems):
    """Inclusive scan of (L [N, 3, ...], T [N, ...]) along dim 0 under the
    composition above, combining in jax.lax.associative_scan's order."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[0:n - 1:2] for e in elems),
                       tuple(e[1::2] for e in elems))
    odd = associative_scan(reduced)
    rest = tuple(e[2::2] for e in elems)
    if n % 2 == 0:
        even = _combine(tuple(e[:-1] for e in odd), rest)
    else:
        even = _combine(odd, rest)
    even = tuple(torch.cat([e[0:1], v]) for e, v in zip(elems, even))
    out = []
    for ev, od in zip(even, odd):
        res = torch.empty((n,) + tuple(ev.shape[1:]), dtype=ev.dtype,
                          device=ev.device)
        res[0::2] = ev
        res[1::2] = od
        out.append(res)
    return tuple(out)


def _steps(step_lengths: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return step_lengths.reshape((-1,) + (1,) * (like.dim() - 1))


def accumulate_scan(in_scatter: torch.Tensor, extinction: torch.Tensor,
                    step_lengths: torch.Tensor) -> torch.Tensor:
    """Inclusive integration along z as one associative scan. in_scatter
    [3, D, H, W], extinction [D, H, W], step_lengths [D]. Returns
    [4, D, H, W] (L rgb and total transmittance after each slice)."""
    s, t = slice_integral(in_scatter.transpose(0, 1), extinction,
                          _steps(step_lengths, extinction))
    l_acc, t_acc = associative_scan((s, t))
    return torch.cat([l_acc.transpose(0, 1), t_acc[None]])


def accumulate_blocked(in_scatter: torch.Tensor, extinction: torch.Tensor,
                       step_lengths: torch.Tensor,
                       block: int = 8) -> torch.Tensor:
    """The same integral as a two-level scan: sequential prefixes within
    z-blocks, an associative scan over the block totals, one combine sweep.
    Shapes as accumulate_scan."""
    d = extinction.shape[0]
    if d % block:
        return accumulate_scan(in_scatter, extinction, step_lengths)
    nb = d // block
    s, t = slice_integral(in_scatter.transpose(0, 1), extinction,
                          _steps(step_lengths, extinction))
    sb = s.reshape((nb, block) + tuple(s.shape[1:]))
    tb = t.reshape((nb, block) + tuple(t.shape[1:]))
    l_list, t_list = [sb[:, 0]], [tb[:, 0]]
    for i in range(1, block):
        l_list.append(l_list[-1] + t_list[-1][:, None] * sb[:, i])
        t_list.append(t_list[-1] * tb[:, i])
    l_in = torch.stack(l_list, dim=1)       # [nb, block, 3, H, W]
    t_in = torch.stack(t_list, dim=1)       # [nb, block, H, W]
    tot_l, tot_t = associative_scan((l_in[:, -1], t_in[:, -1]))
    pre_l = torch.cat([torch.zeros_like(tot_l[:1]), tot_l[:-1]])
    pre_t = torch.cat([torch.ones_like(tot_t[:1]), tot_t[:-1]])
    l_acc = pre_l[:, None] + pre_t[:, None, None] * l_in
    t_acc = pre_t[:, None] * t_in
    l_acc = l_acc.reshape((d,) + tuple(s.shape[1:]))
    t_acc = t_acc.reshape((d,) + tuple(t.shape[1:]))
    return torch.cat([l_acc.transpose(0, 1), t_acc[None]])
