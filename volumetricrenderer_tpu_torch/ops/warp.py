"""Windowed warp resampling at arbitrary target volumes.

Counterpart of `volumetricrenderer_tpu/ops/warp.py`
(`windowed_warp_sample_3d`, the plain form) and of
`volumetricrenderer_tpu/ops/pallas/warp.py` (`windowed_warp_pallas`, three
Pallas pass kernels): `windowed_warp` is the wrapper of the CUDA kernel K11
(`csrc/windowed_warp.cu`) that stands for the latter, `windowed_warp_plain`
its plain-torch twin and the port's "windowed" reprojection.

The resample is three sequential 1-D tent passes, z then y then x, each
weighting its 2k+1 taps by its target's offset at ITS OWN output point,
clipped to +-k, with clamp-to-edge taps (SPEC.md "Reprojection sampling").
Output (z, y, x) is therefore

  sum_dx wx(offx[z,y,x]) sum_dy wy(offy[z,y,cx]) sum_dz wz(offz[z,cy,cx])
      vol[cz, cy, cx]

which K11 evaluates as one 8-tap gather. It is not the joint trilinear
sample of torch.nn.functional.grid_sample. Volumes are channel-first
[C, D, H, W] (the JAX functions take [D, H, W, C]).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.temporal import (check_region,
                                                       volume_form, warp)

# K11's block (csrc/windowed_warp.cu K11Tile): a 16 x 16 tile of one slice,
# launched as ops/scatter.tile_grid reckons; the channels 4 at a time
# (csrc/windowed_warp.cu dispatches warp8_by<1..4>).
K11_TILE = (16, 16)
K11_CHANNELS = 4


def k11_shared_bytes(k: int) -> int:
    """Mirror of csrc/windowed_warp.cu k11_floats: the dynamic shared bytes
    of a K11 launch at window k. The block stages the y offsets of its
    tile's rows and the z offsets of its region's rows (the tile and k rows
    before it, k + 1 after: the reach of the taps), each over the region's
    columns (the tile's and k before, k + 1 after), float32."""
    nx, ny = K11_TILE[0] + 2 * k + 1, K11_TILE[1] + 2 * k + 1
    return 4 * (K11_TILE[1] + ny) * nx


def channel_groups(c: int):
    """K11's launches over c channels: (first channel, channels) of each,
    K11_CHANNELS at a time."""
    return [(c0, min(K11_CHANNELS, c - c0))
            for c0 in range(0, c, K11_CHANNELS)]


def k11_form(shape: Tuple[int, ...], form: Optional[str] = None) -> str:
    """Mirror of csrc/windowed_warp.cu k11_form: the index form of one K11
    launch on a channel group's [C, D, H, W] volume (at most K11_CHANNELS
    channels; ops/temporal.volume_form). form: a form to force. Raises
    ValueError, naming K11, before any launch."""
    return volume_form("K11", shape, K11_TILE[1], form)


def _check(vol, target_x, target_y, target_z) -> None:
    if vol.dim() != 4:
        raise ValueError(f"vol {tuple(vol.shape)}: expected [C, D, H, W]")
    for t in (target_x, target_y, target_z):
        if t.shape != vol.shape[1:]:
            raise ValueError(f"target {tuple(t.shape)} != "
                             f"{tuple(vol.shape[1:])}")


def target_offsets(target_x, target_y, target_z, k: int):
    """(off_x, off_y, off_z): the targets clipped to the volume, minus the
    cell index along their axis, clipped to the +-k window."""
    d, h, w = target_x.shape
    dev = target_x.device
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=dev)
    off_z = torch.clamp(torch.clamp(target_z, 0.0, d - 1.0)
                        - ar(d)[:, None, None], -k, k)
    off_y = torch.clamp(torch.clamp(target_y, 0.0, h - 1.0)
                        - ar(h)[None, :, None], -k, k)
    off_x = torch.clamp(torch.clamp(target_x, 0.0, w - 1.0)
                        - ar(w)[None, None, :], -k, k)
    return off_x, off_y, off_z


def windowed_warp_plain(vol: torch.Tensor, target_x: torch.Tensor,
                        target_y: torch.Tensor, target_z: torch.Tensor,
                        k: int = 4) -> torch.Tensor:
    """Twin of K11: vol [C, D, H, W] resampled at the texel coordinates
    target_x/y/z (each [D, H, W])."""
    _check(vol, target_x, target_y, target_z)
    off_x, off_y, off_z = target_offsets(target_x, target_y, target_z, k)
    return warp(vol, off_x, off_y, off_z, k)


def windowed_warp(vol: torch.Tensor, target_x: torch.Tensor,
                  target_y: torch.Tensor, target_z: torch.Tensor,
                  k: int = 4, form: Optional[str] = None) -> torch.Tensor:
    """K11: `windowed_warp_pallas` of the JAX package on channel-first
    volumes, written to a new buffer; a volume of more than 4 channels in
    launches of up to 4 (channel_groups), each in the index form k11_form
    picks for its own group (or `form`, forced)."""
    if vol.device.type == "cpu":
        return windowed_warp_plain(vol, target_x, target_y, target_z, k)
    _check(vol, target_x, target_y, target_z)
    c, d, h, w = vol.shape
    groups = channel_groups(c)
    # each launch indexes its own group's channels
    forms = [k11_form((nc, d, h, w), form) for _, nc in groups]
    check_region(k, k11_shared_bytes(k), "K11")
    cuda.check_cuda(vol, target_x, target_y, target_z)
    out = torch.empty_like(vol)
    for (c0, nc), f in zip(groups, forms):
        cuda.launch("windowed_warp", cuda.ptr(vol[c0:c0 + nc]),
                    cuda.ptr(target_x), cuda.ptr(target_y),
                    cuda.ptr(target_z), cuda.ptr(out[c0:c0 + nc]), nc, d, h,
                    w, int(k), cuda.INDEX_FORMS.index(f),
                    entry="vr_windowed_warp_form")
    return out
