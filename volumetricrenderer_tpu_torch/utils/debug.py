"""Debug and observability helpers (`volumetricrenderer_tpu/utils/debug.py`).

The reference's debug pass: a froxel slice selector and a composite of that
slice over the scene colour, as functions returning images and statistics;
and a PNG writer on the standard library alone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def volume_slice(volume: torch.Tensor, z: int) -> torch.Tensor:
    """Froxel slice z: volume [D, H, W(, C)] -> [H, W(, C)]."""
    return volume[z]


def debug_composite(scene_color: torch.Tensor,
                    volume_slice_rgba: torch.Tensor) -> torch.Tensor:
    """The debug pass's blend `main * a + rgb`, the slice [h, w, 4]
    upsampled to the image [IH, IW, 3] by nearest neighbour."""
    ih, iw = scene_color.shape[:2]
    h, w = volume_slice_rgba.shape[:2]
    dev = volume_slice_rgba.device
    yi = torch.arange(ih, device=dev) * h // ih
    xi = torch.arange(iw, device=dev) * w // iw
    up = volume_slice_rgba[yi][:, xi]
    return scene_color * up[..., 3:4] + up[..., :3]


def channel_stats(aux: Dict[str, torch.Tensor]) -> Dict[str, dict]:
    """Per-volume shape, min, max, mean and count of NaNs."""
    out = {}
    for name, vol in aux.items():
        v = vol.detach().cpu().numpy() if isinstance(vol, torch.Tensor) \
            else np.asarray(vol)
        out[name] = dict(shape=tuple(v.shape), min=float(v.min()),
                         max=float(v.max()), mean=float(v.mean()),
                         nans=int(np.isnan(v).sum()))
    return out


def save_png(path: str, rgb) -> None:
    """Write [H, W, 3] floats in [0, 1] (row 0 at the bottom) as a PNG,
    with the standard library only."""
    import struct
    import zlib

    arr = rgb.detach().cpu().numpy() if isinstance(rgb, torch.Tensor) \
        else np.asarray(rgb)
    arr = np.clip(arr, 0.0, 1.0)
    img = (arr[::-1] * 255).astype(np.uint8)  # PNG rows run top-down
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
