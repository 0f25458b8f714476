"""Tileable 3D noise evaluated per point, and the screen-space dither
pattern.

Counterpart of `volumetricrenderer_tpu/ops/noise.py` `perlin_3d`, which the
material volume pass (`pipeline.write_material_volumes`) calls, and
`interleaved_gradient_noise`, which the post stack's final dither calls. The
JAX package has two Perlin implementations with one hash (ops/noise.py on
[..., 3] positions, ops/pallas/material.py on coordinate planes); the port
has one, `ops/material.perlin_planes`, and this module gives it the
[..., 3] signature. Texture noise (`perlin_texture_3d`) is not ported.
"""

from __future__ import annotations

import torch

from volumetricrenderer_tpu_torch.ops.material import perlin_planes


def perlin_3d(uvw: torch.Tensor, octaves: int = 3, period: int = 4,
              seed: int = 7) -> torch.Tensor:
    """Tileable fBm Perlin in [0, 1]; uvw [..., 3] with unit tile = 1.0."""
    return perlin_planes(uvw[..., 0], uvw[..., 1], uvw[..., 2], octaves,
                         period, seed)


def interleaved_gradient_noise(pix_coord: torch.Tensor,
                               frame_count) -> torch.Tensor:
    """Jimenez 2014 interleaved gradient noise with per-frame scroll (the
    Unity reference's Random.hlsl:98-104, with its frame 'magic scale'):
    pix_coord [..., 2] (x, y) float32 -> [...] in [0, 1)."""
    f32 = torch.float32
    dev = pix_coord.device
    frame_scale = torch.tensor([2.083, 4.867], dtype=f32, device=dev)
    p = pix_coord + torch.as_tensor(frame_count, dtype=f32,
                                    device=dev) * frame_scale
    d = p[..., 0] * 0.06711056 + p[..., 1] * 0.00583715
    frac = d - torch.floor(d)
    v = 52.9829189 * frac
    return v - torch.floor(v)
