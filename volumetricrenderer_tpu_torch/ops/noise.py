"""Tileable 3D noise, the media's noise factor, and the screen-space dither
pattern.

Counterpart of `volumetricrenderer_tpu/ops/noise.py`: `perlin_3d`, which
the material volume pass (`pipeline.write_material_volumes`) calls,
`perlin_texture_3d`, the host bake of a tileable noise texture that a
texture-noise medium wrap-samples, and `interleaved_gradient_noise`, which
the post stack's final dither calls. The JAX package has two Perlin
implementations with one hash (ops/noise.py on [..., 3] positions,
ops/pallas/material.py on coordinate planes); the port has one,
`ops/material.perlin_planes`, and this module gives it the [..., 3]
signature. `sample_noise` is the JAX pipeline's `_sample_noise`: a medium's
noise factor at world positions, procedural or from its texture.
"""

from __future__ import annotations

import numpy as np
import torch

from volumetricrenderer_tpu_torch.ops.material import perlin_planes
from volumetricrenderer_tpu_torch.ops.sampling import trilinear_sample_3d


def perlin_3d(uvw: torch.Tensor, octaves: int = 3, period: int = 4,
              seed: int = 7) -> torch.Tensor:
    """Tileable fBm Perlin in [0, 1]; uvw [..., 3] with unit tile = 1.0."""
    return perlin_planes(uvw[..., 0], uvw[..., 1], uvw[..., 2], octaves,
                         period, seed)


def perlin_texture_3d(size: int = 32, octaves: int = 3, period: int = 4,
                      seed: int = 7) -> torch.Tensor:
    """An [size, size, size] float32 tileable noise texture on the CPU (z,
    y, x order), texel i holding perlin_3d at (i + 0.5) / size."""
    coords = (torch.arange(size, dtype=torch.float32) + 0.5) / size
    zz, yy, xx = torch.meshgrid(coords, coords, coords, indexing="ij")
    return perlin_planes(xx, yy, zz, octaves, period, seed)


def sample_noise(medium, world_pos: torch.Tensor, time_x) -> torch.Tensor:
    """The noise factor of `medium` at world positions [..., 3], at uvw =
    world * tiling + scroll * time_x: "procedural" evaluates perlin_3d
    there; a texture medium wrap-samples its noise_tex [Nz, Ny, Nx] at
    texel uvw * N - 0.5 (exact trilinear, on the positions' device)."""
    uvw = world_pos * medium.noise_tiling \
        + medium.noise_scroll * float(np.float32(time_x))
    if medium.noise_mode == "procedural":
        return perlin_3d(uvw, octaves=medium.noise_octaves,
                         period=medium.noise_period, seed=medium.noise_seed)
    nz, ny, nx = medium.noise_tex.shape
    return trilinear_sample_3d(medium.noise_tex[None], uvw[..., 0] * nx - 0.5,
                               uvw[..., 1] * ny - 0.5, uvw[..., 2] * nz - 0.5,
                               wrap=True)[0]


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
