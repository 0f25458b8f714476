"""Tileable 3D noise evaluated per point.

Counterpart of `volumetricrenderer_tpu/ops/noise.py` `perlin_3d`, which the
material volume pass (`pipeline.write_material_volumes`) calls. The JAX
package has two Perlin implementations with one hash (ops/noise.py on
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
