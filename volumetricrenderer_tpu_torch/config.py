"""Render configuration (static, hashable).

PyTorch counterpart of `volumetricrenderer_tpu/config.py`: the same frozen
dataclass with the same fields and defaults, so a config reads the same in
both packages. Fields that select between JAX implementations (`*_impl`,
`frame_fused`, `composite_precision`) are kept for that reason: the port's
renderer routes on them as the JAX renderer does (fused or staged volume
phase, low-rate bake or per-light scatter) and raises on a value whose
branch is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Froxel grid (reference: 160x88x64).
    volume_width: int = 160
    volume_height: int = 88
    volume_depth: int = 64

    # Camera -> volume mapping.
    volume_distance: float = 100.0
    depth_distribution: float = 0.5

    # Temporal filtering.
    temporal_blend_alpha: float = 1.0 / 7.0
    temporal_blend_material: bool = False
    temporal_blend_scatter: bool = False
    temporal_blend_shadow: bool = True
    temporal_blend_accumulation: bool = True
    use_current_matrix_for_reproj: bool = False

    # Reference quirk: the directional scatter is not jittered.
    jitter_dir_scatter: bool = False

    # Temporal reprojection: windowed separable tent warp, +-reproj_window.
    reproj_impl: str = "windowed"
    reproj_window: int = 4

    # Shadowing.
    shadow_map_size: int = 512
    num_cascades: int = 4
    shadow_distance: float = 100.0
    cascade_splits: Tuple[float, ...] = (0.067, 0.2, 0.467, 1.0)
    shadow_mode: str = "map"
    heightfield_local_shadows: bool = False

    # Local-light shadow sampling rate (low-rate bake at 1/N^3).
    raycast_shadow_subsample: int = 1
    # Payload of the low-rate bake: "vis" or "radiance".
    scatter_bake: str = "vis"
    inline_bake_group: int = 1
    bake_procedural_noise: bool = False
    dir_shadow_subsample: int = 1
    texture_noise_subsample: int = 1

    # Output image.
    image_width: int = 1280
    image_height: int = 720

    # Storage dtype of the froxel volumes ("float32" or "bfloat16").
    volume_dtype: str = "float32"

    # Implementation selectors of the JAX package (see module docstring).
    scatter_impl: str = "xla"
    material_impl: str = "xla"
    dir_shadow_impl: str = "xla"
    frame_fused: bool = True
    accumulate_impl: str = "xla"
    composite_impl: str = "tentmm"
    composite_upsample: int = 1
    composite_precision: str = "highest"

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(W, H, D) in reference order."""
        return (self.volume_width, self.volume_height, self.volume_depth)

    @property
    def grid_dhw(self) -> Tuple[int, int, int]:
        """Array-layout order [D, H, W]."""
        return (self.volume_depth, self.volume_height, self.volume_width)

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.volume_dtype == "bfloat16" \
            else torch.float32


DEMO_CONFIG = RenderConfig(temporal_blend_alpha=0.84)

# 240x135x128 froxels at 1080p with every production fast path on: raycast
# shadows, the ss=4 low-rate radiance + fBm bake, the fused volume phase and
# the zgather composite.
FULL_CONFIG = RenderConfig(
    volume_width=240,
    volume_height=135,
    volume_depth=128,
    image_width=1920,
    image_height=1080,
    temporal_blend_alpha=0.84,
    shadow_mode="raycast",
    raycast_shadow_subsample=4,
    scatter_bake="radiance",
    bake_procedural_noise=True,
    dir_shadow_subsample=2,
    reproj_impl="pallas",
    scatter_impl="pallas",
    dir_shadow_impl="pallas",
    accumulate_impl="pallas",
    material_impl="fused",
    composite_impl="zgather",
    composite_precision="high",
)

# 4K profile: FULL_CONFIG at 3840x2160 with the fractional-resolution
# composite: (L, T) sampled at 1920x1080 on pixels co-sited with every
# second full-res pixel, upsampled bilinearly, blended with the scene at
# full res. Every second pixel equals the exact composite of
# composite_upsample=1 (16x16-pixel cells).
UHD_CONFIG = dataclasses.replace(
    FULL_CONFIG, image_width=3840, image_height=2160, composite_upsample=2)


def composite_eligible(cfg: RenderConfig) -> bool:
    """Whether the zgather composite handles this config (the JAX package's
    `pipeline.zgather_eligible`): 8x8 px cells or multiples of 8, D <= 128,
    integer pixel/froxel ratios, a grid height divisible by 3 or 5."""
    w, h, d = cfg.grid
    if not (cfg.composite_impl == "zgather"
            and cfg.image_width % w == 0 and cfg.image_height % h == 0
            and d <= 128 and (h % 3 == 0 or h % 5 == 0)):
        return False
    py, px = cfg.image_height // h, cfg.image_width // w
    return py * px == 64 or (py % 8 == 0 and px % 8 == 0)


def cosited_eligible(cfg: RenderConfig) -> bool:
    """Whether the composite runs at 1/composite_upsample of the image on
    co-sited pixels (the first branch of the JAX package's
    `pipeline.composite`): composite_upsample > 1, both image sides divisible
    by it, and the low-res config composite_eligible. Otherwise the JAX
    package composites at full resolution, whatever composite_upsample
    says."""
    us = max(int(cfg.composite_upsample), 1)
    if us == 1 or cfg.image_width % us or cfg.image_height % us:
        return False
    return composite_eligible(dataclasses.replace(
        cfg, image_width=cfg.image_width // us,
        image_height=cfg.image_height // us, composite_upsample=1))


def composite_route(cfg: RenderConfig) -> str:
    """Which form of kernel K4 computes this config's composite, following
    the branches of the JAX package's `pipeline.composite`:

      "cosited"  at 1/composite_upsample on co-sited pixels, then the plain
                 upsample (cosited_eligible);
      "cells"    the pixel-cell form, at integer pixel/froxel ratios where
                 JAX takes the zgather kernel (composite_eligible), or
                 `composite_pallas` or `composite_tentmm` (an ineligible
                 "zgather" config falls back to tentmm): the same clamped
                 trilinear on each cell's static weights;
      "pixels"   the per-pixel form, everywhere else: `composite_rowmm`
                 (a non-integer IH/H, or composite_impl="rowmm"),
                 `composite_anyres` (a non-integer IW/W) and the per-pixel
                 gather of composite_impl="xla"."""
    w, h, _ = cfg.grid
    if cosited_eligible(cfg):
        return "cosited"
    if composite_eligible(cfg) or (
            cfg.composite_impl in ("pallas", "tentmm", "zgather")
            and cfg.image_width % w == 0 and cfg.image_height % h == 0):
        return "cells"
    return "pixels"


def zgather_slab_eligible(cfg: RenderConfig, halo: int) -> bool:
    """Whether the JAX package composites a slab (cfg: its halo-extended
    config, volume_height = h_out + 2 halo, image_height its band) with its
    zgather kernel: `pipeline.zgather_slab_eligible`'s prepadded call at
    row_off = halo, or the halo_rows call on the planes' rows [halo - 1,
    halo + h_out + 1). Both are one cell composite here, and the prepadded
    call's own conditions (its padded planes' width and rows) hold only
    where these do, so they are left out: they choose a TPU layout, not
    the result."""
    w, h, d = cfg.grid
    h_out = h - 2 * halo
    ih, iw = cfg.image_height, cfg.image_width
    if not (cfg.composite_impl == "zgather" and h_out > 0 and d <= 128
            and halo >= 1 and iw % w == 0 and ih % h_out == 0
            and (h_out % 3 == 0 or h_out % 5 == 0)):
        return False
    py, px = ih // h_out, iw // w
    return py * px == 64 or (py % 8 == 0 and px % 8 == 0)


def slab_composite_route(cfg: RenderConfig, halo: int) -> str:
    """Which form of K4 composites a slab's band, following the slab branch
    of the JAX package's `pipeline.composite`:

      "cells"   zgather_slab_eligible (JAX: the zgather kernel, prepadded
                at row_off = halo or on the band's rows with halo_rows):
                the cell composite whose cell row cy reads accumulation
                rows cy + halo + dy - 1;
      "pixels"  otherwise (JAX: composite_rowmm with the slab's fy)."""
    return "cells" if zgather_slab_eligible(cfg, halo) else "pixels"
