"""The stage functions of the staged frame.

Counterpart of `volumetricrenderer_tpu/pipeline.py` for the branches the
port covers: each function checks that the config asks for the ported
branch, raises NotImplementedError naming what is missing otherwise, and
calls the kernel wrapper on the frame's packed tables
(ops/frame_fused.FrameTables) instead of re-deriving them from the scene.

  write_shadow_volume_dir  raycast + dir_shadow_impl="pallas": kernel K7
  write_scatter_volume     scatter_impl="pallas" + material_impl="fused":
                           kernel K6, fed by K1 when the local lights are
                           baked at the low rate
  accumulate               accumulate_impl="pallas": kernel K8
"""

from __future__ import annotations

import torch

from volumetricrenderer_tpu_torch.config import RenderConfig
from volumetricrenderer_tpu_torch.ops.dir_shadow import dir_shadow
from volumetricrenderer_tpu_torch.ops.frame_fused import (FrameTables,
                                                          bake_radiance)
from volumetricrenderer_tpu_torch.ops.integrate import \
    accumulate as accumulate_kernel
from volumetricrenderer_tpu_torch.ops.scatter import scatter_local


def _require(cfg: RenderConfig, name: str, want, missing: str) -> None:
    if getattr(cfg, name) != want:
        raise NotImplementedError(
            f"config {name}={getattr(cfg, name)!r}: {missing} is not ported "
            f"(only {name}={want!r})")


def write_shadow_volume_dir(cfg: RenderConfig,
                            tables: FrameTables) -> torch.Tensor:
    """Per-froxel sun visibility, squared and gated, without temporal blend:
    [Nd, D, H, W]."""
    _require(cfg, "shadow_mode", "raycast", "the shadow-map sampler")
    _require(cfg, "dir_shadow_impl", "pallas", "the XLA shadow volume")
    return dir_shadow(tables)


def write_scatter_volume(cfg: RenderConfig, tables: FrameTables,
                         shadow: torch.Tensor) -> torch.Tensor:
    """In-scatter of every light with the material evaluated in the kernel:
    [4, D, H, W] (r, g, b, extinction). shadow: the (blended) sun visibility
    [Nd, D, H, W]. With raycast_shadow_subsample > 1 the local lights come
    from the low-rate radiance bake; at 1 each froxel loops over its slice's
    lights with one any-hit shadow ray per light."""
    _require(cfg, "shadow_mode", "raycast", "map-mode local shadows")
    _require(cfg, "scatter_impl", "pallas", "the XLA scatter")
    _require(cfg, "material_impl", "fused",
             "the scatter reading material volumes "
             "(write_material_volumes)")
    if tables.ss == 1:
        return scatter_local(tables, shadow, None)
    _require(cfg, "scatter_bake", "radiance",
             "the low-rate per-light visibility bake "
             "(bake_visibility_pallas)")
    return scatter_local(tables, shadow, bake_radiance(tables))


def accumulate(cfg: RenderConfig, tables: FrameTables,
               scatter: torch.Tensor) -> torch.Tensor:
    """Front-to-back integration of the scatter planes without temporal
    blend: [4, D, H, W] (L_r, L_g, L_b, T)."""
    _require(cfg, "accumulate_impl", "pallas", "the XLA scan")
    return accumulate_kernel(tables, scatter)
