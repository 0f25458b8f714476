"""Triangle-mesh scene content for the rasterized G-buffer
(`volumetricrenderer_tpu/models/mesh.py`).

A `TriMesh` is a world-space triangle soup with a flat albedo per
triangle. ops/raster.py turns it into scene colour and linear depth once per
scene and camera, outside the frame (the reference's G-buffer is an input to
the froxel pipeline), and its shadow comes from voxelized proxy boxes
(models/tree_assets.py) in the analytic box tables.

- `reference_tree(i)` reads the reference's FBX tree meshes (io/fbx.py),
  normalized as the proxy boxes were baked, so the rasterized trees and
  their shadow proxies are the same geometry; without the reference
  checkout it returns None.
- `procedural_tree()` is the stand-in without the checkout: a lat/lon
  canopy sphere and a box trunk.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TriMesh:
    verts: torch.Tensor    # [V, 3] f32 world-space positions
    tris: torch.Tensor     # [T, 3] int32 vertex indices
    albedo: torch.Tensor   # [T, 3] f32 flat per-triangle albedo

    @staticmethod
    def create(verts, tris, albedo, device="cuda") -> "TriMesh":
        verts = torch.as_tensor(np.asarray(verts, np.float32), device=device)
        tris = torch.as_tensor(np.asarray(tris, np.int32), device=device)
        albedo = torch.as_tensor(np.asarray(albedo, np.float32),
                                 device=device)
        if albedo.ndim == 1:
            albedo = albedo[None].expand(tris.shape[0], 3).contiguous()
        if verts.ndim != 2 or verts.shape[1] != 3:
            raise ValueError(f"verts of shape {tuple(verts.shape)}")
        if tris.ndim != 2 or tris.shape[1] != 3:
            raise ValueError(f"tris of shape {tuple(tris.shape)}")
        if albedo.shape != (tris.shape[0], 3):
            raise ValueError(f"albedo of shape {tuple(albedo.shape)}")
        return TriMesh(verts=verts, tris=tris, albedo=albedo)

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]


def concat_meshes(meshes: Sequence[TriMesh]) -> TriMesh:
    """One soup from many instances (vertex indices re-offset)."""
    vs, ts, als = [], [], []
    off = 0
    for m in meshes:
        vs.append(m.verts)
        ts.append(m.tris + off)
        als.append(m.albedo)
        off += m.verts.shape[0]
    return TriMesh(verts=torch.cat(vs), tris=torch.cat(ts),
                   albedo=torch.cat(als))


def transform_mesh(mesh: TriMesh, scale: float = 1.0,
                   translate=(0.0, 0.0, 0.0), yaw: float = 0.0) -> TriMesh:
    """Uniform scale, yaw about +y, then translate: the instancing transform
    of the proxy boxes (models/voxelize.transform_boxes), so that a tree's
    triangles and its shadow proxies stay aligned."""
    c, s = math.cos(yaw), math.sin(yaw)
    dev = mesh.verts.device
    rot = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                       dtype=torch.float32, device=dev)
    v = (mesh.verts * scale) @ rot.T + torch.tensor(
        translate, dtype=torch.float32, device=dev)
    return dataclasses.replace(mesh, verts=v)


# ------------------------------------------------------------------ #
# Content


def procedural_tree(height: float = 6.0, nlat: int = 6, nlon: int = 8,
                    canopy_albedo=(0.18, 0.32, 0.12),
                    trunk_albedo=(0.3, 0.2, 0.12),
                    device="cuda") -> TriMesh:
    """A tree without the reference checkout: lat/lon sphere canopy and box
    trunk, standing on y=0 with the given height (~1e2 triangles)."""
    r = 0.32 * height
    cy = height - r
    verts = [(0.0, cy + r, 0.0)]
    for i in range(1, nlat):
        th = math.pi * i / nlat
        for j in range(nlon):
            ph = 2.0 * math.pi * j / nlon
            verts.append((r * math.sin(th) * math.cos(ph),
                          cy + r * math.cos(th),
                          r * math.sin(th) * math.sin(ph)))
    verts.append((0.0, cy - r, 0.0))
    bot = len(verts) - 1
    tris = []
    for j in range(nlon):
        tris.append((0, 1 + j, 1 + (j + 1) % nlon))
    for i in range(nlat - 2):
        a, b = 1 + i * nlon, 1 + (i + 1) * nlon
        for j in range(nlon):
            j2 = (j + 1) % nlon
            tris.append((a + j, b + j, b + j2))
            tris.append((a + j, b + j2, a + j2))
    last = 1 + (nlat - 2) * nlon
    for j in range(nlon):
        tris.append((bot, last + (j + 1) % nlon, last + j))
    n_canopy = len(tris)

    # trunk box
    hw, th_ = 0.06 * height, cy
    base = len(verts)
    for sy in (0.0, th_):
        for sx, sz in ((-hw, -hw), (hw, -hw), (hw, hw), (-hw, hw)):
            verts.append((sx, sy, sz))
    quads = [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7),
             (4, 5, 6, 7), (3, 2, 1, 0)]
    for q in quads:
        a, b, c_, d = (base + k for k in q)
        tris.append((a, b, c_))
        tris.append((a, c_, d))

    albedo = np.concatenate([
        np.broadcast_to(np.asarray(canopy_albedo, np.float32),
                        (n_canopy, 3)),
        np.broadcast_to(np.asarray(trunk_albedo, np.float32),
                        (len(tris) - n_canopy, 3))])
    return TriMesh.create(np.asarray(verts, np.float32),
                          np.asarray(tris, np.int32), albedo, device=device)


_REF_TREES = [("Assets/Fbxs/Nature_Tree_0_Up.fbx", 6.0),
              ("Assets/Fbxs/Nature_Tree_1_Leaves.fbx", 7.0)]
# where the JAX package looks for the reference Unity project by default
REFERENCE_ROOT = "/root/reference"


def reference_tree(idx: int, ref_root: str = REFERENCE_ROOT,
                   canopy_albedo=(0.18, 0.32, 0.12),
                   trunk_albedo=(0.3, 0.2, 0.12),
                   device="cuda") -> Optional[TriMesh]:
    """The reference FBX tree idx (the file and normalization of the proxy
    boxes' bake), or None without the reference checkout under ref_root.

    The FBX geometry carries no material, so the albedo is set per triangle
    by its centroid's distance from the trunk axis: leaf cards fan out far
    from the axis, trunk and branches hug it."""
    from volumetricrenderer_tpu_torch.io.fbx import (load_fbx_meshes,
                                                     merge_meshes,
                                                     normalize_mesh)
    rel, height = _REF_TREES[idx % len(_REF_TREES)]
    path = os.path.join(ref_root, rel)
    if not os.path.exists(path):
        return None
    meshes = load_fbx_meshes(path)
    if not meshes:
        return None
    verts, tris = merge_meshes(meshes)
    verts = normalize_mesh(verts, height=height)
    cent = verts[tris].mean(axis=1)                      # [T, 3]
    rad = np.hypot(cent[:, 0], cent[:, 2])
    leafy = (rad > 0.22 * rad.max()) | (cent[:, 1] > 0.55 * height)
    albs = np.where(leafy[:, None],
                    np.asarray(canopy_albedo, np.float32),
                    np.asarray(trunk_albedo, np.float32))
    return TriMesh.create(verts, tris, albs, device=device)


def demo_tree(idx: int, ref_root: str = REFERENCE_ROOT,
              device="cuda") -> TriMesh:
    """reference_tree where the checkout exists, else procedural_tree of the
    same height."""
    m = reference_tree(idx, ref_root, device=device)
    if m is None:
        m = procedural_tree(height=_REF_TREES[idx % len(_REF_TREES)][1],
                            device=device)
    return m
