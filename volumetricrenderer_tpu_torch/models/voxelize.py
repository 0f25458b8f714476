"""Triangle-soup voxelization and box decomposition: the mesh ingestion
bake (`volumetricrenderer_tpu/models/voxelize.py`, copied: numpy, no JAX).

  triangles -> surface-sampled occupancy grid -> greedy box cover

The boxes join the analytic box tables that every shadow ray and kernel
already marches (a per-froxel triangle test is out of the frame's budget);
a canopy is porous at leaf scale, so each box carries the shadow opacity
its voxels measure. This is the plain version of the native core
(native/ingest.cpp, bound by io/native.py), which equals it bit for bit.
All numpy, run once when a scene is built.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def voxelize_triangles(verts: np.ndarray, tris: np.ndarray, res: int = 24,
                       pad: float = 0.02):
    """Surface-sample each triangle at ~half-voxel spacing and mark cells.

    Returns (occ [NX, NY, NZ] bool, origin [3], voxel_size [3]); the grid is
    the mesh AABB padded by `pad` of its diagonal, `res` cells on the longest
    axis (others scale to keep voxels ~cubic)."""
    v = np.asarray(verts, np.float64)
    t = np.asarray(tris, np.int64)
    lo = v.min(axis=0)
    hi = v.max(axis=0)
    diag = float(np.linalg.norm(hi - lo))
    lo = lo - pad * diag
    hi = hi + pad * diag
    ext = hi - lo
    longest = float(ext.max())
    dims = np.maximum((ext / longest * res).astype(int), 1)
    vox = ext / dims
    occ = np.zeros(dims, bool)

    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    # per-triangle sample density: ~2 samples per voxel along the longest edge
    step = float(vox.min()) * 0.5
    emax = np.maximum(np.linalg.norm(b - a, axis=1),
                      np.maximum(np.linalg.norm(c - a, axis=1),
                                 np.linalg.norm(c - b, axis=1)))
    n_per = np.clip((emax / step).astype(int) + 1, 1, 64)
    for n in np.unique(n_per):
        sel = n_per == n
        aa, bb, cc = a[sel], b[sel], c[sel]
        pts = []
        for iu in range(n + 1):
            u = iu / n if n else 0.0
            for iw in range(n + 1 - iu):
                w = iw / n if n else 0.0
                pts.append(aa * (1.0 - u - w) + bb * u + cc * w)
        p = np.concatenate(pts, axis=0)
        idx = np.clip(((p - lo) / vox).astype(int), 0, dims - 1)
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
    return occ, lo.astype(np.float32), vox.astype(np.float32)


def boxes_from_occupancy(occ: np.ndarray, origin: np.ndarray,
                         voxel: np.ndarray, max_boxes: int = 8,
                         fill_thresh: float = 0.35,
                         coverage: float = 0.92) -> List[Tuple[np.ndarray,
                                                               np.ndarray]]:
    """Greedy box cover of an occupancy grid -> [(bmin, bmax, opacity), ...].

    Each box seeds at the densest remaining cell (3-cell box-filtered count)
    and grows one face at a time while the added slab is at least fill_thresh
    occupied — deliberately over-approximating porous regions (foliage).
    Stops at max_boxes or when `coverage` of the occupied cells are inside
    some box."""
    occ = occ.copy()
    total = int(occ.sum())
    if total == 0:
        return []
    covered = np.zeros_like(occ)
    boxes = []
    dims = np.asarray(occ.shape)

    def density(o):
        p = np.pad(o.astype(np.float32), 1)
        s = np.zeros_like(o, np.float32)
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    s += p[dx:dx + o.shape[0], dy:dy + o.shape[1],
                           dz:dz + o.shape[2]]
        return s

    remaining = occ.copy()
    while len(boxes) < max_boxes and \
            int((occ & covered).sum()) < coverage * total and remaining.any():
        seed = np.unravel_index(np.argmax(density(remaining)), occ.shape)
        b0 = np.asarray(seed)
        b1 = b0 + 1
        grew = True
        while grew:
            grew = False
            for axis in range(3):
                for sign in (-1, 1):
                    n0, n1 = b0.copy(), b1.copy()
                    if sign < 0:
                        if n0[axis] == 0:
                            continue
                        n0[axis] -= 1
                        slab = (slice(n0[0], n1[0]), slice(n0[1], n1[1]),
                                slice(n0[2], n1[2]))
                        sl = list(slab)
                        sl[axis] = slice(n0[axis], n0[axis] + 1)
                    else:
                        if n1[axis] == dims[axis]:
                            continue
                        n1[axis] += 1
                        sl = [slice(n0[0], n1[0]), slice(n0[1], n1[1]),
                              slice(n0[2], n1[2])]
                        sl[axis] = slice(n1[axis] - 1, n1[axis])
                    frac = occ[tuple(sl)].mean()
                    if frac >= fill_thresh:
                        b0, b1 = n0, n1
                        grew = True
        sl = (slice(b0[0], b1[0]), slice(b0[1], b1[1]), slice(b0[2], b1[2]))
        covered[sl] = True
        remaining[sl] = False
        # shadow opacity estimate: the fraction of axis-parallel rays through
        # the box that hit an occupied voxel, averaged over the 3 axes — the
        # average transmittance loss of a ray crossing this (porous) box.
        # Trunks/solid shells measure ~1; leaf canopies their coverage. Feeds
        # Geometry.box_opacity (alpha-tested-foliage stand-in, SPEC
        # "Occluder opacity").
        sub = occ[sl]
        opacity = float(np.mean([sub.any(axis=a).mean() for a in range(3)]))
        boxes.append((origin + b0 * voxel, origin + b1 * voxel, opacity))
    return boxes


def mesh_to_boxes(verts: np.ndarray, tris: np.ndarray, res: int = 20,
                  max_boxes: int = 8, fill_thresh: float = 0.35):
    """Convenience: triangles -> occupancy -> world-space boxes."""
    occ, origin, vox = voxelize_triangles(verts, tris, res)
    return boxes_from_occupancy(occ, origin, vox, max_boxes=max_boxes,
                                fill_thresh=fill_thresh)


def transform_boxes(boxes, scale: float = 1.0, translate=(0.0, 0.0, 0.0),
                    yaw: float = 0.0):
    """Instance a box list: uniform scale, yaw about +y (in 90-degree steps
    boxes stay axis-aligned; other angles use the rotated AABB), translate."""
    t = np.asarray(translate, np.float32)
    out = []
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    for box in boxes:
        bmin, bmax = box[0], box[1]
        corners = np.asarray([[x, y, z]
                              for x in (bmin[0], bmax[0])
                              for y in (bmin[1], bmax[1])
                              for z in (bmin[2], bmax[2])], np.float32)
        corners = corners * scale @ rot.T + t
        out.append((corners.min(axis=0), corners.max(axis=0))
                   + tuple(box[2:]))                 # opacity rides along
    return out
