"""Shadow maps: cascade fitting, map bakes and their froxel-space samplers.

Counterpart of `volumetricrenderer_tpu/shadow.py`, in plain torch on the
tensors' device. The renderer owns the shadow state that Unity's shadow pass
would hand the reference (VolumetricHelper.hlsl:196-259):

- `fit_cascades`: Unity's split-sphere cascade fit (a sphere per frustum
  slice on the camera axis) with texel snapping;
- `bake_dir_shadows` (a 2x2 cascade atlas per sun), `bake_cube_shadows` (six
  linear-distance faces per point light), `bake_spot_shadows` (one
  perspective map per spot), each by analytic ray casting
  (ops/raycast.intersect);
- `sample_dir_shadow` (split-sphere one-hot cascade pick, blended atlas
  coordinates, a 1-tap hardware PCF emulated as 4 point compares weighted
  bilinearly, lerp to the shadow strength), `sample_cube_shadow` (dominant
  axis face select and bias) and `sample_spot_shadow`.

The dot products that feed a depth compare are explicit three-term sums
(`froxel.dot3`), as in the JAX package: the compare depths cannot afford
another rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from volumetricrenderer_tpu_torch.froxel import dot3
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.models.scene import _to
from volumetricrenderer_tpu_torch.ops import raycast


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot3(v, v))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


# --------------------------------------------------------------------------
# Data
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DirShadowData:
    """Cascaded shadow state of the directional lights (leading axis =
    light)."""
    atlas: torch.Tensor            # [N, 2S, 2S] depth in [0, 1]; 1 = none
    world_to_uv: torch.Tensor      # [N, C, 3, 4] world -> (u, v, z), atlas
    split_spheres: torch.Tensor    # [N, C, 3]
    split_sq_radii: torch.Tensor   # [N, C]
    strength_r: torch.Tensor       # [N] 1 - shadow_strength
    bias: torch.Tensor             # [N] normalized-depth bias
    # baked in the camera-aligned light basis (u independent of froxel y):
    # the precondition of the cascaded-PCF kernel (ops/pcf_shadow.py)
    aligned: bool = False

    def to(self, device) -> "DirShadowData":
        return _to(self, torch.device(device))


@dataclasses.dataclass(frozen=True)
class CubeShadowData:
    faces: torch.Tensor            # [N, 6, S, S] axis distance / range
    light_pos: torch.Tensor        # [N, 3]
    range: torch.Tensor            # [N]
    strength_r: torch.Tensor       # [N]
    bias: torch.Tensor             # [N] world-units bias on the major axis

    def to(self, device) -> "CubeShadowData":
        return _to(self, torch.device(device))


@dataclasses.dataclass(frozen=True)
class SpotShadowData:
    maps: torch.Tensor             # [N, S, S] axial distance / range
    light_pos: torch.Tensor        # [N, 3]
    axes: torch.Tensor             # [N, 3, 3] rows (lx, ly, lz)
    tan_half_angle: torch.Tensor   # [N]
    range: torch.Tensor            # [N]
    strength_r: torch.Tensor       # [N]
    bias: torch.Tensor             # [N] normalized-depth bias

    def to(self, device) -> "SpotShadowData":
        return _to(self, torch.device(device))


def _light_basis(direction: torch.Tensor, align_up=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Orthonormal basis (lx, ly, lz) with lz = direction. With align_up
    (the camera's up axis), lx = normalize(lz x align_up): the froxel ->
    atlas u coordinate then depends on froxel x only, per slice, which the
    cascaded-PCF kernel needs; a light along align_up takes lz x (1, 0, 0).
    Without it, Unity's fixed basis from the world up (or x near the
    poles)."""
    dev = direction.device
    lz = direction / _norm(direction)
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=dev)
    if align_up is not None:
        lx = _cross(lz, align_up)
        n = _norm(lx)
        fallback = _cross(lz, x_axis)
        lx = torch.where(n > 1e-5, lx / torch.clamp(n, min=1e-9),
                         fallback / torch.clamp(_norm(fallback), min=1e-9))
        return lx, _cross(lz, lx), lz
    up = x_axis if bool(torch.abs(lz[1]) > 0.99) \
        else torch.tensor([0.0, 1.0, 0.0], device=dev)
    lx = _cross(up, lz)
    lx = lx / _norm(lx)
    return lx, _cross(lz, lx), lz


# --------------------------------------------------------------------------
# Cascade fitting and bakes
# --------------------------------------------------------------------------

def fit_cascades(camera_pos, camera_forward, fov_y, aspect, near,
                 shadow_distance: float, splits: Tuple[float, ...]):
    """Enclosing sphere per frustum slice, centred on the camera axis:
    (centres [C, 3], radii [C]). splits are cumulative end fractions of
    shadow_distance."""
    tan_y = torch.tan(fov_y / 2.0)
    tan_x = tan_y * aspect
    k2 = tan_x * tan_x + tan_y * tan_y
    centers, radii = [], []
    prev = near
    for frac in splits:
        f = near + (shadow_distance - near) * frac
        n = prev
        # rho(n)^2 + (n - c)^2 = rho(f)^2 + (f - c)^2 for the axis offset c
        c = ((f * f - n * n) * (1.0 + k2)) / (2.0 * (f - n))
        c = torch.minimum(torch.maximum(c, n), f)
        r = torch.sqrt(f * f * k2 + (f - c) * (f - c))
        centers.append(camera_pos + camera_forward * c)
        radii.append(r)
        prev = f
    return torch.stack(centers), torch.stack(radii)


def _texel_grid(s: int, device):
    u = (torch.arange(s, dtype=torch.float32, device=device) + 0.5) / s
    vv, uu = torch.meshgrid(u, u, indexing="ij")
    return uu, vv


def bake_dir_shadows(geom: Geometry, directions, strengths, camera_pos,
                     camera_forward, fov_y, aspect, near,
                     shadow_distance: float, splits, map_size: int,
                     bias: float = 2e-3, align_up=None) -> DirShadowData:
    """The 2x2 cascade atlas of each directional light. align_up (the
    camera's up axis) bakes in the camera-aligned basis that the
    cascaded-PCF kernel needs."""
    dev = directions.device
    num_c = len(splits)
    s = map_size
    centers, radii = fit_cascades(camera_pos, camera_forward, fov_y, aspect,
                                  near, shadow_distance, splits)
    uu, vv = _texel_grid(s, dev)
    atlases, mats = [], []
    for li in range(directions.shape[0]):
        lx, ly, lz = _light_basis(directions[li], align_up)
        quads, lmats = [], []
        for ci in range(num_c):
            r = radii[ci]
            # snap the sphere centre to texels in light space
            texel = 2.0 * r / s
            cx = torch.floor(dot3(centers[ci], lx) / texel) * texel
            cy = torch.floor(dot3(centers[ci], ly) / texel) * texel
            cz = dot3(centers[ci], lz)
            center = lx * cx + ly * cy + lz * cz
            backup = 2.0 * r + 10.0     # the shadow camera behind occluders
            origin = center - lz * backup
            zfar = backup + 2.0 * r
            starts = (origin[None, None, :]
                      + lx * ((2.0 * uu - 1.0) * r)[..., None]
                      + ly * ((2.0 * vv - 1.0) * r)[..., None])
            t, _, _ = raycast.intersect(geom, starts,
                                        lz.expand(starts.shape))
            quads.append(torch.minimum(t, zfar) / zfar)
            # world -> (u, v, z) in this cascade's quadrant of the atlas
            qx, qy = ci % 2, ci // 2
            row_u = torch.cat([lx / (4.0 * r), ((-dot3(origin, lx))
                                                / (4.0 * r) + 0.25
                                                + 0.5 * qx)[None]])
            row_v = torch.cat([ly / (4.0 * r), ((-dot3(origin, ly))
                                                / (4.0 * r) + 0.25
                                                + 0.5 * qy)[None]])
            row_z = torch.cat([lz / zfar, ((-dot3(origin, lz)) / zfar)[None]])
            lmats.append(torch.stack([row_u, row_v, row_z]))
        atlas = torch.cat(quads[0:2], dim=1)
        if num_c > 2:
            atlas = torch.cat([atlas, torch.cat(quads[2:4], dim=1)], dim=0)
        atlases.append(atlas)
        mats.append(torch.stack(lmats))
    n = directions.shape[0]
    return DirShadowData(
        atlas=torch.stack(atlases), world_to_uv=torch.stack(mats),
        split_spheres=centers.expand(n, num_c, 3).contiguous(),
        split_sq_radii=(radii * radii).expand(n, num_c).contiguous(),
        strength_r=1.0 - strengths,
        bias=torch.full((n,), bias, dtype=torch.float32, device=dev),
        aligned=align_up is not None)


def bake_cube_shadows(geom: Geometry, positions, ranges, strengths,
                      map_size: int, bias: float = 5e-2) -> CubeShadowData:
    """Six faces per point light; face 2k is +axis k, 2k+1 is -axis k.
    Texel (u, v) of face (k, sign) casts dir[k] = sign, dir[b] = 2u - 1,
    dir[c] = 2v - 1 with (b, c) the other axes ascending, so the hit t is
    the distance along the major axis."""
    dev = positions.device
    uu, vv = _texel_grid(map_size, dev)
    cu, cv = 2.0 * uu - 1.0, 2.0 * vv - 1.0
    all_faces = []
    for li in range(positions.shape[0]):
        faces = []
        for axis in range(3):
            b, c = [a for a in range(3) if a != axis]
            for sign in (1.0, -1.0):
                comps = [None, None, None]
                comps[axis] = torch.full_like(cu, sign)
                comps[b] = cu
                comps[c] = cv
                dirs = torch.stack(comps, dim=-1)
                t, _, _ = raycast.intersect(
                    geom, positions[li].expand(dirs.shape), dirs)
                faces.append(torch.minimum(t, ranges[li]) / ranges[li])
        all_faces.append(torch.stack(faces))
    n = positions.shape[0]
    return CubeShadowData(
        faces=torch.stack(all_faces), light_pos=positions, range=ranges,
        strength_r=1.0 - strengths,
        bias=torch.full((n,), bias, dtype=torch.float32, device=dev))


def bake_spot_shadows(geom: Geometry, positions, directions, spot_angles,
                      ranges, strengths, map_size: int,
                      bias: float = 2e-3) -> SpotShadowData:
    """One perspective map per spot light, storing axial distance / range."""
    dev = positions.device
    uu, vv = _texel_grid(map_size, dev)
    maps, axes, tans = [], [], []
    for li in range(positions.shape[0]):
        lx, ly, lz = _light_basis(directions[li])
        tan = torch.tan(spot_angles[li] / 2.0)
        dirs = (lz[None, None, :]
                + lx * ((2.0 * uu - 1.0) * tan)[..., None]
                + ly * ((2.0 * vv - 1.0) * tan)[..., None])
        t, _, _ = raycast.intersect(geom, positions[li].expand(dirs.shape),
                                    dirs)
        maps.append(torch.minimum(t, ranges[li]) / ranges[li])
        axes.append(torch.stack([lx, ly, lz]))
        tans.append(tan)
    n = positions.shape[0]
    return SpotShadowData(
        maps=torch.stack(maps), light_pos=positions, axes=torch.stack(axes),
        tan_half_angle=torch.stack(tans), range=ranges,
        strength_r=1.0 - strengths,
        bias=torch.full((n,), bias, dtype=torch.float32, device=dev))


# --------------------------------------------------------------------------
# Sampling
# --------------------------------------------------------------------------

def _bilinear_compare(flat: torch.Tensor, base, h: int, w: int, x, y,
                      ref) -> torch.Tensor:
    """4 point compares (lit = ref <= stored) of the texels around texel
    coordinate (x, y) of the [h, w] map starting at `base` in `flat`,
    weighted bilinearly; taps clamp to the map's edge."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(dy, dx):
        yi = torch.clamp(y0 + dy, 0, h - 1)
        xi = torch.clamp(x0 + dx, 0, w - 1)
        return (ref <= flat[base + yi * w + xi]).to(torch.float32)

    return (tap(0, 0) * (1 - fy) * (1 - fx) + tap(0, 1) * (1 - fy) * fx
            + tap(1, 0) * fy * (1 - fx) + tap(1, 1) * fy * fx)


def _pcf_compare_2d(tex: torch.Tensor, u, v, ref) -> torch.Tensor:
    """Hardware SampleCmp: the bilinear compare of tex [H, W] at u, v in
    [0, 1]."""
    h, w = tex.shape
    return _bilinear_compare(tex.reshape(-1), 0, h, w, u * w - 0.5,
                             v * h - 0.5, ref)


def cascade_weights_split_spheres(world_pos: torch.Tensor,
                                  spheres: torch.Tensor,
                                  sq_radii: torch.Tensor) -> torch.Tensor:
    """GetCascadeWeights_SplitSpheres: world_pos [..., 3], spheres [C, 3],
    sq_radii [C] -> one-hot weights [..., C] (inside cascade c and not
    inside c - 1)."""
    diff = world_pos[..., None, :] - spheres
    d2 = torch.sum(diff * diff, dim=-1)
    inside = (d2 < sq_radii).to(torch.float32)
    shifted = torch.cat([torch.zeros_like(inside[..., :1]),
                         inside[..., :-1]], dim=-1)
    return torch.clamp(inside - shifted, 0.0, 1.0)


def sample_dir_shadow(data: DirShadowData, light_idx: int,
                      world_pos: torch.Tensor) -> torch.Tensor:
    """SampleDirShadow: world_pos [..., 3] -> visibility [...]."""
    weights = cascade_weights_split_spheres(
        world_pos, data.split_spheres[light_idx],
        data.split_sq_radii[light_idx])
    mats = data.world_to_uv[light_idx]                  # [C, 3, 4]
    # the per-cascade coordinates blended with the one-hot weights
    coord = 0.0
    for ci in range(mats.shape[0]):
        m = mats[ci]
        c = torch.stack([dot3(world_pos, m[0, :3]) + m[0, 3],
                         dot3(world_pos, m[1, :3]) + m[1, 3],
                         dot3(world_pos, m[2, :3]) + m[2, 3]], dim=-1)
        coord = coord + c * weights[..., ci, None]
    # outside every cascade the blended coordinate is 0: fully lit
    any_cascade = torch.sum(weights, dim=-1) > 0.0
    cmp = _pcf_compare_2d(data.atlas[light_idx], coord[..., 0],
                          coord[..., 1], coord[..., 2] - data.bias[light_idx])
    cmp = torch.where(any_cascade, cmp, torch.ones_like(cmp))
    sr = data.strength_r[light_idx]
    return sr + (1.0 - sr) * cmp


def sample_cube_shadow(data: CubeShadowData, light_idx: int,
                       vec: torch.Tensor) -> torch.Tensor:
    """SamplePointShadow: vec = world position - light position [..., 3]
    -> visibility [...]."""
    av = torch.abs(vec)
    dominant = torch.maximum(torch.maximum(av[..., 0], av[..., 1]),
                             av[..., 2])
    mydist = torch.clamp(dominant - data.bias[light_idx], min=1e-5) \
        / data.range[light_idx]
    x_is = (av[..., 0] >= av[..., 1]) & (av[..., 0] >= av[..., 2])
    y_is = (~x_is) & (av[..., 1] >= av[..., 2])
    axis = torch.where(x_is, 0, torch.where(y_is, 1, 2))
    comp = torch.gather(vec, -1, axis[..., None])[..., 0]
    face = axis * 2 + (comp < 0.0).to(torch.int64)
    dom = torch.clamp(dominant, min=1e-9)
    u = torch.zeros_like(dominant)
    v = torch.zeros_like(dominant)
    for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
        sel = axis == a
        u = torch.where(sel, vec[..., b] / dom, u)
        v = torch.where(sel, vec[..., c] / dom, v)
    u = 0.5 * (u + 1.0)
    v = 0.5 * (v + 1.0)
    s = data.faces.shape[-1]
    cmp = _bilinear_compare(data.faces[light_idx].reshape(-1), face * s * s,
                            s, s, u * s - 0.5, v * s - 0.5, mydist)
    sr = data.strength_r[light_idx]
    return sr + (1.0 - sr) * cmp


def sample_spot_shadow(data: SpotShadowData, light_idx: int,
                       world_pos: torch.Tensor) -> torch.Tensor:
    """SampleSpotShadow: the perspective map through the light's frame;
    lit = axial / range <= stored."""
    rel = world_pos - data.light_pos[light_idx]
    lx, ly, lz = data.axes[light_idx]
    axial = dot3(rel, lz)
    safe_axial = torch.clamp(axial, min=1e-5)
    tan = data.tan_half_angle[light_idx]
    u = 0.5 * (dot3(rel, lx) / (safe_axial * tan) + 1.0)
    v = 0.5 * (dot3(rel, ly) / (safe_axial * tan) + 1.0)
    ref = axial / data.range[light_idx] - data.bias[light_idx]
    cmp = _pcf_compare_2d(data.maps[light_idx], u, v, ref)
    cmp = torch.where(axial > 0.0, cmp, torch.ones_like(cmp))
    sr = data.strength_r[light_idx]
    return sr + (1.0 - sr) * cmp
