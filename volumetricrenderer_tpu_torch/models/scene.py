"""Scene container and the scene presets
(`volumetricrenderer_tpu/models/scene.py`): the reference demo scene and
the benchmark scene."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.models.lights import (DirectionalLights,
                                                        PointLights,
                                                        SpotLights)
from volumetricrenderer_tpu_torch.models.media import Medium
from volumetricrenderer_tpu_torch.models.mesh import TriMesh


@dataclasses.dataclass(frozen=True)
class Scene:
    camera: Camera
    dir_lights: DirectionalLights
    point_lights: PointLights
    spot_lights: SpotLights
    media: Tuple[Medium, ...]
    geometry: Geometry
    ambient: torch.Tensor         # [3]
    # a triangle-soup environment, rasterized into the G-buffer
    # (ops/raster.py) and depth-composited over the analytic ray cast; its
    # shadow comes from the geometry's proxy boxes
    mesh: Optional[TriMesh] = None

    @staticmethod
    def create(camera, dir_lights=None, point_lights=None, spot_lights=None,
               media=(), geometry=None, ambient=(0.0, 0.0, 0.0),
               mesh=None) -> "Scene":
        """A scene on the camera's device; the parts left out are empty."""
        dev = camera.position.device
        return Scene(
            camera=camera,
            dir_lights=dir_lights if dir_lights is not None
            else DirectionalLights.empty(dev),
            point_lights=point_lights if point_lights is not None
            else PointLights.empty(dev),
            spot_lights=spot_lights if spot_lights is not None
            else SpotLights.empty(dev),
            media=tuple(media),
            geometry=geometry if geometry is not None
            else Geometry.empty(dev),
            ambient=torch.as_tensor(ambient, dtype=torch.float32,
                                    device=dev),
            mesh=mesh)

    def to(self, device) -> "Scene":
        """The same scene with every tensor on `device`."""
        return _to(self, torch.device(device))


def _to(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_to(o, device) for o in obj)
    return obj


def tensor_marks(obj) -> tuple:
    """(version counter, data pointer) of every tensor in `obj`, a tree of
    dataclasses and tuples, in field order: a mark changes when its tensor
    is edited in place or given new storage."""
    marks = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            marks.append((o._version, o.data_ptr()))
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, tuple):
            for v in o:
                walk(v)

    walk(obj)
    return tuple(marks)


def _euler_forward(pitch_deg: float, yaw_deg: float
                   ) -> Tuple[float, float, float]:
    """Unity transform.forward for euler (pitch, yaw, 0)."""
    p = math.radians(pitch_deg)
    y = math.radians(yaw_deg)
    return (math.cos(p) * math.sin(y), -math.sin(p), math.cos(p) * math.cos(y))


def demo_scene(aspect: float = 16.0 / 9.0, with_noise: bool = False,
               noise_tex=None, mesh_env: bool = False,
               device="cuda") -> Scene:
    """The reference demo scene (Unity's VolumetricRenderer.unity): the
    camera at (-0.4, 1.9, -15.8) looking +z, the sun at euler (50, -30)
    with a volumetric shadow, one red spot light, constant white fog, and
    the environment prefab as analytic primitives (ground plane, three
    cubes, a sphere) over a procedural heightfield (amp 2.0, base -0.3).
    with_noise gives the fog the noise texture noise_tex [Nz, Ny, Nx]
    (ops/noise.perlin_texture_3d; None: no noise, as in the JAX package).

    The prefab's three trees: mesh_env=False, a canopy sphere and a trunk
    box each; mesh_env=True, the reference's tree meshes
    (models/mesh.demo_tree: the FBX files where the reference checkout
    exists, else the procedural tree) as the scene's TriMesh, which the
    G-buffer rasterizes, and their voxelized boxes (models/tree_assets.py,
    20 boxes of opacity below 1) as shadow-only proxies that every shadow
    ray sees and primary rays skip (n_proxy_boxes)."""
    camera = Camera.create(position=(-0.4, 1.9, -15.8),
                           forward=(0.0, 0.0, 1.0), fov_y_deg=60.0,
                           aspect=aspect, near=0.3, far=100.0, device=device)
    sun = DirectionalLights.create(
        direction=[_euler_forward(50.0, -30.0)], color=[(0.99, 0.96, 0.80)],
        intensity=[2.5], has_shadow=[True], shadow_strength=[1.0],
        device=device)
    spot = SpotLights.create(
        position=[(-16.08, 5.0, 17.61)],
        direction=[_euler_forward(29.709, -251.452)],
        color=[(1.0, 0.0, 0.0)], intensity=[6.0], range=[34.42],
        spot_angle_deg=[66.0], inner_angle_percent=[0.5],
        intensity_multiplier=[1.0], has_shadow=[True],
        shadow_strength=[1.0], device=device)
    point = PointLights.create(np.zeros((0, 3)), np.zeros((0, 3)), [], [],
                               device=device)
    fog = Medium.create(
        scattering_color=(1.0, 1.0, 1.0), absorption=0.19, phase_g=0.3,
        noise_tex=noise_tex if with_noise else None,
        noise_scroll=(10.0, 0.0, 0.0), noise_tiling=(0.01, 0.01, 0.01),
        device=device)
    trees = [(-9.0, 18.0), (7.0, 9.0), (-14.0, 25.0)]
    mesh = None
    if mesh_env:
        from volumetricrenderer_tpu_torch.models.mesh import (concat_meshes,
                                                              demo_tree,
                                                              transform_mesh)
        from volumetricrenderer_tpu_torch.models.tree_assets import (TREE_0,
                                                                     TREE_1)
        from volumetricrenderer_tpu_torch.models.voxelize import \
            transform_boxes
        leaf = (0.18, 0.32, 0.12)
        tree_spheres = []
        tree_boxes = []
        insts = []
        for i, (x, z) in enumerate(trees):
            place = dict(scale=0.55 if i % 2 else 0.5, translate=(x, 0.0, z),
                         yaw=i * math.pi / 2)
            # opacity below 1: a porous canopy, whose shadow rays keep
            # 1 - opacity of their light
            tree_boxes += [(tuple(bm), tuple(bx), leaf, op) for bm, bx, op
                           in transform_boxes(TREE_0 if i % 2 == 0
                                              else TREE_1, **place)]
            # the same transform for the triangles, so that the visible
            # mesh and its shadow proxies stay aligned
            insts.append(transform_mesh(demo_tree(i % 2, device=device),
                                        **place))
        mesh = concat_meshes(insts)
    else:
        tree_spheres = [((x, 3.2, z), 1.6, (0.18, 0.32, 0.12))
                        for x, z in trees]
        tree_boxes = [((x - 0.25, 0.0, z - 0.25), (x + 0.25, 2.4, z + 0.25),
                       (0.3, 0.2, 0.12)) for x, z in trees]
    geometry = Geometry.create(
        planes=[((0.0, 1.0, 0.0), 0.0, (0.22, 0.26, 0.18))],
        spheres=[((4.0, 1.5, 6.0), 1.5, (0.6, 0.55, 0.5))] + tree_spheres,
        boxes=[((-6.0, 0.0, 2.0), (-4.0, 2.0, 4.0), (0.5, 0.45, 0.4)),
               ((2.0, 0.0, 14.0), (5.0, 4.0, 17.0), (0.45, 0.5, 0.45)),
               ((-12.0, 0.0, 10.0), (-10.0, 6.0, 12.0), (0.35, 0.4, 0.3))]
        + tree_boxes,
        n_proxy_boxes=len(tree_boxes) if mesh_env else 0,
        heightfield=dict(amp=2.0, base=-0.3, tiling=(0.03, 0.03),
                         offset=(0.0, 0.0), albedo=(0.24, 0.28, 0.18)),
        device=device)
    return Scene(camera=camera, dir_lights=sun, point_lights=point,
                 spot_lights=spot, media=(fog,), geometry=geometry,
                 ambient=torch.tensor((0.08, 0.09, 0.11), dtype=torch.float32,
                                      device=device), mesh=mesh)


def benchmark_scene(aspect: float = 16.0 / 9.0, num_local_lights: int = 16,
                    noise_tex=None, noise_mode: str = "texture",
                    device="cuda") -> Scene:
    """One sun, num_local_lights point/spot lights, a fog medium and a ground
    fog box. The fog's noise: noise_mode="procedural" (the production path)
    evaluates the fBm; "texture" samples noise_tex [Nz, Ny, Nx]
    (ops/noise.perlin_texture_3d: bench.py's texture frame), and without a
    texture carries no noise at all, as in the JAX package."""
    camera = Camera.create(position=(-0.4, 1.9, -15.8),
                           forward=(0.0, 0.0, 1.0), fov_y_deg=60.0,
                           aspect=aspect, near=0.3, far=100.0, device=device)
    sun = DirectionalLights.create(
        direction=[_euler_forward(50.0, -30.0)], color=[(0.99, 0.96, 0.80)],
        intensity=[2.5], has_shadow=[True], shadow_strength=[1.0],
        device=device)

    n_point = num_local_lights // 2
    n_spot = num_local_lights - n_point
    rng = np.linspace(0.0, 2.0 * np.pi, n_point, endpoint=False)
    point = PointLights.create(
        position=np.stack([20.0 * np.cos(rng), np.full_like(rng, 3.0),
                           20.0 * np.sin(rng) + 10.0], axis=-1),
        color=np.stack([0.5 + 0.5 * np.cos(rng), np.full_like(rng, 0.4),
                        0.5 + 0.5 * np.sin(rng)], axis=-1),
        intensity=np.full((n_point,), 7.0), range=np.full((n_point,), 30.0),
        has_shadow=[True] * n_point, device=device)

    rng2 = np.linspace(0.0, 2.0 * np.pi, n_spot, endpoint=False)
    spot = SpotLights.create(
        position=np.stack([15.0 * np.sin(rng2), np.full_like(rng2, 6.0),
                           15.0 * np.cos(rng2) + 15.0], axis=-1),
        direction=np.tile(np.asarray([(0.3, -0.9, 0.3)]), (n_spot, 1)),
        color=np.stack([np.full_like(rng2, 1.0), 0.5 + 0.5 * np.cos(rng2),
                        np.full_like(rng2, 0.2)], axis=-1),
        intensity=np.full((n_spot,), 6.0), range=np.full((n_spot,), 34.42),
        spot_angle_deg=np.full((n_spot,), 66.0),
        has_shadow=[True] * n_spot, device=device)

    fog = Medium.create(
        scattering_color=(1.0, 1.0, 1.0), absorption=0.19, phase_g=0.3,
        noise_tex=noise_tex, noise_mode=noise_mode,
        noise_scroll=(10.0, 0.0, 0.0),
        noise_tiling=(0.01, 0.01, 0.01), height_falloff=0.05,
        height_base=0.0, device=device)
    ground_fog = Medium.create(
        scattering_color=(0.8, 0.9, 1.0), absorption=0.3, phase_g=0.5,
        volume_type="box", blend_type="additive",
        box_min=(-30.0, 0.0, -20.0), box_max=(30.0, 4.0, 40.0),
        box_softness=1.0, device=device)

    geometry = Geometry.create(
        planes=[((0.0, 1.0, 0.0), 0.0, (0.22, 0.26, 0.18))],
        spheres=[((4.0, 1.5, 6.0), 1.5, (0.6, 0.55, 0.5)),
                 ((-8.0, 2.0, 20.0), 2.0, (0.5, 0.5, 0.6))],
        boxes=[((-6.0, 0.0, 2.0), (-4.0, 2.0, 4.0), (0.5, 0.45, 0.4)),
               ((2.0, 0.0, 14.0), (5.0, 4.0, 17.0), (0.45, 0.5, 0.45)),
               ((-12.0, 0.0, 10.0), (-10.0, 6.0, 12.0), (0.35, 0.4, 0.3)),
               ((8.0, 0.0, 25.0), (12.0, 8.0, 28.0), (0.4, 0.4, 0.45))],
        device=device)

    return Scene(camera=camera, dir_lights=sun, point_lights=point,
                 spot_lights=spot, media=(fog, ground_fog), geometry=geometry,
                 ambient=torch.tensor((0.08, 0.09, 0.11), dtype=torch.float32,
                                      device=device))
