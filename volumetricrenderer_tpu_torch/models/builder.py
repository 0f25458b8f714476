"""Imperative scene building (`volumetricrenderer_tpu/models/builder.py`).

The reference's registration workflow -- VolumetricLight.OnEnable ->
RegisterLight and VolumetricMaterialVolume -> RegisterMaterialVolume -- for
callers that assemble a scene step by step, adding and removing lights,
media and geometry by handle; `build()` packs them into the struct-of-arrays
Scene the renderer reads, on the camera's device.
"""

from __future__ import annotations

import itertools
from typing import Dict

from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.models.lights import (DirectionalLights,
                                                        PointLights,
                                                        SpotLights)
from volumetricrenderer_tpu_torch.models.media import Medium
from volumetricrenderer_tpu_torch.models.scene import Scene


class SceneBuilder:
    def __init__(self, camera: Camera, ambient=(0.0, 0.0, 0.0)):
        self.camera = camera
        self.ambient = ambient
        self._ids = itertools.count()
        self._dir: Dict[int, dict] = {}
        self._point: Dict[int, dict] = {}
        self._spot: Dict[int, dict] = {}
        self._media: Dict[int, Medium] = {}
        self._planes: Dict[int, tuple] = {}
        self._spheres: Dict[int, tuple] = {}
        self._boxes: Dict[int, tuple] = {}

    # --- lights (RegisterLight / UnregisterLight equivalents) --------------
    def add_directional_light(self, direction, color, intensity,
                              has_shadow=True, shadow_strength=1.0) -> int:
        i = next(self._ids)
        self._dir[i] = dict(direction=direction, color=color,
                            intensity=intensity, has_shadow=has_shadow,
                            shadow_strength=shadow_strength)
        return i

    def add_point_light(self, position, color, intensity, range,
                        intensity_multiplier=1.0, has_shadow=False,
                        shadow_strength=1.0) -> int:
        i = next(self._ids)
        self._point[i] = dict(position=position, color=color,
                              intensity=intensity, range=range,
                              intensity_multiplier=intensity_multiplier,
                              has_shadow=has_shadow,
                              shadow_strength=shadow_strength)
        return i

    def add_spot_light(self, position, direction, color, intensity, range,
                       spot_angle_deg, inner_angle_percent=0.5,
                       intensity_multiplier=1.0, has_shadow=False,
                       shadow_strength=1.0) -> int:
        i = next(self._ids)
        self._spot[i] = dict(position=position, direction=direction,
                             color=color, intensity=intensity, range=range,
                             spot_angle_deg=spot_angle_deg,
                             inner_angle_percent=inner_angle_percent,
                             intensity_multiplier=intensity_multiplier,
                             has_shadow=has_shadow,
                             shadow_strength=shadow_strength)
        return i

    def remove_light(self, light_id: int) -> None:
        for reg in (self._dir, self._point, self._spot):
            reg.pop(light_id, None)

    # --- media (RegisterMaterialVolume equivalents) -------------------------
    def add_medium(self, medium: Medium) -> int:
        i = next(self._ids)
        self._media[i] = medium
        return i

    def remove_medium(self, medium_id: int) -> None:
        self._media.pop(medium_id, None)

    # --- geometry -----------------------------------------------------------
    def add_plane(self, normal, d, albedo=(0.5, 0.5, 0.5)) -> int:
        i = next(self._ids)
        self._planes[i] = (normal, d, albedo)
        return i

    def add_sphere(self, center, radius, albedo=(0.5, 0.5, 0.5)) -> int:
        i = next(self._ids)
        self._spheres[i] = (center, radius, albedo)
        return i

    def add_box(self, box_min, box_max, albedo=(0.5, 0.5, 0.5)) -> int:
        i = next(self._ids)
        self._boxes[i] = (box_min, box_max, albedo)
        return i

    def remove_geometry(self, geo_id: int) -> None:
        for reg in (self._planes, self._spheres, self._boxes):
            reg.pop(geo_id, None)

    # ------------------------------------------------------------------------
    def build(self) -> Scene:
        def soa(reg, keys):
            return {k: [v[k] for v in reg.values()] for k in keys}

        dev = self.camera.position.device
        dir_lights = DirectionalLights.empty(dev)
        if self._dir:
            dir_lights = DirectionalLights.create(**soa(
                self._dir, ("direction", "color", "intensity", "has_shadow",
                            "shadow_strength")), device=dev)
        point_lights = PointLights.empty(dev)
        if self._point:
            point_lights = PointLights.create(**soa(
                self._point, ("position", "color", "intensity", "range",
                              "intensity_multiplier", "has_shadow",
                              "shadow_strength")), device=dev)
        spot_lights = SpotLights.empty(dev)
        if self._spot:
            spot_lights = SpotLights.create(**soa(
                self._spot, ("position", "direction", "color", "intensity",
                             "range", "spot_angle_deg", "inner_angle_percent",
                             "intensity_multiplier", "has_shadow",
                             "shadow_strength")), device=dev)

        geometry = Geometry.create(planes=list(self._planes.values()),
                                   spheres=list(self._spheres.values()),
                                   boxes=list(self._boxes.values()),
                                   device=dev)
        return Scene.create(camera=self.camera, dir_lights=dir_lights,
                            point_lights=point_lights, spot_lights=spot_lights,
                            media=tuple(self._media.values()),
                            geometry=geometry, ambient=self.ambient)
