"""Light models, struct-of-arrays with static counts (tensors on one device).

Field semantics as in `volumetricrenderer_tpu/models/lights.py`: the colour
is uploaded as pow(color * intensity, 2.2) (`packed_color`), the spot cone
terms are cos(angle/2) and 1/cos(inner_percent * angle/2), and
`shadow_strength` enters as 1 - strength.
"""

from __future__ import annotations

import dataclasses

import torch


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _bool(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.bool, device=device)


def gamma22(color_times_intensity: torch.Tensor) -> torch.Tensor:
    """pow 2.2 of color * intensity, applied before upload (reference)."""
    return torch.pow(torch.clamp(color_times_intensity, min=0.0), 2.2)


def _empty(cls, device):
    """cls with N = 0: [0, 3] for the position, direction and colour
    fields, has_shadow bool [0], every other field [0]."""
    return cls(**{f.name: torch.zeros(
        (0, 3) if f.name in ("position", "direction", "color") else (0,),
        dtype=torch.bool if f.name == "has_shadow" else torch.float32,
        device=device) for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class DirectionalLights:
    direction: torch.Tensor         # [N, 3] unit, pointing from the light
    color: torch.Tensor             # [N, 3]
    intensity: torch.Tensor         # [N]
    has_shadow: torch.Tensor        # [N] bool
    shadow_strength: torch.Tensor   # [N]

    @property
    def count(self) -> int:
        return self.direction.shape[0]

    @property
    def packed_color(self) -> torch.Tensor:
        return gamma22(self.color * self.intensity[:, None])

    @staticmethod
    def empty(device="cuda") -> "DirectionalLights":
        """No lights: every field with its shape at N = 0."""
        return _empty(DirectionalLights, device)

    @staticmethod
    def create(direction, color, intensity, has_shadow=None,
               shadow_strength=None, device="cuda") -> "DirectionalLights":
        d = _f32(direction, device).reshape(-1, 3)
        n = d.shape[0]
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return DirectionalLights(
            direction=d,
            color=_f32(color, device).reshape(n, 3),
            intensity=_f32(intensity, device).reshape(n),
            has_shadow=_bool(has_shadow if has_shadow is not None
                             else [True] * n, device).reshape(n),
            shadow_strength=_f32(shadow_strength if shadow_strength is not None
                                 else [1.0] * n, device).reshape(n),
        )


@dataclasses.dataclass(frozen=True)
class PointLights:
    position: torch.Tensor              # [N, 3]
    color: torch.Tensor                 # [N, 3]
    intensity: torch.Tensor             # [N]
    range: torch.Tensor                 # [N]
    intensity_multiplier: torch.Tensor  # [N]
    has_shadow: torch.Tensor            # [N] bool
    shadow_strength: torch.Tensor       # [N]

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @property
    def packed_color(self) -> torch.Tensor:
        return gamma22(self.color * self.intensity[:, None])

    @staticmethod
    def empty(device="cuda") -> "PointLights":
        """No lights: every field with its shape at N = 0."""
        return _empty(PointLights, device)

    @staticmethod
    def create(position, color, intensity, range, intensity_multiplier=None,
               has_shadow=None, shadow_strength=None,
               device="cuda") -> "PointLights":
        p = _f32(position, device).reshape(-1, 3)
        n = p.shape[0]
        return PointLights(
            position=p,
            color=_f32(color, device).reshape(n, 3),
            intensity=_f32(intensity, device).reshape(n),
            range=_f32(range, device).reshape(n),
            intensity_multiplier=_f32(
                intensity_multiplier if intensity_multiplier is not None
                else [1.0] * n, device).reshape(n),
            has_shadow=_bool(has_shadow if has_shadow is not None
                             else [False] * n, device).reshape(n),
            shadow_strength=_f32(shadow_strength if shadow_strength is not None
                                 else [1.0] * n, device).reshape(n),
        )


@dataclasses.dataclass(frozen=True)
class SpotLights:
    position: torch.Tensor              # [N, 3]
    direction: torch.Tensor             # [N, 3] unit
    color: torch.Tensor                 # [N, 3]
    intensity: torch.Tensor             # [N]
    range: torch.Tensor                 # [N]
    spot_angle: torch.Tensor            # [N] full outer cone angle, radians
    inner_angle_percent: torch.Tensor   # [N] in [0, 1]
    intensity_multiplier: torch.Tensor  # [N]
    has_shadow: torch.Tensor            # [N] bool
    shadow_strength: torch.Tensor       # [N]

    @property
    def count(self) -> int:
        return self.position.shape[0]

    @property
    def packed_color(self) -> torch.Tensor:
        return gamma22(self.color * self.intensity[:, None])

    @property
    def cos_outer_cone(self) -> torch.Tensor:
        """cos(spot_angle / 2)."""
        return torch.cos(self.spot_angle / 2.0)

    @property
    def cos_inner_cone_rcp(self) -> torch.Tensor:
        """1 / cos(inner_angle_percent * spot_angle / 2)."""
        return 1.0 / torch.cos(self.inner_angle_percent * self.spot_angle / 2.0)

    @staticmethod
    def empty(device="cuda") -> "SpotLights":
        """No lights: every field with its shape at N = 0."""
        return _empty(SpotLights, device)

    @staticmethod
    def create(position, direction, color, intensity, range, spot_angle_deg,
               inner_angle_percent=None, intensity_multiplier=None,
               has_shadow=None, shadow_strength=None,
               device="cuda") -> "SpotLights":
        p = _f32(position, device).reshape(-1, 3)
        n = p.shape[0]
        d = _f32(direction, device).reshape(n, 3)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        return SpotLights(
            position=p,
            direction=d,
            color=_f32(color, device).reshape(n, 3),
            intensity=_f32(intensity, device).reshape(n),
            range=_f32(range, device).reshape(n),
            spot_angle=_f32(spot_angle_deg, device).reshape(n)
            * torch.pi / 180.0,
            inner_angle_percent=_f32(
                inner_angle_percent if inner_angle_percent is not None
                else [0.5] * n, device).reshape(n),
            intensity_multiplier=_f32(
                intensity_multiplier if intensity_multiplier is not None
                else [1.0] * n, device).reshape(n),
            has_shadow=_bool(has_shadow if has_shadow is not None
                             else [False] * n, device).reshape(n),
            shadow_strength=_f32(shadow_strength if shadow_strength is not None
                                 else [1.0] * n, device).reshape(n),
        )
