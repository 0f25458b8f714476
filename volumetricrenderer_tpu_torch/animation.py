"""Scene animation utilities, the demo-support layer.

Port of `volumetricrenderer_tpu/animation.py`, the equivalents of the
reference's third-party demo helpers:
- Klak BrownianMotion (Klak/Motion/BrownianMotion.cs): fBm noise wobble
  applied to position and rotation, on ops/noise.perlin_3d's fBm;
- Klak ConstantMotion (Klak/Motion/ConstantMotion.cs): constant translate
  and rotate;
- SimpleCameraController (Assets/ThirdParty/SimpleCameraController.cs): a
  headless stand-in, exponential position and rotation smoothing toward a
  scripted target path.

All are pure: (t, params) -> Camera or offsets. Offsets are float32
tensors on the CPU; animate_camera and SmoothFollowController.step compute
on the camera's device.
"""

from __future__ import annotations

import dataclasses

import torch

from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.ops.noise import perlin_3d

f32 = torch.float32


def _fbm_vec3(t: torch.Tensor, seed: int, octaves: int) -> torch.Tensor:
    """3 decorrelated fBm samples along a 1D time axis, in [-1, 1]."""
    full = lambda v: torch.full_like(t, v)
    pts = torch.stack([
        torch.stack([t * 0.1, full(7.7 + seed), full(1.3)], -1),
        torch.stack([full(3.1), t * 0.1 + seed, full(9.2)], -1),
        torch.stack([full(5.9), full(2.4), t * 0.1 + 2 * seed], -1),
    ])
    return (perlin_3d(pts, octaves=octaves, period=8, seed=seed) - 0.5) * 2.0


def _time(t, device=None) -> torch.Tensor:
    return torch.as_tensor(t, dtype=f32, device=device)


@dataclasses.dataclass(frozen=True)
class BrownianMotion:
    """fBm wobble (BrownianMotion.cs fields: position and rotation
    amplitude, frequency, octaves)."""
    position_amplitude: float = 0.1
    rotation_amplitude: float = 2.0       # degrees
    frequency: float = 1.0
    octaves: int = 2
    seed: int = 11

    def position_offset(self, t, device=None) -> torch.Tensor:
        t = _time(t, device) * self.frequency
        return _fbm_vec3(t[None], self.seed, self.octaves)[:, 0] \
            * self.position_amplitude

    def rotation_offset_deg(self, t, device=None) -> torch.Tensor:
        t = _time(t, device) * self.frequency
        return _fbm_vec3(t[None], self.seed + 101, self.octaves)[:, 0] \
            * self.rotation_amplitude


@dataclasses.dataclass(frozen=True)
class ConstantMotion:
    """Constant translate and rotate (ConstantMotion.cs)."""
    velocity: tuple = (0.0, 0.0, 0.0)         # units/sec
    angular_velocity_deg: tuple = (0.0, 0.0, 0.0)

    def position_offset(self, t, device=None) -> torch.Tensor:
        return torch.as_tensor(self.velocity, dtype=f32, device=device) \
            * _time(t, device)

    def rotation_offset_deg(self, t, device=None) -> torch.Tensor:
        return torch.as_tensor(self.angular_velocity_deg, dtype=f32,
                               device=device) * _time(t, device)


def _rotate_forward(forward: torch.Tensor,
                    yaw_pitch_roll_deg: torch.Tensor) -> torch.Tensor:
    """Apply small yaw/pitch offsets (degrees) to a forward vector."""
    yaw = torch.deg2rad(yaw_pitch_roll_deg[1])
    pitch = torch.deg2rad(yaw_pitch_roll_deg[0])
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    x, y, z = forward[0], forward[1], forward[2]
    # yaw about +y
    x, z = cy * x + sy * z, -sy * x + cy * z
    # pitch about +x (applied in the yawed frame, adequate for small wobbles)
    y, z = cp * y - sp * z, sp * y + cp * z
    v = torch.stack([x, y, z])
    return v / torch.linalg.norm(v)


def animate_camera(base: Camera, t, motion: BrownianMotion | ConstantMotion
                   ) -> Camera:
    """Apply a motion component to a camera, like attaching the Unity
    behaviour to the camera object (the demo scene has a disabled
    BrownianMotion on the main camera, scene:547-685)."""
    dev = base.position.device
    pos = base.position + motion.position_offset(t, dev)
    fwd = _rotate_forward(base.forward, motion.rotation_offset_deg(t, dev))
    return dataclasses.replace(base, position=pos, forward=fwd)


@dataclasses.dataclass(frozen=True)
class SmoothFollowController:
    """Exponential smoothing toward a target path (SimpleCameraController's
    position and rotation lerp, SimpleCameraController.cs)."""
    position_lerp_time: float = 0.2
    rotation_lerp_time: float = 0.01

    def step(self, cam: Camera, target_pos, target_fwd, dt) -> Camera:
        dev = cam.position.device
        dt = _time(dt, dev)
        log01 = torch.log(_time(0.01, dev))
        kp = 1.0 - torch.exp(log01 * dt / self.position_lerp_time)
        kr = 1.0 - torch.exp(log01 * dt / self.rotation_lerp_time)
        pos = cam.position + (torch.as_tensor(target_pos, dtype=f32,
                                              device=dev)
                              - cam.position) * kp
        fwd = cam.forward + (torch.as_tensor(target_fwd, dtype=f32,
                                             device=dev) - cam.forward) * kr
        fwd = fwd / torch.linalg.norm(fwd)
        return dataclasses.replace(cam, position=pos, forward=fwd)
