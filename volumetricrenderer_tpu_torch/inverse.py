"""Differentiable inverse rendering: the training path.

Port of `volumetricrenderer_tpu/inverse.py`. The frame is differentiable
wherever the JAX package's is (renderer.check_differentiable refuses the
rest): its plain-torch passes by autograd, the composite through K4 forward
and K14 backward (ops/zg_composite.CompositeFn). Medium, light and occluder
parameters are fitted to target images by gradient descent:

  FogParams, OpacityParams, LightParams   nn.Modules of nn.Parameters with
                                          the JAX dataclasses' fields,
                                          `from_*` and `apply`
  render_loss, train_step                 the fog's loss and one step
  make_train_step                         one step over any parameter module
  make_sharded_train_step                 data parallel: each rank renders
                                          its own views, the gradients and
                                          the loss averaged by all_reduce
                                          (JAX's pmean), then the step

`torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)` stands for
`optax.adam(lr)`: the same defaults and update, rounded in another order.
Parameters update in place (the optimizer owns its state); each step returns
the loss before the update, as JAX's value_and_grad does.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from volumetricrenderer_tpu_torch.models.media import Medium
from volumetricrenderer_tpu_torch.models.scene import Scene
from volumetricrenderer_tpu_torch.renderer import VolumetricRenderer
from volumetricrenderer_tpu_torch.state import FrameState


def _param(value) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(value, dtype=torch.float32)
                        .detach().clone())


class FogParams(nn.Module):
    """The first medium's scattering colour [3], absorption [] and phase g
    [], in log and atanh space so that they stay positive and in (-1, 1)."""

    def __init__(self, log_scattering, log_absorption, atanh_phase_g):
        super().__init__()
        self.log_scattering = _param(log_scattering)
        self.log_absorption = _param(log_absorption)
        self.atanh_phase_g = _param(atanh_phase_g)

    @staticmethod
    def from_medium(m: Medium) -> "FogParams":
        with torch.no_grad():
            return FogParams(
                torch.log(torch.clamp(m.scattering_color, min=1e-4)),
                torch.log(torch.clamp(m.absorption, min=1e-4)),
                torch.atanh(torch.clamp(m.phase_g, -0.98, 0.98)))

    def apply(self, m: Medium) -> Medium:
        return dataclasses.replace(
            m, scattering_color=torch.exp(self.log_scattering),
            absorption=torch.exp(self.log_absorption),
            phase_g=torch.tanh(self.atanh_phase_g) * 0.99)


class OpacityParams(nn.Module):
    """Per-box shadow opacity [B] in logit space (kept in (0, 1)). The
    scene's geometry must have box_fractional set: shadow rays then carry
    an occlusion amount that is linear in each opacity."""

    def __init__(self, logit_opacity):
        super().__init__()
        self.logit_opacity = _param(logit_opacity)

    @staticmethod
    def from_scene(scene: Scene) -> "OpacityParams":
        with torch.no_grad():
            o = torch.clamp(scene.geometry.box_opacity, 1e-3, 1.0 - 1e-3)
            return OpacityParams(torch.log(o / (1.0 - o)))

    def apply(self, scene: Scene) -> Scene:
        g = dataclasses.replace(scene.geometry,
                                box_opacity=torch.sigmoid(self.logit_opacity))
        return dataclasses.replace(scene, geometry=g)


class LightParams(nn.Module):
    """Point and spot light positions [P, 3], [S, 3], and every light's
    colour x intensity in log space ([P, 3], [S, 3], [Nd, 3]); apply sets
    the intensities to 1. The any-hit shadow tests are boolean and give the
    positions no gradient, in the port as in the JAX package."""

    def __init__(self, point_position, point_log_ci, spot_position,
                 spot_log_ci, dir_log_ci):
        super().__init__()
        self.point_position = _param(point_position)
        self.point_log_ci = _param(point_log_ci)
        self.spot_position = _param(spot_position)
        self.spot_log_ci = _param(spot_log_ci)
        self.dir_log_ci = _param(dir_log_ci)

    @staticmethod
    def from_scene(scene: Scene) -> "LightParams":
        def lci(lights):
            return torch.log(torch.clamp(
                lights.color * lights.intensity[:, None], min=1e-6))
        with torch.no_grad():
            return LightParams(scene.point_lights.position,
                               lci(scene.point_lights),
                               scene.spot_lights.position,
                               lci(scene.spot_lights), lci(scene.dir_lights))

    def apply(self, scene: Scene) -> Scene:
        def ones(lights):
            return torch.ones((lights.count,), dtype=torch.float32,
                              device=lights.intensity.device)
        pl = dataclasses.replace(
            scene.point_lights, position=self.point_position,
            color=torch.exp(self.point_log_ci),
            intensity=ones(scene.point_lights))
        sl = dataclasses.replace(
            scene.spot_lights, position=self.spot_position,
            color=torch.exp(self.spot_log_ci),
            intensity=ones(scene.spot_lights))
        dl = dataclasses.replace(
            scene.dir_lights, color=torch.exp(self.dir_log_ci),
            intensity=ones(scene.dir_lights))
        return dataclasses.replace(scene, point_lights=pl, spot_lights=sl,
                                   dir_lights=dl)


def scene_with_fog(params: FogParams, scene: Scene) -> Scene:
    """The scene with its first medium replaced by params.apply of it."""
    media = (params.apply(scene.media[0]),) + tuple(scene.media[1:])
    return dataclasses.replace(scene, media=media)


def image_loss(renderer: VolumetricRenderer, scene: Scene, state: FrameState,
               target: torch.Tensor, scene_color, view_depth,
               shadow_data=None) -> torch.Tensor:
    """Mean squared error of the frame's rgb [IH, IW, 3] against target.
    shadow_data: the shadow maps baked once by the caller (render_frame's
    argument; None bakes them in the frame)."""
    img, _, _ = renderer.render_frame(state, scene, 0.0, scene_color,
                                      view_depth, shadow_data)
    return torch.mean((img[..., :3] - target) ** 2)


def render_loss(renderer: VolumetricRenderer, params: FogParams,
                scene: Scene, state: FrameState, target: torch.Tensor,
                scene_color, view_depth, shadow_data=None) -> torch.Tensor:
    """The fog parameters' loss: image_loss of the scene with them."""
    return image_loss(renderer, scene_with_fog(params, scene), state, target,
                      scene_color, view_depth, shadow_data)


def _step(optimizer, loss_fn) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    optimizer.step()
    return loss.detach()


def train_step(renderer: VolumetricRenderer, params: FogParams, optimizer,
               scene: Scene, state: FrameState, target: torch.Tensor,
               scene_color, view_depth, shadow_data=None) -> torch.Tensor:
    """One optimizer step on the fog parameters (the optimizer built over
    params.parameters()); returns the loss before it."""
    return _step(optimizer, lambda: render_loss(
        renderer, params, scene, state, target, scene_color, view_depth,
        shadow_data))


def make_train_step(renderer: VolumetricRenderer, optimizer, apply_fn):
    """One step over any parameter module: apply_fn(params, scene) -> Scene
    reconfigures the scene (e.g. scene_with_fog, LightParams.apply).
    Returns step(params, scene, state, target, scene_color, view_depth,
    shadow_data=None) -> the loss before the step; the optimizer holds
    params' parameters."""
    def step(params, scene, state, target, scene_color, view_depth,
             shadow_data=None):
        return _step(optimizer, lambda: image_loss(
            renderer, apply_fn(params, scene), state, target, scene_color,
            view_depth, shadow_data))
    return step


def make_sharded_train_step(renderer: VolumetricRenderer, optimizer,
                            group=None):
    """The data-parallel step: each rank of the process group (None: the
    default one; one rank per GPU with NCCL, gloo on the CPU) renders its
    own views, each with its camera at cam_positions[i], against its
    targets; its loss is the mean over them. The gradients and the loss are
    summed over the ranks in one all_reduce and divided by the world size
    (JAX's pmean), then the optimizer steps; every rank ends with the same
    parameters.

    Returns step(params, scene, state, cam_positions [B, 3], targets
    [B, IH, IW, 3], scene_colors [B, IH, IW, 3], view_depths [B, IH, IW]) ->
    the mean loss over every rank's views, before the step."""
    import torch.distributed as dist

    def step(params, scene, state, cam_positions, targets, scene_colors,
             view_depths):
        def view_loss(i):
            cam = dataclasses.replace(scene.camera,
                                      position=cam_positions[i])
            return render_loss(renderer, params, dataclasses.replace(
                scene, camera=cam), state, targets[i], scene_colors[i],
                view_depths[i])

        optimizer.zero_grad(set_to_none=True)
        loss = torch.stack([view_loss(i)
                            for i in range(len(cam_positions))]).mean()
        loss.backward()
        ps = list(params.parameters())
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1) for p in ps]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=group)
        flat = flat / dist.get_world_size(group)
        for p, g in zip(ps, flat[:-1].split([p.numel() for p in ps])):
            p.grad = g.view_as(p).clone()
        optimizer.step()
        return flat[-1]

    return step
