"""Build the port's scene and state from the JAX package's objects.

Takes any object (or dict) with the JAX field names and reads every array
through `np.asarray`; static fields are copied as they are. Nothing here
imports JAX: the caller hands over its objects and the arrays are converted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from volumetricrenderer_tpu_torch.inverse import (FogParams, LightParams,
                                                  OpacityParams)
from volumetricrenderer_tpu_torch.models import (Camera, DirectionalLights,
                                                 Geometry, Medium,
                                                 PointLights, Scene,
                                                 SpotLights)
from volumetricrenderer_tpu_torch.post import PostConfig
from volumetricrenderer_tpu_torch.shadow import (CubeShadowData,
                                                 DirShadowData,
                                                 SpotShadowData)
from volumetricrenderer_tpu_torch.state import FrameState


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensors(obj, names, device):
    out = {}
    for n in names:
        a = np.asarray(_get(obj, n))
        dt = torch.bool if a.dtype == np.bool_ else torch.float32
        out[n] = torch.as_tensor(np.array(a), dtype=dt, device=device)
    return out


def _statics(obj, names):
    return {n: _get(obj, n) for n in names}


def scene_from_numpy(obj, device) -> Scene:
    """The port's Scene from a JAX Scene (or a dict of its fields)."""
    cam = _get(obj, "camera")
    camera = Camera(**_tensors(cam, ("position", "forward", "up", "fov_y",
                                     "aspect", "near", "far"), device))
    dl = _get(obj, "dir_lights")
    dir_lights = DirectionalLights(**_tensors(
        dl, ("direction", "color", "intensity", "has_shadow",
             "shadow_strength"), device))
    pt = _get(obj, "point_lights")
    point_lights = PointLights(**_tensors(
        pt, ("position", "color", "intensity", "range",
             "intensity_multiplier", "has_shadow", "shadow_strength"),
        device))
    sp = _get(obj, "spot_lights")
    spot_lights = SpotLights(**_tensors(
        sp, ("position", "direction", "color", "intensity", "range",
             "spot_angle", "inner_angle_percent", "intensity_multiplier",
             "has_shadow", "shadow_strength"), device))
    media = []
    for m in _get(obj, "media"):
        tex = _get(m, "noise_tex")
        media.append(Medium(
            **_tensors(m, ("scattering_color", "absorption", "phase_g",
                           "noise_tiling", "noise_scroll", "box_min",
                           "box_max", "box_softness", "height_falloff",
                           "height_base"), device),
            noise_tex=None if tex is None else torch.as_tensor(
                np.array(np.asarray(tex)), dtype=torch.float32,
                device=device),
            **_statics(m, ("volume_type", "blend_type", "noise_mode",
                           "noise_octaves", "noise_period", "noise_seed"))))
    g = _get(obj, "geometry")
    geometry = Geometry(
        **_tensors(g, ("plane_normal", "plane_d", "plane_albedo",
                       "sphere_center", "sphere_radius", "sphere_albedo",
                       "box_min", "box_max", "box_albedo", "box_opacity",
                       "hf_amp", "hf_base", "hf_tiling", "hf_offset",
                       "hf_albedo"), device),
        **_statics(g, ("box_fractional", "n_proxy_boxes", "hf_enabled",
                       "hf_octaves", "hf_period", "hf_seed", "hf_steps",
                       "hf_far")))
    return Scene(camera=camera, dir_lights=dir_lights,
                 point_lights=point_lights, spot_lights=spot_lights,
                 media=tuple(media), geometry=geometry,
                 ambient=_tensors(obj, ("ambient",), device)["ambient"],
                 mesh=_get(obj, "mesh"))


def fog_params_from_numpy(obj, device):
    """The port's inverse.FogParams from a JAX FogParams (or a dict of its
    fields)."""
    return FogParams(**_tensors(obj, ("log_scattering", "log_absorption",
                                      "atanh_phase_g"), device))


def light_params_from_numpy(obj, device):
    """The port's inverse.LightParams from a JAX LightParams."""
    return LightParams(**_tensors(obj, ("point_position", "point_log_ci",
                                        "spot_position", "spot_log_ci",
                                        "dir_log_ci"), device))


def opacity_params_from_numpy(obj, device):
    """The port's inverse.OpacityParams from a JAX OpacityParams."""
    return OpacityParams(**_tensors(obj, ("logit_opacity",), device))


def state_from_numpy(prev_accumulation, prev_shadow, prev_world_to_view,
                     frame_count: int, device, prev_material_a=None,
                     prev_scatter=None) -> FrameState:
    """FrameState from a packed [D, H, W, 4] accumulation, an
    [Nd, D, H, W] shadow history and, where their blends are on, packed
    [D, H, W, 4] material and scatter histories (numpy arrays or anything
    np.asarray takes)."""
    f32 = lambda a: torch.as_tensor(np.array(np.asarray(a), np.float32),
                                    device=device)
    planes = lambda a: None if a is None \
        else f32(a).permute(3, 0, 1, 2).contiguous()
    return FrameState(prev_shadow=f32(prev_shadow),
                      prev_accumulation=planes(prev_accumulation),
                      prev_world_to_view=f32(prev_world_to_view).cpu(),
                      frame_count=int(frame_count),
                      prev_material_a=planes(prev_material_a),
                      prev_scatter=planes(prev_scatter))


# the JAX zgather kernel's padded-plane layout [ZG_DLANES, hp, ZG_WSTRIDE]
# (ops/pallas/zg_composite.py DLANES, HB, WSTRIDE): depth lanes, froxel rows
# per grid step, the padded cell-row stride; padded row or column r holds
# row clamp(r - 1), the interior is [1, n + 1). The port keeps no padded
# planes: only what reads the JAX package's planes knows the layout.
ZG_DLANES = 128
ZG_HB = 8
ZG_WSTRIDE = 256


def is_zg_padded(x) -> bool:
    """Whether x has the shape of a JAX zgather padded plane."""
    return len(x.shape) == 3 and x.shape[0] == ZG_DLANES \
        and x.shape[2] == ZG_WSTRIDE


def crop_padded_slabs(x: torch.Tensor, n: int, halo: int,
                      grid_dhw) -> torch.Tensor:
    """The global [D, H, W] plane of n stacked halo-extended JAX zgather
    padded planes [ZG_DLANES, n hp_ext, ZG_WSTRIDE] (a JAX multislab
    state's accumulation channel), each slab cropped to its interior."""
    d, h, w = grid_dhw
    h_loc = h // n
    h_ext = h_loc + 2 * halo
    hp_ext = (-(-h_ext // ZG_HB) + 1) * ZG_HB     # zg_composite.padded_dims
    if x.shape[1] != n * hp_ext:
        raise ValueError(f"padded plane {tuple(x.shape)} for {n} slabs of "
                         f"halo {halo} on grid {tuple(grid_dhw)}")
    xs = x.reshape(ZG_DLANES, n, hp_ext, ZG_WSTRIDE)
    xs = xs[:d, :, 1 + halo:1 + halo + h_loc, 1:w + 1]
    return xs.reshape(d, h, w)


def multislab_carry_from_numpy(carry, halo: int, device):
    """The port's make_multislab_render carry from a JAX one: each shard's
    steady state, whose accumulation is a tuple of planes in the zgather
    padded layout [ZG_DLANES, hp_ext, ZG_WSTRIDE] or raw [D, H_ext, W],
    with the pads stripped and the halo rows kept; the edge packets are
    taken from the converted states, as the JAX step takes them from its
    new state. Arrays go through np.asarray."""
    from volumetricrenderer_tpu_torch.parallel import shard_render
    states = []
    for st in carry[0]:
        shadow = np.asarray(_get(st, "prev_shadow"), np.float32)
        d, h, w = shadow.shape[1:]
        acc = np.stack([a if a.shape == (d, h, w) else a[:d, 1:h + 1, 1:w + 1]
                        for a in (np.asarray(p, np.float32) for p in
                                  _get(st, "prev_accumulation"))])
        f32 = lambda a: torch.as_tensor(np.array(a, np.float32),
                                        device=device)
        opt = lambda a: None if a is None else f32(np.moveaxis(
            np.asarray(a, np.float32), -1, 0))
        states.append(FrameState(
            prev_shadow=f32(shadow), prev_accumulation=f32(acc),
            prev_world_to_view=f32(_get(st, "prev_world_to_view")).cpu(),
            frame_count=int(np.asarray(_get(st, "frame_count"))),
            prev_material_a=opt(_get(st, "prev_material_a")),
            prev_scatter=opt(_get(st, "prev_scatter"))))
    h_ext = states[0].prev_shadow.shape[2]
    return states, [shard_render._edges(s, halo, h_ext) for s in states]


def dir_shadow_from_numpy(obj, device) -> DirShadowData:
    """The port's DirShadowData from a JAX one (aligned flag included)."""
    return DirShadowData(**_tensors(obj, ("atlas", "world_to_uv",
                                          "split_spheres", "split_sq_radii",
                                          "strength_r", "bias"), device),
                         aligned=bool(_get(obj, "aligned")))


def cube_shadow_from_numpy(obj, device) -> CubeShadowData:
    return CubeShadowData(**_tensors(obj, ("faces", "light_pos", "range",
                                           "strength_r", "bias"), device))


def spot_shadow_from_numpy(obj, device) -> SpotShadowData:
    return SpotShadowData(**_tensors(obj, ("maps", "light_pos", "axes",
                                           "tan_half_angle", "range",
                                           "strength_r", "bias"), device))


def shadow_data_from_numpy(shadow_data, device):
    """render_frame's shadow_data triple (sun, cube, spot; each may be
    None) from the JAX renderer's bake_shadow_data."""
    d, c, s = shadow_data
    conv = lambda f, v: None if v is None else f(v, device)
    return (conv(dir_shadow_from_numpy, d), conv(cube_shadow_from_numpy, c),
            conv(spot_shadow_from_numpy, s))


def post_config_from_jax(cfg) -> PostConfig:
    """The port's PostConfig from a JAX one, field by field."""
    return PostConfig(**{f.name: _get(cfg, f.name)
                         for f in dataclasses.fields(PostConfig)})


def taa_history_from_numpy(planes, device):
    """taa_step's history: three [H, W] float32 planes (None stays None)."""
    if planes is None:
        return None
    return [torch.as_tensor(np.array(np.asarray(p), np.float32),
                            device=device) for p in planes]


def adapted_luma_from_numpy(luma, device) -> torch.Tensor:
    """auto_exposure_step's carried luminance as a 0-d float32 tensor."""
    return torch.as_tensor(np.float32(np.asarray(luma)), device=device)
