"""Light distance and cone falloffs (`volumetricrenderer_tpu/ops/falloff.py`).

The engine's attenuation LUT is the analytic curve it stands for:
lut(x) = saturate((1 - x) * 5) / (1 + 25 x) at x = d^2 / range^2. These
are the plain XLA scatter's falloffs; kernels K1, K2, K6 and K9 and their
twins (ops/scatter.light_factor) keep their own inline copy.
"""

from __future__ import annotations

import torch

from volumetricrenderer_tpu_torch.ops.phase import smoothstep


def attenuation_lut(x):
    return torch.clamp((1.0 - x) * 5.0, 0.0, 1.0) / (1.0 + 25.0 * x)


def point_light_falloff(distance, range, attenuation_multiplier):
    """The LUT distance attenuation times the light's multiplier."""
    x = distance * distance / (range * range)
    return attenuation_lut(x) * attenuation_multiplier


def spot_light_falloff(distance, cos_angle, range, cos_outer_cone,
                       cos_inner_cone_rcp, attenuation_multiplier):
    """The LUT distance attenuation times the cone's
    1 - smoothstep(cos_inner, cos_outer, cos_angle)."""
    x = distance * distance / (range * range)
    dist_atten = attenuation_lut(x)
    cone_atten = 1.0 - smoothstep(1.0 / cos_inner_cone_rcp, cos_outer_cone,
                                  cos_angle)
    return cone_atten * dist_atten * attenuation_multiplier
