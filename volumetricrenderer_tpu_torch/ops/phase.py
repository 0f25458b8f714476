"""Shared phase-function constant and small shared math
(`volumetricrenderer_tpu/ops/phase.py`)."""

import torch

PI = 3.1415926535  # the reference's truncated constant, kept for parity


def henyey_greenstein(g, cos_theta):
    """(1 - g^2) / (1 + g^2 - 2 g cos)^1.5 / (4 pi), the power written as
    b * sqrt(b), as the JAX package writes it (the plain XLA scatter)."""
    g2 = g * g
    b = 1.0 + g2 - 2.0 * g * cos_theta
    return (1.0 - g2) / (b * torch.sqrt(b)) / 4.0 / PI


def rgb_to_gray(r, g, b):
    """Luma of an rgb triple (weights .3/.59/.11): the extinction of the
    directional scatter."""
    return r * 0.3 + g * 0.59 + b * 0.11


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
