"""Shared phase-function constant and small shared math
(`volumetricrenderer_tpu/ops/phase.py`)."""

import torch

PI = 3.1415926535  # the reference's truncated constant, kept for parity


def rgb_to_gray(r, g, b):
    """Luma of an rgb triple (weights .3/.59/.11): the extinction of the
    directional scatter."""
    return r * 0.3 + g * 0.59 + b * 0.11


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)
