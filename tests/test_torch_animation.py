"""The port's animation helpers (volumetricrenderer_tpu_torch/animation.py)
against the JAX package's (volumetricrenderer_tpu/animation.py), name for
name, at several times t: BrownianMotion's position and rotation offsets,
ConstantMotion's, animate_camera with each motion, and
SmoothFollowController over 20 steps toward a target. Tolerance 1e-6
absolute (the fBm is the same Perlin on the same points; sin, cos, exp and
the norms differ by an ulp between XLA and torch on the CPU). JAX runs op
by op: no compilation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import animation as janim
from volumetricrenderer_tpu.models.camera import Camera as JCamera

from volumetricrenderer_tpu_torch import animation as tanim
from volumetricrenderer_tpu_torch.models.camera import Camera as TCamera

import torch_tolerance  # noqa: F401  (torch's threads under xdist)

TIMES = (0.0, 0.37, 1.7, 4.25, 9.9)
MOTIONS = {
    "brownian": dict(position_amplitude=0.5, rotation_amplitude=10.0,
                     frequency=1.3, octaves=3, seed=5),
    "brownian_default": {},
    "constant": dict(velocity=(1.0, -0.5, 2.0),
                     angular_velocity_deg=(3.0, -7.0, 1.0)),
}


def _motions(name):
    kw = MOTIONS[name]
    if name.startswith("brownian"):
        return janim.BrownianMotion(**kw), tanim.BrownianMotion(**kw)
    return janim.ConstantMotion(**kw), tanim.ConstantMotion(**kw)


def _cameras():
    args = dict(position=(0.0, 2.0, -10.0), forward=(0.1, -0.05, 1.0))
    return JCamera.create(**args), TCamera.create(device="cpu", **args)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=1e-6, err_msg=what)


@pytest.mark.parametrize("name", list(MOTIONS))
def test_motion_offsets_match_jax(name):
    jm, tm = _motions(name)
    moved = False
    for t in TIMES:
        _close(tm.position_offset(t), jm.position_offset(t), f"position {t}")
        _close(tm.rotation_offset_deg(t), jm.rotation_offset_deg(t),
               f"rotation {t}")
        moved = moved or bool(np.abs(np.asarray(jm.position_offset(t))).max()
                              > 1e-3)
    assert moved


@pytest.mark.parametrize("name", list(MOTIONS))
def test_animate_camera_matches_jax(name):
    jm, tm = _motions(name)
    jc, tc = _cameras()
    for t in TIMES:
        jn, tn = janim.animate_camera(jc, t, jm), tanim.animate_camera(tc, t,
                                                                       tm)
        _close(tn.position, jn.position, f"position {t}")
        _close(tn.forward, jn.forward, f"forward {t}")
        assert tn.position.device == tc.position.device
        assert abs(float(torch.linalg.norm(tn.forward)) - 1.0) < 1e-6


def test_smooth_follow_matches_jax():
    jc, tc = _cameras()
    jctl = janim.SmoothFollowController(position_lerp_time=0.2,
                                        rotation_lerp_time=0.05)
    tctl = tanim.SmoothFollowController(position_lerp_time=0.2,
                                        rotation_lerp_time=0.05)
    for i in range(20):
        target = (5.0 * np.sin(0.3 * i), 2.0 + 0.1 * i, -10.0 + 0.2 * i)
        fwd = (0.2 * np.cos(0.2 * i), -0.1, 1.0)
        dt = 0.05 + 0.01 * (i % 3)
        jc = jctl.step(jc, jnp.asarray(target, jnp.float32),
                       jnp.asarray(fwd, jnp.float32), dt)
        tc = tctl.step(tc, target, fwd, dt)
        _close(tc.position, jc.position, f"position, step {i}")
        _close(tc.forward, jc.forward, f"forward, step {i}")
