"""The slice as a whole: the port's VolumetricRenderer.render_frame_post
(device CPU: the twins of K1-K4 and K13) against the JAX renderer's under
jax.jit, over two frames with the camera moving between them and the
showcase PostConfig of demo.py (SSR, multi-scale AO, SMAA, lens distortion,
DoF, motion blur from camera_velocity, CA, grain, grading, dither, bloom,
vignette; auto_exposure is on in the config, and render_frame_post leaves
the scale to the caller in both packages).

Shape: FULL_CONFIG's production knobs on a 20x15x16 grid at 160x120
pixels (8x8 pixel cells: the zgather composite, K4; the bench's --small
shape, 40x24 froxels at 160x90, has no integer pixel/froxel ratio and takes
a composite the port has not ported), benchmark_scene with 4 local lights
and procedural noise. The SSR march is cut to 20 px (ssr_max_px; the
default 56 px passes the 30-row quarter-res plane, where the JAX shift
returns a plane of the wrong size). Both renderers take the G-buffer JAX
computes, as the bench computes it once up front.

Tolerance (torch_tolerance.assert_boundary_close): rtol 1e-5 / atol 1e-6
per element, except for at most 5e-3 of the elements, which may also sit
beyond 1e-3 relative: the frame's shadow rays may flip at primitive edges,
and the post chain's knife-edge selects (SMAA's edge threshold, SSR's and
the motion blur's direction bins and SSR's crossing test) may flip on
values that differ by an ulp; the mean absolute error is at most 1e-5 of
the image maximum."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu.post as jpost
from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import post as tpost
from volumetricrenderer_tpu_torch.convert import (post_config_from_jax,
                                                  scene_from_numpy)

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=20, volume_height=15, volume_depth=16,
             image_width=160, image_height=120)
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]
# demo.py's showcase chain, the SSR march cut to the small image
SHOWCASE = dict(exposure=1.1, bloom_strength=0.25, bloom_threshold=0.8,
                vignette=0.25, chromatic_aberration=1.0, grain=0.02,
                saturation=1.1, contrast=1.05, dof_focus_distance=20.0,
                dof_aperture=11.0, dof_max_coc=3.0, motion_blur=0.4,
                auto_exposure=True, ae_key=0.6, ae_min_ev=-2.0,
                ae_max_ev=2.0, smaa=True, dithering=True,
                lens_distortion=8.0, ao_intensity=0.5, ao_multiscale=True,
                ssr_intensity=0.5, ssr_max_px=20)


@pytest.fixture(scope="module")
def frames():
    mp = pytest.MonkeyPatch()
    mp.setattr(jpost, "SSR_PALLAS", False)
    aspect = 160 / 120
    base = j_bench(aspect=aspect, num_local_lights=4, noise_mode="procedural")
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=aspect)) for p, f in CAMERAS]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL))
    jcfg = jpost.PostConfig(**SHOWCASE)
    gbuffers = [tuple(np.array(a) for a in
                      jax.jit(jr.render_scene_inputs)(sc)) for sc in scenes]

    def j_step(s, sc, t, c, d):
        cam = sc.camera
        vel = jpost.camera_velocity(d, cam.fov_y, cam.aspect,
                                    cam.view_to_world(), s.prev_world_to_view)
        rgb, _, ns = jr.render_frame_post(s, sc, jcfg, t, c, d, velocity=vel)
        return rgb, ns

    step = jax.jit(j_step)
    st = jr.init_state(1)
    j_out = []
    for i, (sc, (c, d)) in enumerate(zip(scenes, gbuffers)):
        rgb, st = step(st, sc, jnp.float32(0.1 * i), c, d)
        j_out.append(np.asarray(rgb))
    mp.undo()

    tr = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                               device="cpu")
    tcfg = post_config_from_jax(jcfg)
    ts = tr.init_state(1)
    t_out = []
    for i, (sc, (c, d)) in enumerate(zip(scenes, gbuffers)):
        tsc = scene_from_numpy(sc, "cpu")
        cam = tsc.camera
        depth = torch.as_tensor(d)
        vel = tpost.camera_velocity(depth, cam.fov_y, cam.aspect,
                                    cam.view_to_world(),
                                    ts.prev_world_to_view)
        rgb, aux, ts = tr.render_frame_post(ts, tsc, tcfg,
                                            np.float32(0.1 * i),
                                            torch.as_tensor(c), depth,
                                            velocity=vel)
        t_out.append(rgb.numpy())
    return j_out, t_out, ts


@pytest.mark.parametrize("i", [0, 1])
def test_frame_post_matches_jax(frames, i):
    j_out, t_out, _ = frames
    a, b = t_out[i], j_out[i]
    assert a.shape == b.shape == (120, 160, 3)
    assert 0.0 <= a.min() and a.max() <= 1.0 and a.std() > 0.01
    assert_boundary_close(a, b, f"display image {i}")
    assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()


def test_frame_post_runs_the_frame_then_the_chain(frames):
    """render_frame_post is render_frame followed by apply_post_planes on
    the image planes with the frame's view depth, and advances the state."""
    _, t_out, ts = frames
    assert ts.frame_count == 2
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                              device="cpu")
    scene = vt.benchmark_scene(aspect=160 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    cfg = tpost.PostConfig(exposure=1.0, bloom_strength=0.15, vignette=0.2)
    st = r.init_state(1)
    rgb, aux, st2 = r.render_frame_post(st, scene, cfg, 0.0)
    img, _, _ = r.render_frame(st, scene, 0.0)
    want = tpost.apply_post(img, cfg, view_depth=aux["view_depth"])
    torch.testing.assert_close(rgb, want, rtol=0, atol=0)
    assert st2.frame_count == 1
