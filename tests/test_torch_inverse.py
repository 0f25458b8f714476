"""Inverse rendering (inverse.py) against the JAX package on the CPU: the
port's loss and its gradients in FogParams, LightParams and OpacityParams
against jax.value_and_grad of the JAX frame's loss, and Adam steps against
optax.adam's.

Two JAX compilations of a render gradient, each a module fixture:

  * raycast: a 16x16x8 grid at 32x32 pixels (tests/test_checkpoint_
    inverse.py's shape; the cells composite, JAX composite_tentmm),
    shadow_mode="raycast", on a scene that merges tests/test_inverse_lights'
    and tests/test_box_opacity's: a shadowed sun, a shadowed point light,
    a box of opacity 0.6 under the light (a canopy) and a ground plane. The
    state carries a seeded
    history (frame_count 1, the previous camera a step back), so the
    gradient passes the shadow and accumulation blends at alpha 0.5.
    jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2))) over the three
    parameter sets at once;
  * demo: FogParams on demo_scene at tests/test_parallel.py's CFG (16x16x8
    at 48x32, shadow_mode="map" with JAX's maps of shadow_map_size 32 baked
    once and passed to both, the XLA scatter) with composite_impl="rowmm"
    (JAX composite_rowmm; the port's per-pixel form), the terrain cut to 4
    steps of 1 octave as tests/test_torch_xla_scatter.py cuts it.

Both feed JAX's G-buffer to both renderers. The targets are the port's own
frame of the scene at absorption 0.6 (data for both sides). Holds: the loss
to 1e-5 relative; each gradient leaf to |g - g_jax| <= 1e-4 max|g_jax| +
1e-7 (the same sums in other orders; a froxel's and a light's gradient sums
terms of both signs); a 6-step Adam run on the fog (lr 5e-2, from absorption 0.1
as tests/test_checkpoint_inverse.py starts; optax.adam eagerly over the
same jitted gradient, torch.optim.Adam on the port) each
step's loss to 1e-4 relative (the parameters drift apart by the gradients'
rounding), its last loss below 0.9 of its first."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from volumetricrenderer_tpu import Camera as JCamera
from volumetricrenderer_tpu import DirectionalLights as JDirs
from volumetricrenderer_tpu import Geometry as JGeometry
from volumetricrenderer_tpu import Medium as JMedium
from volumetricrenderer_tpu import PointLights as JPoints
from volumetricrenderer_tpu import RenderConfig as JRenderConfig
from volumetricrenderer_tpu import Scene as JScene
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import inverse as jinv
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import inverse as tinv
from volumetricrenderer_tpu_torch.convert import (fog_params_from_numpy,
                                                  light_params_from_numpy,
                                                  opacity_params_from_numpy,
                                                  scene_from_numpy,
                                                  shadow_data_from_numpy,
                                                  state_from_numpy)

RAYCAST = dict(volume_width=16, volume_height=16, volume_depth=8,
               image_width=32, image_height=32, shadow_mode="raycast",
               temporal_blend_alpha=0.5)
DEMO = dict(volume_width=16, volume_height=16, volume_depth=8,
            image_width=48, image_height=32, shadow_map_size=32,
            composite_impl="rowmm")
LR, STEPS = 5e-2, 6


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


def j_raycast_scene(cam=(0.0, 2.0, -10.0)):
    return JScene.create(
        camera=JCamera.create(position=cam, forward=(0, 0, 1), aspect=1.0),
        dir_lights=JDirs.create(direction=[(0.3, -0.7, 0.5)],
                                color=[(1, 1, 1)], intensity=[1.5],
                                has_shadow=[True], shadow_strength=[0.8]),
        point_lights=JPoints.create(position=[(-2.0, 4.0, 3.0)],
                                    color=[(1.0, 0.8, 0.6)],
                                    intensity=[6.0], range=[25.0],
                                    has_shadow=[True]),
        media=(JMedium.create(scattering_color=(1, 1, 1), absorption=0.2,
                              phase_g=0.3),),
        geometry=JGeometry.create(
            planes=[((0.0, 1.0, 0.0), 0.0, (0.2, 0.2, 0.2))],
            boxes=[((-4.0, 0.0, 0.0), (1.0, 3.0, 6.0), (0.4, 0.4, 0.4),
                    0.6)]))


def history_state(jr, jcfg, seed):
    """JAX and port states with a seeded history: frame_count 1, the
    previous view a step back and to the left of the camera."""
    d, h, w = jcfg.grid_dhw
    rng = np.random.default_rng(seed)
    acc = np.concatenate([rng.uniform(0.0, 0.05, (d, h, w, 3)),
                          rng.uniform(0.5, 1.0, (d, h, w, 1))],
                         -1).astype(np.float32)
    shadow = rng.uniform(0.5, 1.0, (1, d, h, w)).astype(np.float32)
    prev = j_raycast_scene(cam=(-0.2, 2.0, -10.3)).camera
    w2v = np.linalg.inv(np.asarray(prev.view_to_world())).astype(np.float32)
    jst = dataclasses.replace(
        jr.init_state(1), prev_shadow=jnp.asarray(shadow),
        prev_accumulation=jnp.asarray(acc),
        prev_world_to_view=jnp.asarray(w2v),
        frame_count=jnp.asarray(1, jnp.int32))
    return jst, state_from_numpy(acc, shadow, w2v, 1, "cpu")


def leaves_close(got, want, msg):
    """|g - g_jax| <= 1e-4 max|g_jax| + 1e-7 for each leaf; a parameter
    autograd left unreached (an empty light list) holds zeros."""
    for name, wv in want.items():
        g = got[name]
        g = np.zeros_like(wv) if g is None else g.numpy()
        assert g.shape == wv.shape and np.isfinite(g).all(), (msg, name)
        if not wv.size:
            continue
        bound = 1e-4 * np.abs(wv).max() + 1e-7
        err = np.abs(g - wv).max()
        assert err <= bound, (msg, name, err, bound)


def grads_of(module):
    return {n: (None if p.grad is None else p.grad.detach().clone())
            for n, p in module.named_parameters()}


def jax_leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def port_target(tr, ts, tst, sc, vd, scene_at):
    with torch.no_grad():
        img, _, _ = tr.render_frame(tst, scene_at, 0.0, sc, vd)
    return img[..., :3].contiguous()


def start_fog(medium):
    """The Adam runs' first fog: the medium at absorption 0.1 (JAX), as
    tests/test_checkpoint_inverse.py starts, and the same on the port."""
    jfog = jinv.FogParams.from_medium(dataclasses.replace(
        medium, absorption=jnp.float32(0.1)))
    return jfog, fog_params_from_numpy(jfog, "cpu")


def adam_runs(vg, jfog, jtarget, step_t, ttarget):
    """STEPS Adam steps on both sides from the same fog; their losses.
    vg(fog, target) -> (loss, grads) is JAX's jitted gradient; step_t(
    target) the port's step."""
    opt = optax.adam(LR)
    ost = opt.init(jfog)
    j_losses, t_losses = [], []
    for _ in range(STEPS):
        loss, g = vg(jfog, jtarget)
        upd, ost = opt.update(g[0] if isinstance(g, tuple) else g, ost, jfog)
        jfog = optax.apply_updates(jfog, upd)
        j_losses.append(float(loss))
        t_losses.append(float(step_t(ttarget)))
    return np.asarray(j_losses), np.asarray(t_losses)


# --------------------------------------------------------------------------
# The raycast scene: FogParams, LightParams and OpacityParams together
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raycast():
    jcfg = JRenderConfig(**RAYCAST)
    jr, tr = JRenderer(jcfg), vt.VolumetricRenderer(
        vt.RenderConfig(**RAYCAST), device="cpu")
    js = j_raycast_scene()
    ts = scene_from_numpy(js, "cpu")
    assert ts.geometry.box_fractional
    c, d = (np.array(a) for a in jax.jit(jr.render_scene_inputs)(js))
    sc, vd = t_(c), t_(d)
    # the history state (the gradient hold) and a fresh one (the Adam run,
    # as tests/test_checkpoint_inverse.py), each with its target
    states = {"history": history_state(jr, jcfg, seed=0),
              "fresh": (jr.init_state(1), tr.init_state(1))}
    fog0 = tinv.FogParams.from_medium(ts.media[0])
    at_06 = tinv.scene_with_fog(tinv.FogParams(
        fog0.log_scattering, np.log(0.6), fog0.atanh_phase_g), ts)
    targets = {k: port_target(tr, ts, st[1], sc, vd, at_06)
               for k, st in states.items()}

    def jloss(fp, lp, op, tgt, st):
        scene = jinv._scene_with_params(lp.apply(op.apply(js)), fp)
        img, _, _ = jr.render_frame(st, scene, 0.0, c, d)
        return jnp.mean((img[..., :3] - tgt) ** 2)

    vg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))
    jfog = jinv.FogParams.from_medium(js.media[0])
    jlp = jinv.LightParams.from_scene(js)
    jop = jinv.OpacityParams.from_scene(js)
    return dict(jr=jr, tr=tr, js=js, ts=ts, states=states, sc=sc, vd=vd,
                targets=targets, vg=vg, jfog=jfog, jlp=jlp, jop=jop)


def test_raycast_loss_and_gradients_match_jax(raycast):
    r = raycast
    jst, tst = r["states"]["history"]
    target = r["targets"]["history"]
    loss_j, (g_fog, g_lp, g_op) = r["vg"](r["jfog"], r["jlp"], r["jop"],
                                          target.numpy(), jst)
    fog = fog_params_from_numpy(r["jfog"], "cpu")
    lp = light_params_from_numpy(r["jlp"], "cpu")
    op = opacity_params_from_numpy(r["jop"], "cpu")
    scene = tinv.scene_with_fog(fog, lp.apply(op.apply(r["ts"])))
    loss = tinv.image_loss(r["tr"], scene, tst, target, r["sc"], r["vd"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    leaves_close(grads_of(fog), jax_leaves(g_fog, (
        "log_scattering", "log_absorption", "atanh_phase_g")), "fog")
    leaves_close(grads_of(lp), jax_leaves(g_lp, (
        "point_position", "point_log_ci", "spot_position", "spot_log_ci",
        "dir_log_ci")), "lights")
    leaves_close(grads_of(op), jax_leaves(g_op, ("logit_opacity",)),
                 "opacity")
    # every parameter set moves the image
    for g in (g_fog.log_absorption, g_lp.point_log_ci, g_lp.point_position,
              g_lp.dir_log_ci, g_op.logit_opacity):
        assert np.abs(np.asarray(g)).max() > 0.0


def test_raycast_adam_tracks_optax(raycast):
    """6 Adam steps on the fog from a fresh state (make_train_step; lights
    and opacity held) against optax.adam over the jitted JAX gradient."""
    r = raycast
    jst, tst = r["states"]["fresh"]
    target = r["targets"]["fresh"]
    jfog, fog = start_fog(r["js"].media[0])
    lp = light_params_from_numpy(r["jlp"], "cpu").requires_grad_(False)
    op = opacity_params_from_numpy(r["jop"], "cpu").requires_grad_(False)
    opt = torch.optim.Adam(fog.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = tinv.make_train_step(
        r["tr"], opt,
        lambda p, s: tinv.scene_with_fog(p, lp.apply(op.apply(s))))
    j_losses, t_losses = adam_runs(
        lambda f, tgt: r["vg"](f, r["jlp"], r["jop"], tgt, jst), jfog,
        target.numpy(), lambda tgt: step(fog, r["ts"], tst, tgt, r["sc"],
                                         r["vd"]), target)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert np.isfinite(t_losses).all() and t_losses[-1] < 0.9 * t_losses[0]


# --------------------------------------------------------------------------
# demo_scene in map mode: FogParams
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo():
    jcfg = JRenderConfig(**DEMO)
    jr, tr = JRenderer(jcfg), vt.VolumetricRenderer(
        vt.RenderConfig(**DEMO), device="cpu")
    js = j_demo(aspect=48 / 32)
    js = dataclasses.replace(js, geometry=dataclasses.replace(
        js.geometry, hf_steps=4, hf_octaves=1))
    ts = scene_from_numpy(js, "cpu")
    maps = jr.bake_shadow_data(js)
    t_maps = shadow_data_from_numpy(maps, "cpu")
    jst, tst = jr.init_state(1), tr.init_state(1)
    c, d = (np.array(a) for a in jax.jit(jr.render_scene_inputs)(js))
    sc, vd = t_(c), t_(d)
    with torch.no_grad():
        fog_t = tinv.FogParams.from_medium(ts.media[0])
        fog_t.log_absorption.fill_(float(np.log(0.6)))
        img, _, _ = tr.render_frame(tst, tinv.scene_with_fog(fog_t, ts),
                                    0.0, sc, vd, shadow_data=t_maps)
    target = img[..., :3].contiguous()

    def jloss(fp, tgt):
        img, _, _ = jr.render_frame(jst, jinv._scene_with_params(js, fp),
                                    0.0, c, d, shadow_data=maps)
        return jnp.mean((img[..., :3] - tgt) ** 2)

    vg = jax.jit(jax.value_and_grad(jloss))
    return dict(tr=tr, js=js, ts=ts, tst=tst, sc=sc, vd=vd, maps=t_maps,
                target=target, vg=vg,
                jfog=jinv.FogParams.from_medium(js.media[0]))


def test_demo_fog_gradient_matches_jax(demo):
    r = demo
    assert vt.config.composite_route(r["tr"].config) == "pixels"
    loss_j, g = r["vg"](r["jfog"], r["target"].numpy())
    fog = fog_params_from_numpy(r["jfog"], "cpu")
    loss = tinv.render_loss(r["tr"], fog, r["ts"], r["tst"], r["target"],
                            r["sc"], r["vd"], r["maps"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    leaves_close(grads_of(fog), jax_leaves(g, (
        "log_scattering", "log_absorption", "atanh_phase_g")), "demo fog")
    assert np.abs(np.asarray(g.log_absorption)) > 0.0


def test_demo_adam_tracks_optax(demo):
    """6 train_step calls on the fog (the maps passed in), against optax."""
    r = demo
    jfog, fog = start_fog(r["js"].media[0])
    opt = torch.optim.Adam(fog.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    j_losses, t_losses = adam_runs(
        r["vg"], jfog, r["target"].numpy(),
        lambda tgt: tinv.train_step(r["tr"], fog, opt, r["ts"], r["tst"],
                                    tgt, r["sc"], r["vd"], r["maps"]),
        r["target"])
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert np.isfinite(t_losses).all() and t_losses[-1] < 0.9 * t_losses[0]


# --------------------------------------------------------------------------
# The parameter modules: roundtrips and conversions
# --------------------------------------------------------------------------

def test_params_roundtrip_and_convert():
    """apply(from_*(scene)) of the lights and the opacities renders the
    scene's image (rtol 1e-5, atol 1e-6, as the JAX package's roundtrip
    tests hold it: exp(log(x)) and sigmoid(logit(x)) move x by an ulp), the
    fog's gives its medium back with the phase times 0.99 (rtol 1e-6), and convert.*_params_from_numpy of
    the JAX from_* equals the port's from_* of the converted scene (rtol
    1e-6: the same float32 log, atanh and logit)."""
    js = j_raycast_scene()
    ts = scene_from_numpy(js, "cpu")
    tr = vt.VolumetricRenderer(vt.RenderConfig(**RAYCAST), device="cpu")
    sc, vd = tr.render_scene_inputs(ts)
    with torch.no_grad():
        want, _, _ = tr.render_frame(tr.init_state(1), ts, 0.0, sc, vd)
        fog = tinv.FogParams.from_medium(ts.media[0])
        lp = tinv.LightParams.from_scene(ts)
        op = tinv.OpacityParams.from_scene(ts)
        for name, scene in (("lights", lp.apply(ts)),
                            ("opacity", op.apply(ts))):
            got, _, _ = tr.render_frame(tr.init_state(1), scene, 0.0, sc, vd)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                       msg=name)
        # FogParams.apply scales the phase by 0.99, as JAX's does
        m, m_rt = ts.media[0], fog.apply(ts.media[0])
        torch.testing.assert_close(m_rt.scattering_color,
                                   m.scattering_color, rtol=1e-6, atol=0.0)
        torch.testing.assert_close(m_rt.absorption, m.absorption, rtol=1e-6,
                                   atol=0.0)
        torch.testing.assert_close(m_rt.phase_g, m.phase_g * 0.99,
                                   rtol=1e-6, atol=0.0)
    pairs = ((fog_params_from_numpy(jinv.FogParams.from_medium(
        js.media[0]), "cpu"), fog),
             (light_params_from_numpy(jinv.LightParams.from_scene(js),
                                      "cpu"), lp),
             (opacity_params_from_numpy(jinv.OpacityParams.from_scene(js),
                                        "cpu"), op))
    for got, want in pairs:
        g, w = dict(got.named_parameters()), dict(want.named_parameters())
        assert g.keys() == w.keys()
        for n in w:
            torch.testing.assert_close(g[n], w[n], rtol=1e-6, atol=0.0,
                                       msg=n)
