"""The port's post stack (volumetricrenderer_tpu_torch/post.py, device CPU:
the SSR march takes K13's twin) against the JAX package's post.py under
jax.jit, effect by effect, at 90x160 (odd quarter-res sizes: 90 -> 45 ->
22, so the floors of _down2_p and the exact-size pads of _up2_p are
exercised). Inputs are made with numpy from a seed and handed to both.

Each effect of apply_post_planes is one case (PostConfig with that effect
on, tonemap="none" and gamma=1 so that nothing else rounds), plus
taa_step, auto_exposure_step and camera_velocity; each packed-image public
function is one case of its own. Tolerance: atol 1e-6 +
rtol 1e-6 per element, where transcendentals (tan, atan2, pow, exp2, log2,
rsqrt) may round 1-2 ulp apart in XLA's and torch's CPU builds, and XLA
contracts some multiply-adds into FMAs under jit. Where a
select decides on a value computed with such ulps (FXAA's and SMAA's
thresholds, the motion blur's and SSR's direction bins, SSR's crossing
test), at most 2e-3 of the elements may also differ beyond it. Lens
distortion is held at atol 2e-5 (see its case). Grain and
the dither pattern (integer hash, interleaved gradient noise) must match
bit for bit.

K13's twin is also held against the JAX package's Pallas march in
interpret mode on 32x48 planes, and through post._ssr_p against the XLA
arm (post.SSR_PALLAS off)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu.post as jpost
from volumetricrenderer_tpu.ops import noise as jnoise
from volumetricrenderer_tpu.ops.pallas.ssr import ssr_march_pallas as j_march

from volumetricrenderer_tpu_torch import post as tpost
from volumetricrenderer_tpu_torch.convert import (adapted_luma_from_numpy,
                                                  post_config_from_jax,
                                                  taa_history_from_numpy)
from volumetricrenderer_tpu_torch.ops import noise as tnoise
from volumetricrenderer_tpu_torch.ops import ssr as tssr

H, W = 90, 160
FLIPS = 2e-3   # fraction of elements a knife-edge select may flip


def _planes(rng, lo=0.0, hi=1.4):
    """Three HDR planes: blocks with staircase edges, a gradient and noise."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for c in range(3):
        blocks = ((xx + 0.6 * yy) // 23 + (yy // 17) * (c + 1)) % 3 / 2.0
        grad = xx / W * (0.3 + 0.2 * c)
        p = lo + (hi - lo) * np.clip(0.6 * blocks + 0.3 * grad
                                     + 0.1 * rng.rand(H, W), 0.0, 1.0)
        out.append(p.astype(np.float32))
    return out


def _depth():
    """View depth of a 60-degree camera over a floor, a far wall and a box."""
    ys = (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 1.0
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W * 2.0 - 1.0
    gy = np.broadcast_to(ys[:, None], (H, W)) * math.tan(math.pi / 6)
    floor = gy > 0.08
    depth = np.where(floor, 1.5 / np.maximum(gy, 0.08), 18.0)
    box = (np.abs(xs[None, :] + 0.3) < 0.15) & (ys[:, None] > -0.2)
    depth = np.where(box, np.minimum(depth, 7.0), depth)
    return depth.astype(np.float32)


def _velocity(rng):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    vx = 3.0 * np.sin(xx / 23.0) + 0.5 * rng.randn(H, W)
    vy = 2.0 * np.cos(yy / 17.0) + 0.5 * rng.randn(H, W)
    return np.stack([vx, vy], -1).astype(np.float32)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return _planes(rng), _depth(), _velocity(rng)


def _close(got, want, what, atol=1e-6, rtol=1e-6, flips=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    past = np.abs(got - want) > atol + rtol * np.abs(want)
    assert past.mean() <= flips, (what, past.mean(),
                                  float(np.abs(got - want).max()))


LUTS = ((0.0, 0.3, 0.7, 1.0), (0.0, 0.5, 1.0), (0.1, 0.2, 0.6, 0.8, 0.9))
SSR_SMALL = dict(ssr_intensity=0.6, ssr_downsample=2, ssr_steps=4,
                 ssr_dirs=4, ssr_max_px=24)
# case -> (PostConfig fields, atol, fraction allowed to flip)
EFFECTS = {
    "exposure_aces_gamma": (dict(exposure=1.3), 1e-6, 0.0),
    # the displacement is (src_u - u) * W, a difference of two uv values
    # near 0.5 scaled by 160: one ulp of uv is 1e-5 px (the JAX function
    # itself moves by 1.1e-5 px between jit and eager)
    "lens_distortion": (dict(lens_distortion=8.0), 2e-5, 0.0),
    # 4 steps and 4 bins compile fast; the defaults (12 steps, 8 bins) are
    # held by test_ssr_geometry_and_march_match_xla_arm
    "ssr": (SSR_SMALL, 1e-6, FLIPS),
    "dof": (dict(dof_focus_distance=6.0, dof_aperture=2.0,
                 dof_max_coc=3.0), 1e-6, 0.0),
    "motion_blur": (dict(motion_blur=0.6), 1e-6, FLIPS),
    "chromatic_aberration": (dict(chromatic_aberration=1.5), 1e-6, 0.0),
    "bloom": (dict(bloom_strength=0.3, bloom_threshold=0.7), 1e-6, 0.0),
    "vignette": (dict(vignette=0.3), 1e-6, 0.0),
    "ao": (dict(ao_intensity=0.8, ao_radius_px=6), 1e-6, 0.0),
    "ao_multiscale": (dict(ao_intensity=0.6, ao_multiscale=True), 1e-6,
                      0.0),
    "grade": (dict(grade_lift=(0.02, 0.0, 0.01), grade_gamma=(1.1, 0.9, 1.0),
                   grade_gain=(1.05, 1.0, 0.95), saturation=1.2,
                   contrast=1.1), 1e-6, 0.0),
    "luts": (dict(grade_luts=LUTS), 1e-6, 0.0),
    "grain": (dict(grain=0.05, grain_seed=3), 1e-6, 0.0),
    "smaa": (dict(smaa=True), 1e-6, FLIPS),
    "fxaa": (dict(fxaa=True), 1e-6, FLIPS),
    "dithering": (dict(dithering=True), 1e-6, 0.0),
}
STEPS = ("taa_step", "auto_exposure_step", "camera_velocity")


def _jax_post(planes, depth, vel, jcfg):
    return [np.asarray(p) for p in jax.jit(
        lambda p, d, v: jpost.apply_post_planes(p, jcfg, d, v,
                                                dither_frame=5))(
        [jnp.asarray(p) for p in planes], jnp.asarray(depth),
        jnp.asarray(vel))]


@pytest.mark.parametrize("case", list(EFFECTS) + list(STEPS))
def test_effect_matches_jax(case, monkeypatch):
    monkeypatch.setattr(jpost, "SSR_PALLAS", False)
    planes, depth, vel = _inputs()
    t = lambda a: torch.as_tensor(np.asarray(a))
    if case in EFFECTS:
        kw, atol, flips = EFFECTS[case]
        if case != "exposure_aces_gamma":
            kw = dict(kw, tonemap="none", gamma=1.0)
        jcfg = jpost.PostConfig(**kw)
        want = _jax_post(planes, depth, vel, jcfg)
        got = tpost.apply_post_planes([t(p) for p in planes],
                                      post_config_from_jax(jcfg), t(depth),
                                      t(vel), dither_frame=5)
        base = tpost.apply_post_planes([t(p) for p in planes],
                                       tpost.PostConfig(tonemap="none",
                                                        gamma=1.0))
        assert any(not torch.equal(g, b) for g, b in zip(got, base)), \
            f"{case} changed nothing"
        for c in range(3):
            _close(got[c], want[c], f"{case} channel {c}", atol=atol,
                   flips=flips)
    elif case == "taa_step":
        jcfg = jpost.PostConfig()
        hist = _planes(np.random.RandomState(7), 0.1, 1.2)
        want_o, want_h = jax.jit(lambda c, h, v: jpost.taa_step(
            c, h, v, jcfg))([jnp.asarray(p) for p in planes],
                            [jnp.asarray(p) for p in hist], jnp.asarray(vel))
        got_o, got_h = tpost.taa_step(
            [t(p) for p in planes], taa_history_from_numpy(hist, "cpu"),
            t(vel), post_config_from_jax(jcfg))
        for c in range(3):
            _close(got_o[c], want_o[c], f"taa display {c}")
            _close(got_h[c], want_h[c], f"taa history {c}")
        o0, h0 = tpost.taa_step([t(p) for p in planes], None, t(vel),
                                tpost.PostConfig())
        assert all(torch.equal(a, t(p)) for a, p in zip(o0, planes))
    elif case == "auto_exposure_step":
        jcfg = jpost.PostConfig(auto_exposure=True, ae_min_ev=-2.0,
                                ae_max_ev=2.0, ae_key=0.6)
        luma = 1.0
        tluma = adapted_luma_from_numpy(luma, "cpu")
        j_step = jax.jit(lambda p, l: jpost.auto_exposure_step(p, l, jcfg))
        for i in range(3):
            scaled = [p * (0.4 + 0.5 * i) for p in planes]
            ws, luma = j_step([jnp.asarray(p) for p in scaled], luma)
            gs, tluma = tpost.auto_exposure_step(
                [t(p) for p in scaled], tluma, post_config_from_jax(jcfg))
            _close(gs, ws, f"exposure scale, frame {i}")
            _close(tluma, luma, f"adapted luma, frame {i}")
        hist = jax.jit(lambda p: jpost.log_luma_histogram(p))(
            [jnp.asarray(p) for p in planes])
        np.testing.assert_array_equal(
            tpost.log_luma_histogram([t(p) for p in planes]).numpy(),
            np.asarray(hist))
    else:
        fov, aspect = np.float32(math.radians(60.0)), np.float32(W / H)
        ang = 0.05
        v2w = np.eye(4, dtype=np.float32)
        v2w[:3, :3] = [[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                       [-math.sin(ang), 0, math.cos(ang)]]
        v2w[:3, 3] = (0.3, 1.9, -15.2)
        pw2v = np.eye(4, dtype=np.float32)
        pw2v[:3, 3] = (0.4, -2.0, 15.8)
        want = jax.jit(jpost.camera_velocity)(jnp.asarray(depth), fov,
                                             aspect, jnp.asarray(v2w),
                                             jnp.asarray(pw2v))
        got = tpost.camera_velocity(t(depth), t(fov), t(aspect), t(v2w),
                                    t(pw2v))
        # velocities are tens of pixels: the 1/z of the reprojection and
        # tan() carry a few ulp of that
        _close(got, want, "camera velocity", atol=1e-5, rtol=1e-5)


# packed [H, W, 3] wrapper -> its call on (module, image, depth, velocity,
# history, PostConfig fields -> the module's PostConfig)
PACKED = {
    "bloom": lambda m, x, d, v, h, cfg: m.bloom(x, 0.6, 3),
    "chromatic_aberration": lambda m, x, d, v, h, cfg:
        m.chromatic_aberration(x, 1.5),
    "color_grade": lambda m, x, d, v, h, cfg:
        m.color_grade(x, cfg(saturation=1.2, contrast=1.1)),
    "apply_channel_luts": lambda m, x, d, v, h, cfg:
        m.apply_channel_luts(x, LUTS),
    "film_grain": lambda m, x, d, v, h, cfg: m.film_grain(x, 0.05, 3),
    "depth_of_field": lambda m, x, d, v, h, cfg:
        m.depth_of_field(x, d, cfg(dof_focus_distance=6.0)),
    "motion_blur": lambda m, x, d, v, h, cfg: m.motion_blur(x, v, 0.6),
    "screen_space_reflections": lambda m, x, d, v, h, cfg:
        m.screen_space_reflections(x, d, cfg(**SSR_SMALL)),
    "smaa": lambda m, x, d, v, h, cfg: m.smaa(x, cfg(smaa=True)),
    "fxaa": lambda m, x, d, v, h, cfg: m.fxaa(x),
    "lens_distortion": lambda m, x, d, v, h, cfg:
        m.lens_distortion(x, cfg(lens_distortion=-6.0)),
    "temporal_antialiasing": lambda m, x, d, v, h, cfg:
        m.temporal_antialiasing(x, h, v, cfg()),
}


@pytest.mark.parametrize("name", list(PACKED))
def test_packed_wrapper_matches_jax(name, monkeypatch):
    """The packed-image public functions: the same planar cores between one
    split and one stack (film_grain masks by the input's luma), at the
    tolerance of the matching effect case (lens distortion here in its
    pincushion branch)."""
    monkeypatch.setattr(jpost, "SSR_PALLAS", False)
    planes, depth, vel = _inputs(2)
    arrays = (np.stack(planes, -1), depth, vel,
              np.stack(_planes(np.random.RandomState(5), 0.1, 1.2), -1))
    call = PACKED[name]
    want = jax.jit(lambda *a: call(jpost, *a, jpost.PostConfig))(
        *[jnp.asarray(a) for a in arrays])
    t_cfg = lambda **kw: post_config_from_jax(jpost.PostConfig(**kw))
    got = call(tpost, *[torch.as_tensor(a) for a in arrays], t_cfg)
    atol = 2e-5 if name == "lens_distortion" else 1e-6
    flips = FLIPS if name in ("motion_blur", "screen_space_reflections",
                              "smaa", "fxaa") else 0.0
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g, w, name, atol=atol, flips=flips)


def test_grain_and_dither_patterns_match_jax_bit_for_bit():
    """The grain hash under jax.jit, and the interleaved gradient noise op
    by op: under jax.jit XLA's CPU backend contracts p.x * m.x + p.y * m.y
    into one FMA, which the port (like the card, built without contraction)
    does not, and 52.98 * frac() amplifies that ulp to up to 5e-5 on a
    fifth of the pattern (1/255 of it, 2e-7, reaches the dither case)."""
    want = np.asarray(jax.jit(lambda: jpost._grain_noise(H, W, 11))())
    np.testing.assert_array_equal(tpost._grain_noise(H, W, 11, "cpu").numpy(),
                                  want)
    pix = np.stack(np.meshgrid(np.arange(W, dtype=np.float32),
                               np.arange(H, dtype=np.float32),
                               indexing="xy"), -1)
    for frame in (0, 7):
        want = np.asarray(jnoise.interleaved_gradient_noise(
            jnp.asarray(pix), frame))
        got = tnoise.interleaved_gradient_noise(torch.as_tensor(pix), frame)
        np.testing.assert_array_equal(got.numpy(), want)


def _march_inputs(seed, hq, wq, n_bins):
    rng = np.random.RandomState(seed)
    dq = (rng.rand(hq, wq) * 30 + 1).astype(np.float32)
    cols = [rng.rand(hq, wq).astype(np.float32) for _ in range(3)]
    g = (rng.rand(hq, wq) * -0.03).astype(np.float32)
    bins = rng.randint(0, n_bins, (hq, wq)).astype(np.float32)
    valid = (rng.rand(hq, wq) > 0.1).astype(np.float32)
    return dq, cols, (1.0 / dq).astype(np.float32), g, bins, valid


def test_ssr_march_twin_matches_pallas_interpret():
    """K13's twin against ssr_march_pallas (interpret mode) on 32x48 planes,
    6 steps to 16 px: the same taps in the same order, bit for bit."""
    cfg = jpost.PostConfig(ssr_steps=6, ssr_max_px=16)
    offs = jpost._ssr_offsets(cfg)
    assert offs == tpost._ssr_offsets(post_config_from_jax(cfg))
    dq, cols, invz0, g, bins, valid = _march_inputs(3, 32, 48, len(offs))
    want = j_march(jnp.asarray(dq), [jnp.asarray(c) for c in cols],
                   jnp.asarray(invz0), jnp.asarray(g), jnp.asarray(bins),
                   jnp.asarray(valid), offs, 1.0, 16.0, interpret=True)
    t = torch.as_tensor
    got = tssr.ssr_march_pallas(t(dq), [t(c) for c in cols], t(invz0), t(g),
                                t(bins), t(valid), offs, 1.0, 16.0)
    hits = float(np.asarray(want[3]).mean())
    assert 0.05 < hits < 0.95, hits
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ssr_geometry_and_march_match_xla_arm(monkeypatch):
    """post._ssr_p with the march on K13's twin against the JAX package's
    XLA arm, at the default quarter res (22x40 of 90x160) and 12 steps, to
    20 px: the JAX shift (_shift2_p) returns a plane of the wrong size once
    a tap passes the whole plane (22 rows), so the default 56 px cannot run
    there."""
    monkeypatch.setattr(jpost, "SSR_PALLAS", False)
    planes, depth, _ = _inputs(1)
    jcfg = jpost.PostConfig(ssr_intensity=0.5, ssr_max_px=20)
    want = jax.jit(lambda p, d: jpost._ssr_p(p, d, jcfg))(
        [jnp.asarray(p) for p in planes], jnp.asarray(depth))
    t = torch.as_tensor
    got = tpost._ssr_p([t(p) for p in planes], t(depth),
                       post_config_from_jax(jcfg))
    assert float(np.asarray(want[3]).max()) > 0.05
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, f"ssr output {i}", flips=FLIPS)
