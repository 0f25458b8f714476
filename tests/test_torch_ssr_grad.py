"""The SSR march under grad: kernel K15 (csrc/ssr_march_grad.cu, the
march's backward) through its twin ops/ssr.ssr_march_grad_plain, K13's
hit record, and ops/ssr.SsrMarchFn, held against the JAX package's
XLA march (post._ssr_p with post.SSR_PALLAS off), which jax.grad
differentiates.

  * _ssr_p's colour-plane gradient (jax.vjp) on two seeded scenes of 64x64
    planes at ssr_downsample=2 (32x32 march planes, ssr_max_px 20: JAX's
    shift is wrong once a tap passes the whole plane), two cotangents
    each: atol 1e-6 / rtol 1e-5 per element, at most FLIPS of the elements
    past it (the geometry's knife-edge selects -- a direction bin, a
    crossing test -- may flip on values an ulp apart and move a pixel's
    first hit);
  * the depth's gradient through the geometry stage (Fresnel of the
    implicit normals; the march's comparisons give none): the same where
    both are finite, and the NaN positions equal;
  * jax.vjp of apply_post_planes with SSR on (ACES and gamma after it)
    against the port's autograd, colour planes, the same tolerance;
  * the twin against autograd of ssr_march_reference (the differentiated
    XLA loop): 1e-6 -- autograd adds a source pixel's terms in another
    order;
  * SsrMarchFn on the CPU, its K13 and K15 wrappers taking their twins:
    forward = ssr_march_reference and backward = ssr_march_grad_plain, bit
    for bit, with hit_w and hit_t not differentiable;
  * K13's hit record and K15's gather emulated as the kernels run them,
    one pixel at a time: the record = the twin's, and the gather = the
    twin, bit for bit (sign bits included);
  * render_frame_post under grad at demo.py --small's shape (DEMO_CONFIG's
    routes, the terrain cut to 4 steps of 1 octave): it renders, and the
    fog's gradient equals the same frame's with the march differentiated
    by autograd of ssr_march_reference, to 1e-5 of its largest element.
No JAX frame compilation."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu.post as jpost

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import inverse
from volumetricrenderer_tpu_torch import post as tpost
from volumetricrenderer_tpu_torch.convert import post_config_from_jax
from volumetricrenderer_tpu_torch.ops import ssr as tssr

import torch_tolerance  # noqa: F401  (torch's threads under xdist)

H = W = 64
FLIPS = 2e-3
# 4 bins of 4 steps (~16 taps: JAX compiles the unrolled march in seconds)
SSR = dict(ssr_intensity=0.5, ssr_downsample=2, ssr_max_px=20, ssr_steps=4,
           ssr_dirs=4)


def _scene(seed):
    """Three colour planes in [0.05, 1.2] (blocks, a gradient, noise) and
    the view depth of a 60-degree camera over a floor, a far wall and a
    box, moved by the seed."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    planes = []
    for c in range(3):
        blocks = ((xx + 0.6 * yy) // (9 + seed) + (yy // 7) * (c + 1)) % 3
        p = 0.05 + 1.15 * np.clip(0.3 * blocks + 0.2 * xx / W
                                  + 0.1 * rng.rand(H, W), 0.0, 1.0)
        planes.append(p.astype(np.float32))
    ys = (np.arange(H, dtype=np.float32) + 0.5) / H * 2.0 - 1.0
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W * 2.0 - 1.0
    gy = np.broadcast_to(ys[:, None], (H, W)) * math.tan(math.pi / 6)
    depth = np.where(gy > 0.05 + 0.02 * seed,
                     1.5 / np.maximum(gy, 0.05), 18.0)
    box = (np.abs(xs[None, :] + 0.3 - 0.1 * seed) < 0.2) \
        & (ys[:, None] > -0.3)
    depth = np.where(box, np.minimum(depth, 6.0 + seed), depth)
    return planes, depth.astype(np.float32)


def _cotangents(seed, n=4):
    rng = np.random.RandomState(100 + seed)
    return [rng.randn(H, W).astype(np.float32) for _ in range(n)]


def _close(got, want, what, atol=1e-6, rtol=1e-5, flips=FLIPS):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    past = np.abs(got - want) > atol + rtol * np.abs(want)
    assert past.mean() <= flips, (what, past.mean(),
                                  float(np.abs(got - want).max()))


@jax.jit
def _jax_vjps(planes, depth, cots):
    """jax.vjp of JAX _ssr_p at SSR: the colour planes' and the depth's
    cotangents (one compilation for every case)."""
    cfg = jpost.PostConfig(**SSR)
    _, vjp = jax.vjp(lambda p, d: jpost._ssr_p(p, d, cfg), planes, depth)
    return vjp(cots)


def _ssr_grads(planes, depth, cots, wrt):
    """(port, JAX) gradients of sum(cot * _ssr_p output) with respect to
    the colour planes (wrt="colour") or the depth."""
    j_col, j_depth = _jax_vjps([jnp.asarray(p) for p in planes],
                               jnp.asarray(depth),
                               [jnp.asarray(c) for c in cots])
    want = [np.asarray(g) for g in j_col] if wrt == "colour" \
        else [np.asarray(j_depth)]
    tp = [torch.tensor(p, requires_grad=wrt == "colour") for p in planes]
    td = torch.tensor(depth, requires_grad=wrt == "depth")
    outs = tpost._ssr_p(tp, td, tpost.PostConfig(**SSR))
    used = [(o, torch.as_tensor(c)) for o, c in zip(outs, cots)
            if o.requires_grad]
    leaves = tp if wrt == "colour" else [td]
    got = torch.autograd.grad([o for o, _ in used], leaves,
                              [c for _, c in used])
    return [g.numpy() for g in got], want


@pytest.fixture(autouse=True)
def _xla_march(monkeypatch):
    monkeypatch.setattr(jpost, "SSR_PALLAS", False)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cot", [0, 1])
def test_colour_gradient_matches_jax_vjp(seed, cot):
    planes, depth = _scene(seed)
    got, want = _ssr_grads(planes, depth, _cotangents(cot), "colour")
    assert max(float(np.abs(w).max()) for w in want) > 0.1
    for c in range(3):
        _close(got[c], want[c], f"colour {c}")


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_gradient_matches_jax_vjp(seed):
    planes, depth = _scene(seed)
    (got,), (want,) = _ssr_grads(planes, depth, _cotangents(seed), "depth")
    nan_got, nan_want = ~np.isfinite(got), ~np.isfinite(want)
    np.testing.assert_array_equal(nan_got, nan_want)
    both = ~nan_got
    assert float(np.abs(want[both]).max()) > 0.0
    _close(got[both], want[both], "depth", atol=1e-5, rtol=1e-4)


def test_apply_post_planes_vjp_matches_jax():
    planes, depth = _scene(0)
    cots = _cotangents(2, 3)
    jcfg = jpost.PostConfig(exposure=1.2, **SSR)
    jd = jnp.asarray(depth)
    want = jax.jit(lambda p, c: jax.vjp(
        lambda q: jpost.apply_post_planes(q, jcfg, jd), p)[1](c)[0])(
        [jnp.asarray(p) for p in planes], [jnp.asarray(c) for c in cots])
    tp = [torch.tensor(p, requires_grad=True) for p in planes]
    outs = tpost.apply_post_planes(tp, post_config_from_jax(jcfg),
                                   torch.as_tensor(depth))
    got = torch.autograd.grad(outs, tp, [torch.as_tensor(c) for c in cots])
    for c in range(3):
        _close(got[c].numpy(), np.asarray(want[c]), f"colour {c}")


def _march_inputs(seed, hq=40, wq=56):
    """K13's inputs on seeded random planes, PostConfig()'s 8 bins of
    taps cut to 20 px."""
    rng = np.random.RandomState(seed)
    offsets = tpost._ssr_offsets(tpost.PostConfig(ssr_max_px=20))
    t = lambda a: torch.as_tensor(a.astype(np.float32))
    dq = rng.rand(hq, wq) * 30 + 1
    cols = [t(rng.rand(hq, wq)) for _ in range(3)]
    g = t(rng.rand(hq, wq) * -0.03)
    bins = rng.randint(0, len(offsets), (hq, wq))
    bins[0, :3] = (-1, len(offsets), 3)
    bins = t(bins)
    bins[0, 2] = 2.5
    valid = t(rng.rand(hq, wq) > 0.1)
    return (t(dq), cols, t(1.0 / dq), g, bins, valid, offsets, 0.6, 20.0)


def test_twin_matches_autograd_of_reference():
    args = _march_inputs(3)
    cols = [c.clone().requires_grad_(True) for c in args[1]]
    outs = tssr.ssr_march_reference(args[0], cols, *args[2:])
    cots = [torch.as_tensor(c[:40, :56]) for c in _cotangents(4, 3)]
    want = torch.autograd.grad(outs[:3], cols, cots)
    hit_k = tssr.ssr_march_reference(*args, record=True)[5]
    got = tssr.ssr_march_grad_plain(cots, args[4], hit_k, args[6])
    assert 0.1 < float((hit_k >= 0).float().mean()) < 0.9
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)


def test_ssr_march_fn_is_the_twins_bit_for_bit(monkeypatch):
    calls = []

    def counted(fn, name):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(tssr, "ssr_march", counted(tssr.ssr_march, "k13"))
    monkeypatch.setattr(tssr, "ssr_march_grad",
                        counted(tssr.ssr_march_grad, "k15"))
    args = _march_inputs(5)
    dq = args[0].clone().requires_grad_(True)
    cols = [c.clone().requires_grad_(True) for c in args[1]]
    outs = tssr.ssr_march_differentiable(dq, cols, *args[2:])
    want = tssr.ssr_march_reference(*args, record=True)
    for o, w in zip(outs, want[:5]):
        assert torch.equal(o, w)
    assert [o.requires_grad for o in outs] == [True] * 3 + [False] * 2
    cots = [torch.as_tensor(c[:40, :56]) for c in _cotangents(6, 3)]
    got = torch.autograd.grad(outs[:3], cols + [dq], cots,
                              allow_unused=True)
    twin = tssr.ssr_march_grad_plain(cots, args[4], want[5], args[6])
    for g, w in zip(got[:3], twin):
        assert torch.equal(g, w)
    assert got[3] is None
    assert calls == ["k13", "k15"]


def _emulate_record(dq, colors, invz0, g, bin_idx, valid, offsets,
                    thickness, max_px):
    """K13's RECORD instance, one pixel at a time in float32: the tap
    index of its first hit in its own bin's table rows, -1 for none or
    valid 0."""
    rows, counts = tssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)
    f = np.float32
    dq_, z0p, gp, bp, vp = (p.numpy() for p in (dq, invz0, g, bin_idx,
                                                valid))
    hq, wq = dq_.shape
    depth = lambda v: f(1.0) / v if v > f(1e-4) else f(1e9)
    out = np.full((hq, wq), -1, np.int32)
    for y in range(hq):
        for x in range(wq):
            bf = bp[y, x]
            b = int(bf)
            if not (bf >= 0 and b < len(offsets) and f(b) == bf):
                continue
            z0, gi, z_last = z0p[y, x], gp[y, x], f(0.0)
            for k in range(counts[b]):
                t_prev, t, _ = rows[b, k, :3]
                p = int(bits[b, k, 3])
                sy = y + (p & 0xfff) - 2048
                sx = x + ((p >> 12) & 0xfff) - 2048
                zs = dq_[min(max(sy, 0), hq - 1), min(max(sx, 0), wq - 1)]
                z_ray = depth(z0 + gi * t)
                z_prev = z_last if (p >> 24) & 1 else depth(z0 + gi * t_prev)
                z_last = z_ray
                if (0 <= sy < hq and 0 <= sx < wq and z_ray >= zs
                        and z_prev <= zs + f(thickness)):
                    out[y, x] = k if vp[y, x] != 0 else -1
                    break
    return out


def _emulate_k15(grads, bin_idx, hit_k, offsets, max_px):
    """K15's gather, one source pixel at a time in float32: bins, then
    taps, in order; adds g[p] where p = q - offset is in the plane and its
    bin and hit record are the tap's."""
    rows, counts = tssr.pack_taps(offsets, max_px)
    bits = rows.view(np.int32)
    gs = [g.numpy() for g in grads]
    bp, hp = bin_idx.numpy(), hit_k.numpy()
    hq, wq = bp.shape
    out = np.zeros((3, hq, wq), np.float32)
    for y in range(hq):
        for x in range(wq):
            acc = [np.float32(0.0)] * 3
            for b in range(len(offsets)):
                for k in range(counts[b]):
                    p = int(bits[b, k, 3])
                    py = y - ((p & 0xfff) - 2048)
                    px = x - (((p >> 12) & 0xfff) - 2048)
                    if not (0 <= py < hq and 0 <= px < wq):
                        continue
                    if hp[py, px] == k and bp[py, px] == np.float32(b):
                        acc = [a + g[py, px] for a, g in zip(acc, gs)]
            out[:, y, x] = acc
    return out


def test_k13_record_and_k15_gather_are_the_twins():
    args = _march_inputs(7, 20, 28)
    want = tssr.ssr_march_reference(*args, record=True)[5]
    np.testing.assert_array_equal(_emulate_record(*args), want.numpy())
    rng = np.random.RandomState(8)
    cots = [torch.as_tensor(np.where(rng.rand(20, 28) < 0.1, -0.0,
                                     rng.randn(20, 28)).astype(np.float32))
            for _ in range(3)]
    twin = torch.stack(tssr.ssr_march_grad_plain(cots, args[4], want,
                                                 args[6])).numpy()
    got = _emulate_k15(cots, args[4], want, args[6], args[8])
    assert (np.abs(twin) > 0).mean() > 0.1
    assert (got.view(np.int32) == twin.view(np.int32)).all()


def _demo_small():
    """demo.py --small's config and the demo scene, terrain cut."""
    cfg = dataclasses.replace(vt.DEMO_CONFIG, volume_width=80,
                              volume_height=44, volume_depth=32,
                              image_width=480, image_height=270,
                              shadow_map_size=128)
    scene = vt.demo_scene(aspect=480 / 270, device="cpu")
    geo = dataclasses.replace(scene.geometry, hf_steps=4, hf_octaves=1)
    return cfg, dataclasses.replace(scene, geometry=geo)


def test_render_frame_post_under_grad(monkeypatch):
    cfg, scene = _demo_small()
    r = vt.VolumetricRenderer(cfg, device="cpu")
    with torch.no_grad():
        gbuf = r.render_scene_inputs(scene)
        maps = r.bake_shadow_data(scene)
    post = tpost.PostConfig(ssr_intensity=0.5)

    def fog_grad():
        fog = inverse.FogParams.from_medium(scene.media[0])
        rgb, _, _ = r.render_frame_post(
            r.init_state(1), inverse.scene_with_fog(fog, scene), post, 0.0,
            *gbuf, maps)
        (rgb - 0.3).square().mean().backward()
        return rgb.detach(), [p.grad.clone() for p in fog.parameters()]

    rgb, grads = fog_grad()
    # the march differentiated by autograd of the XLA loop's twin
    monkeypatch.setattr(tssr, "ssr_march_differentiable",
                        tssr.ssr_march_reference)
    rgb_ref, grads_ref = fog_grad()
    assert torch.equal(rgb, rgb_ref)
    assert bool(torch.isfinite(rgb).all()) and float(rgb.std()) > 1e-3
    for g, w in zip(grads, grads_ref):
        assert bool(torch.isfinite(g).all())
        scale = float(w.abs().max())
        assert scale > 0.0
        assert float((g - w).abs().max()) <= 1e-5 * scale
