"""SSR past 32 taps a bin: K13's GEN instance and K15 on a table the fixed
instances do not unroll, through their twins on the CPU, held against the
JAX package.

The table: 4 direction bins of 34 taps (ssr_steps=64, ssr_dirs=4,
ssr_max_px=40; post._ssr_offsets), on 48x48 march planes, so that no tap's
shift passes the whole plane (JAX's _shift2_p returns a plane of the wrong
size past it).

  * the march's five outputs (ops/ssr.ssr_march on CPU tensors, K13's twin)
    against ssr_march_pallas in interpret mode: bit for bit, as
    tests/test_torch_post.py holds the 12-tap table;
  * K13's form for that table (its GEN instance) and K15's;
  * _ssr_p's colour-plane gradient (through SsrMarchFn: K13's RECORD twin
    forward, K15's twin ssr_march_grad_plain backward) against jax.vjp of
    the JAX package's XLA march (post.SSR_PALLAS off), at the tolerance of
    tests/test_torch_ssr_grad.py. JAX runs op by op: under jax.jit the 136
    taps unrolled (four shifted planes each) compiled for longer on the
    CPU than the op-by-op run takes, ~60 s for the first seed (each
    shift's slices compile once) and ~5 s for the second (printed).
"""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu.post as jpost
from volumetricrenderer_tpu.ops.pallas.ssr import ssr_march_pallas as j_march

from volumetricrenderer_tpu_torch import post as tpost
from volumetricrenderer_tpu_torch.convert import post_config_from_jax
from volumetricrenderer_tpu_torch.ops import ssr as tssr

import torch_tolerance  # noqa: F401  (torch's threads under xdist)

WIDE = dict(ssr_steps=64, ssr_dirs=4, ssr_max_px=40)
HQ = WQ = 48
FLIPS = 2e-3


def _offsets():
    jcfg = jpost.PostConfig(**WIDE)
    offs = jpost._ssr_offsets(jcfg)
    assert offs == tpost._ssr_offsets(post_config_from_jax(jcfg))
    return offs


def _march_inputs(seed, n_bins):
    rng = np.random.RandomState(seed)
    dq = (rng.rand(HQ, WQ) * 30 + 1).astype(np.float32)
    cols = [rng.rand(HQ, WQ).astype(np.float32) for _ in range(3)]
    g = (rng.rand(HQ, WQ) * -0.03).astype(np.float32)
    bins = rng.randint(0, n_bins, (HQ, WQ)).astype(np.float32)
    valid = (rng.rand(HQ, WQ) > 0.1).astype(np.float32)
    return dq, cols, (1.0 / dq).astype(np.float32), g, bins, valid


def test_table_takes_the_general_forms():
    offs = _offsets()
    n_bins, max_taps = len(offs), max(len(b) for b in offs)
    assert (n_bins, max_taps) == (4, 34)
    assert max(abs(v) for b in offs for t in b for v in t[2:]) < HQ
    assert tssr.k13_unroll(max_taps) == 0
    assert tssr.k13_form(n_bins, max_taps) == "gen"
    assert tssr.k15_form(n_bins, max_taps) == "fixed"


def test_march_matches_pallas_interpret():
    """K13's twin against ssr_march_pallas (interpret mode): the same 136
    taps in the same order, bit for bit."""
    offs = _offsets()
    dq, cols, invz0, g, bins, valid = _march_inputs(5, len(offs))
    t0 = time.perf_counter()
    want = j_march(jnp.asarray(dq), [jnp.asarray(c) for c in cols],
                   jnp.asarray(invz0), jnp.asarray(g), jnp.asarray(bins),
                   jnp.asarray(valid), offs, 1.0, 40.0, interpret=True)
    want = [np.asarray(w) for w in want]
    print(f"ssr_march_pallas, interpret mode: {time.perf_counter() - t0:.1f}"
          " s")
    t = torch.as_tensor
    got = tssr.ssr_march(t(dq), [t(c) for c in cols], t(invz0), t(g),
                         t(bins), t(valid), offs, 1.0, 40.0)
    hits = float(want[3].mean())
    assert 0.05 < hits < 0.95, hits
    # hits past the fixed instances' 32 taps
    rec = tssr.ssr_march_reference(t(dq), [t(c) for c in cols], t(invz0),
                                   t(g), t(bins), t(valid), offs, 1.0, 40.0,
                                   record=True)[5]
    assert int((rec >= 32).sum()) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def _scene(seed):
    """96x96 colour planes and the view depth of a camera over a floor, a
    far wall and a box (tests/test_torch_ssr_grad.py's scene), marched at
    ssr_downsample=2 on 48x48 planes."""
    h = w = 2 * HQ
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for c in range(3):
        blocks = ((xx + 0.6 * yy) // (9 + seed) + (yy // 7) * (c + 1)) % 3
        p = 0.05 + 1.15 * np.clip(0.3 * blocks + 0.2 * xx / w
                                  + 0.1 * rng.rand(h, w), 0.0, 1.0)
        planes.append(p.astype(np.float32))
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h * 2.0 - 1.0
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w * 2.0 - 1.0
    gy = np.broadcast_to(ys[:, None], (h, w)) * math.tan(math.pi / 6)
    depth = np.where(gy > 0.05, 1.5 / np.maximum(gy, 0.05), 18.0)
    box = (np.abs(xs[None, :] + 0.3) < 0.2) & (ys[:, None] > -0.3)
    depth = np.where(box, np.minimum(depth, 6.0), depth)
    return planes, depth.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_colour_gradient_matches_jax_vjp(seed, monkeypatch):
    monkeypatch.setattr(jpost, "SSR_PALLAS", False)
    cfg = dict(WIDE, ssr_intensity=0.5, ssr_downsample=2)
    planes, depth = _scene(seed)
    rng = np.random.RandomState(100 + seed)
    cots = [rng.randn(*depth.shape).astype(np.float32) for _ in range(4)]
    jcfg = jpost.PostConfig(**cfg)
    t0 = time.perf_counter()
    _, vjp = jax.vjp(lambda p: jpost._ssr_p(p, jnp.asarray(depth), jcfg),
                     [jnp.asarray(p) for p in planes])
    want = [np.asarray(g) for g in vjp([jnp.asarray(c) for c in cots])[0]]
    print(f"jax.vjp of _ssr_p, op by op: {time.perf_counter() - t0:.1f} s")
    tp = [torch.tensor(p, requires_grad=True) for p in planes]
    outs = tpost._ssr_p(tp, torch.as_tensor(depth), tpost.PostConfig(**cfg))
    used = [(o, torch.as_tensor(c)) for o, c in zip(outs, cots)
            if o.requires_grad]
    got = torch.autograd.grad([o for o, _ in used], tp,
                              [c for _, c in used])
    assert max(float(np.abs(w).max()) for w in want) > 0.1
    for c in range(3):
        g, w = got[c].numpy(), want[c]
        assert np.isfinite(g).all()
        past = np.abs(g - w) > 1e-6 + 1e-5 * np.abs(w)
        assert past.mean() <= FLIPS, (c, past.mean(),
                                      float(np.abs(g - w).max()))
