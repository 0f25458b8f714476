"""K14 (ops/zg_composite.composite_grad, csrc/composite_grad.cu), the
adjoint of K4's cells and per-pixel forms, and the autograd.Function that
puts K4 forward and K14 backward, on the CPU:

  * K14's twin composite_grad_plain against autograd of composite_plain and
    composite_pixels_plain, to 1e-6 relative and 1e-6 absolute (the same
    products, summed in another order: a froxel of the far clamp sums
    hundreds of terms to ~6, a few ulps apart);
  * the twin against jax.vjp of JAX pipeline.composite at the tentmm route
    (the cells form) and the rowmm route (the per-pixel form): rtol 1e-5
    and atol 1e-7 + 1e-6 max|g| for the accumulation (a froxel sums the
    terms of every pixel that reads it, of both signs, and XLA sums them in
    another order: where they cancel, the rounding is relative to the
    terms, not to their sum), rtol 1e-5 and atol 1e-7 for the scene
    colour (one product a pixel);
  * CompositeFn with the K4 launcher patched to its twins: the image and
    the scene colour's gradient equal autograd of the plain composite bit
    for bit, the accumulation's gradient equals K14's twin bit for bit
    (and so autograd's to 1e-6);
  * a kernel's argument that requires grad raises while grad is on
    (cuda.ptr), so that no launch drops a gradient unseen;
  * the composite refuses under grad what JAX serves with a Pallas kernel
    or does not differentiate: a view depth that requires grad, a slab's
    forms and the planes of the co-sited composite; without grad they run.

Inputs are random from numpy seeds, with depths past both ends of the
volume (the far clamp, where both z taps hit slice d - 1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import RenderConfig as JRenderConfig
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.config import composite_route
from volumetricrenderer_tpu_torch.ops import zg_composite as zg

# form -> (image (IH, IW), grid (W, H, D), JAX composite_impl)
CASES = {"cells": ((32, 48), (16, 16, 8), "tentmm"),
         "pixels": ((36, 50), (16, 11, 8), "rowmm")}
FOV, NEAR = 1.0, 0.3


def inputs(form, seed=0):
    (ih, iw), (w, h, d), _ = CASES[form]
    rng = np.random.default_rng(seed)
    return dict(
        acc=rng.uniform(0, 1, (4, d, h, w)).astype(np.float32),
        scene=rng.uniform(0, 1, (ih, iw, 3)).astype(np.float32),
        depth=rng.uniform(0.05, 140.0, (ih, iw)).astype(np.float32),
        grad=rng.normal(size=(ih, iw, 4)).astype(np.float32))


def t_params(form):
    (ih, iw), grid, _ = CASES[form]
    return tfroxel.make_froxel_params(torch.tensor(FOV),
                                      torch.tensor(iw / ih),
                                      torch.tensor(NEAR), 100.0, 0.5, grid)


def plain(form):
    return zg.composite_plain if form == "cells" \
        else zg.composite_pixels_plain


def autograd_of_plain(form, x):
    grid = CASES[form][1]
    acc = torch.as_tensor(x["acc"]).requires_grad_()
    scene = torch.as_tensor(x["scene"]).requires_grad_()
    img = plain(form)(acc, scene, torch.as_tensor(x["depth"]),
                      t_params(form), grid)
    g_acc, g_scene = torch.autograd.grad(img, (acc, scene),
                                         torch.as_tensor(x["grad"]))
    return img.detach(), g_acc, g_scene


@pytest.mark.parametrize("form", list(CASES))
def test_twin_is_the_adjoint_of_the_plain_composite(form):
    x = inputs(form)
    _, want, _ = autograd_of_plain(form, x)
    got = zg.composite_grad(torch.as_tensor(x["grad"]),
                            torch.as_tensor(x["scene"]),
                            torch.as_tensor(x["depth"]), t_params(form),
                            CASES[form][1], form)
    assert got.shape == want.shape == (4, *CASES[form][1][::-1])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the far clamp: depths past the volume put both taps on slice d - 1
    assert float(got[:, -1].abs().sum()) > 0.0


@pytest.mark.parametrize("form", list(CASES))
def test_twin_matches_jax_vjp(form):
    """composite_grad_plain against jax.vjp of JAX pipeline.composite at
    the route the form stands for (tentmm: the cells; rowmm: per pixel)."""
    (ih, iw), grid, impl = CASES[form]
    w, h, d = grid
    cfg = JRenderConfig(volume_width=w, volume_height=h, volume_depth=d,
                        image_width=iw, image_height=ih, composite_impl=impl)
    assert composite_route(vt.RenderConfig(**{
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(cfg)})) == form
    x = inputs(form, seed=1)
    jp = jfroxel.make_froxel_params(jnp.float32(FOV), jnp.float32(iw / ih),
                                    jnp.float32(NEAR), 100.0, 0.5, grid)
    acc_j = jnp.asarray(np.moveaxis(x["acc"], 0, -1))

    def f(acc, scene):
        return jpipeline.composite(cfg, jp, acc, scene,
                                   jnp.asarray(x["depth"]))

    _, vjp = jax.vjp(f, acc_j, jnp.asarray(x["scene"]))
    g_acc, g_scene = vjp(jnp.asarray(x["grad"]))
    got = zg.composite_grad_plain(
        torch.as_tensor(x["grad"]), torch.as_tensor(x["scene"]),
        torch.as_tensor(x["depth"]), t_params(form), grid, form)
    want = np.asarray(g_acc)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want,
                               rtol=1e-5,
                               atol=1e-7 + 1e-6 * np.abs(want).max())
    _, _, t_scene = autograd_of_plain(form, x)
    np.testing.assert_allclose(t_scene.numpy(), np.asarray(g_scene),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("form", list(CASES))
def test_function_plumbing_with_the_twins(form, monkeypatch):
    """CompositeFn with K4's launcher patched to its twin: the image and
    the scene colour's gradient are autograd of the plain composite bit for
    bit; the accumulation's gradient is K14's twin bit for bit (what
    composite_grad runs on CPU tensors), autograd's to 1e-6."""
    x = inputs(form, seed=2)
    want_img, want_acc, want_scene = autograd_of_plain(form, x)
    monkeypatch.setattr(zg, "_k4", lambda form_, *a: plain(form_)(*a))
    grid = CASES[form][1]
    acc = torch.as_tensor(x["acc"]).requires_grad_()
    scene = torch.as_tensor(x["scene"]).requires_grad_()
    img = zg.CompositeFn.apply(acc, scene, torch.as_tensor(x["depth"]),
                               t_params(form), grid, form)
    g_acc, g_scene = torch.autograd.grad(img, (acc, scene),
                                         torch.as_tensor(x["grad"]))
    twin = zg.composite_grad_plain(torch.as_tensor(x["grad"]),
                                   torch.as_tensor(x["scene"]),
                                   torch.as_tensor(x["depth"]),
                                   t_params(form), grid, form)
    assert torch.equal(img, want_img)
    assert torch.equal(g_acc, twin)
    torch.testing.assert_close(g_acc, want_acc, rtol=1e-6, atol=1e-6)
    assert torch.equal(g_scene, want_scene)
    # only acc: the scene colour's gradient is not computed
    acc2 = torch.as_tensor(x["acc"]).requires_grad_()
    img2 = zg.CompositeFn.apply(acc2, torch.as_tensor(x["scene"]),
                                torch.as_tensor(x["depth"]), t_params(form),
                                grid, form)
    (g2,) = torch.autograd.grad(img2, (acc2,), torch.as_tensor(x["grad"]))
    assert torch.equal(g2, twin)


def test_kernel_argument_that_requires_grad_raises():
    """cuda.ptr, where every launch takes its tensors' addresses, refuses a
    tensor that requires grad while grad is on: the kernel would drop its
    gradient without an error. Detached, or under no_grad, it passes."""
    from volumetricrenderer_tpu_torch.ops import cuda
    t = torch.zeros(4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="requires grad"):
        cuda.ptr(t)
    with pytest.raises(NotImplementedError, match="requires grad"):
        cuda.ptr(t * 2.0)
    assert cuda.ptr(t.detach()).value == t.data_ptr()
    with torch.no_grad():
        assert cuda.ptr(t).value == t.data_ptr()


def test_composite_refusals_under_grad():
    x = inputs("cells", seed=3)
    (ih, iw), grid, _ = CASES["cells"]
    w, h, d = grid
    p = t_params("cells")
    acc = torch.as_tensor(x["acc"])
    scene = torch.as_tensor(x["scene"])
    depth = torch.as_tensor(x["depth"])
    acc_g = acc.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="G-buffer"):
        zg.composite(acc_g, scene, depth.clone().requires_grad_(), p, grid)
    # a slab's band: the cells at row_off and the per-pixel y_map
    ext = torch.cat([acc[:, :, :1], acc, acc[:, :, -1:]], dim=2)
    band = (w, h - 2, d)
    rows = slice(ih // h, ih - ih // h)
    with pytest.raises(NotImplementedError, match="composite_zgather"):
        zg.composite(ext.clone().requires_grad_(), scene[rows], depth[rows],
                     p, band, row_off=1)
    with pytest.raises(NotImplementedError, match="composite_rowmm"):
        zg.composite_pixels(acc_g, scene, depth, p, grid, (h, ih, 0))
    # the co-sited composite at 1/2 on a 12x16 grid: 16x24 low pixels in
    # cells of 1x2
    cgrid = (12, 16, 8)
    acc_c = torch.as_tensor(np.random.default_rng(4).uniform(
        0, 1, (4, 8, 16, 12)).astype(np.float32))
    acc_cg = acc_c.clone().requires_grad_()
    lo = depth[::2, ::2].contiguous()
    w9 = zg.cell_weights(1, 2, 2)
    with pytest.raises(NotImplementedError, match="planes"):
        zg.composite_planes(acc_cg, lo, p, cgrid, w9)
    with pytest.raises(NotImplementedError, match="planes"):
        zg.composite_cosited(acc_cg, scene, depth, p, cgrid, 2)
    # without grad the same calls run
    with torch.no_grad():
        zg.composite(ext.clone().requires_grad_(), scene[rows],
                     depth[rows], p, band, row_off=1)
        zg.composite_cosited(acc_cg, scene, depth, p, cgrid, 2)
    zg.composite_pixels(acc, scene, depth, p, grid, (h, ih, 0))
    zg.composite_planes(acc_c, lo, p, cgrid, w9)
    with pytest.raises(ValueError, match="form"):
        zg.composite_grad(torch.as_tensor(x["grad"]), scene, depth, p, grid,
                          "cosited")
