"""The training path's edges on the CPU, without JAX: checkpoints
(checkpoint.py), the refusals under grad (renderer.check_differentiable)
and the data-parallel step (inverse.make_sharded_train_step).

  * checkpoint: a state saved and loaded after 3 frames resumes bit for bit
    (frame_count included); a shape and a structure mismatch (a scatter
    history on one side only) each raise ValueError;
  * refusals: with the fog's parameters requiring grad, every frame whose
    JAX route reaches a Pallas kernel raises NotImplementedError naming
    it -- the fused frame, the scatter kernel, the raycast sun kernel, the
    cascaded-PCF kernel, reproj_impl="pallas", the zgather composite at an
    eligible shape, the co-sited composite of composite_upsample=2, a slab,
    and the SSR march of render_frame_post; the same frame without grad
    renders the image a scene without parameters renders, bit for bit;
  * the sharded step: two gloo ranks spawned by torch.multiprocessing (a
    FileStore in tmp_path, one view each; the join waits at most 120 s)
    against one process's step over both views (tests/torch_sharded_
    worker.py): loss and updated parameters to 1e-6 relative (the ranks'
    gradients are summed by all_reduce, then halved)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import inverse
from volumetricrenderer_tpu_torch.checkpoint import load_state, save_state
from volumetricrenderer_tpu_torch.parallel.shard_render import \
    make_multislab_render
from volumetricrenderer_tpu_torch.post import PostConfig

import torch_sharded_worker as worker

CKPT = vt.RenderConfig(volume_width=16, volume_height=16, volume_depth=8,
                       image_width=32, image_height=32, shadow_mode="raycast",
                       temporal_blend_accumulation=True,
                       temporal_blend_alpha=0.5)


def ckpt_scene():
    """tests/test_checkpoint_inverse.py's scene: a sun and the fog."""
    return vt.Scene(
        camera=vt.Camera.create(position=(0.0, 2.0, -10.0),
                                forward=(0, 0, 1), aspect=1.0,
                                device="cpu"),
        dir_lights=vt.DirectionalLights.create(
            direction=[(0.3, -0.7, 0.5)], color=[(1, 1, 1)],
            intensity=[2.0], has_shadow=[False], device="cpu"),
        point_lights=vt.PointLights.create(np.zeros((0, 3)),
                                           np.zeros((0, 3)), [], [],
                                           device="cpu"),
        spot_lights=vt.SpotLights.create(
            np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), [], [],
            [], device="cpu"),
        media=(vt.Medium.create(phase_g=0.3, absorption=0.19,
                                device="cpu"),),
        geometry=vt.Geometry.create(device="cpu"),
        ambient=torch.tensor((0.08, 0.09, 0.11)))


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    r = vt.VolumetricRenderer(CKPT, device="cpu")
    scene = ckpt_scene()
    state = r.init_state(1)
    for i in range(3):
        _, _, state = r.render_frame(state, scene, 0.1 * i)
    path = str(tmp_path / "state.npz")
    save_state(path, state)
    restored = load_state(path, r.init_state(1))
    assert restored.frame_count == state.frame_count == 3
    for f in ("prev_shadow", "prev_accumulation", "prev_world_to_view"):
        assert torch.equal(getattr(restored, f), getattr(state, f)), f
    img_a, _, _ = r.render_frame(state, scene, 0.5)
    img_b, _, _ = r.render_frame(restored, scene, 0.5)
    assert torch.equal(img_a, img_b)


def test_checkpoint_mismatches_raise(tmp_path):
    r = vt.VolumetricRenderer(CKPT, device="cpu")
    path = str(tmp_path / "state.npz")
    save_state(path, r.init_state(1))
    shallow = vt.VolumetricRenderer(dataclasses.replace(CKPT,
                                                        volume_depth=4),
                                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_state(path, shallow.init_state(1))
    blended = vt.VolumetricRenderer(dataclasses.replace(
        CKPT, temporal_blend_scatter=True), device="cpu")
    with pytest.raises(ValueError, match="one side only"):
        load_state(path, blended.init_state(1))
    path2 = str(tmp_path / "scatter.npz")
    save_state(path2, blended.init_state(1))
    with pytest.raises(ValueError, match="one side only"):
        load_state(path2, r.init_state(1))


# --------------------------------------------------------------------------
# Refusals under grad
# --------------------------------------------------------------------------

SMALL = dict(volume_width=16, volume_height=15, volume_depth=8,
             image_width=128, image_height=120, shadow_map_size=64)
XLA_ROUTE = dict(SMALL, frame_fused=False, shadow_mode="raycast",
                 scatter_impl="xla", dir_shadow_impl="xla",
                 accumulate_impl="xla", reproj_impl="windowed",
                 material_impl="xla", composite_impl="tentmm")
# name -> (config, what the refusal names)
REFUSED = {
    "fused": (dataclasses.replace(vt.FULL_CONFIG, **SMALL),
              "frame_volume_fused"),
    "scatter_kernel": (dataclasses.replace(vt.FULL_CONFIG, frame_fused=False,
                                           **SMALL), "scatter_local_pallas"),
    "dir_shadow": (vt.RenderConfig(**dict(XLA_ROUTE,
                                          dir_shadow_impl="pallas")),
                   "dir_shadow_pallas"),
    "pcf": (vt.RenderConfig(**dict(XLA_ROUTE, shadow_mode="map_dir",
                                   dir_shadow_impl="pallas")),
            "pcf_dir_shadow_pallas"),
    "reproj": (vt.RenderConfig(**dict(XLA_ROUTE, reproj_impl="pallas")),
               "fused_temporal_blend"),
    "zgather": (vt.RenderConfig(**dict(XLA_ROUTE, composite_impl="zgather")),
                "composite_zgather "),
    "cosited": (dataclasses.replace(vt.UHD_CONFIG, **dict(
        XLA_ROUTE, image_width=256, image_height=240,
        composite_impl="zgather")),
                "composite_zgather_planes"),
    "pallas_composite": (vt.RenderConfig(**dict(XLA_ROUTE,
                                                composite_impl="pallas")),
                         "composite_pallas"),
}


@pytest.fixture(scope="module")
def bench():
    """benchmark_scene with 2 local lights and procedural fog, at the small
    shapes' aspect."""
    return vt.benchmark_scene(aspect=128 / 120, num_local_lights=2,
                              noise_mode="procedural", device="cpu")


def fog_scene(scene, grad: bool):
    """The scene with its fog from FogParams (requiring grad or not)."""
    fog = inverse.FogParams.from_medium(scene.media[0])
    fog.requires_grad_(grad)
    return inverse.scene_with_fog(fog, scene)


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_under_grad(bench, name):
    cfg, kernel = REFUSED[name]
    r = vt.VolumetricRenderer(cfg, device="cpu")
    state = r.init_state(1)
    with pytest.raises(NotImplementedError, match=kernel):
        r.render_frame(state, fog_scene(bench, True), 0.0)
    with torch.no_grad():
        img, _, _ = r.render_frame(state, fog_scene(bench, True), 0.0)
    img_plain, _, _ = r.render_frame(state, fog_scene(bench, False), 0.0)
    assert torch.equal(img, img_plain)
    assert bool(torch.isfinite(img).all()) and float(img.std()) > 0.0


def test_slab_and_ssr_refused_under_grad(bench):
    cfg = dataclasses.replace(vt.FULL_CONFIG, **dict(
        SMALL, volume_height=16, image_height=128))
    r = vt.VolumetricRenderer(cfg, device="cpu")
    sc, vd = r.render_scene_inputs(bench)
    fn = make_multislab_render(r, 2, fixed_inputs=(list(sc.chunk(2)),
                                                   list(vd.chunk(2))))
    carry = fn.init_carry(1)
    with pytest.raises(NotImplementedError, match="slab"):
        fn(carry, fog_scene(bench, True), 0.0)
    with torch.no_grad():
        bands, _ = fn(carry, fog_scene(bench, True), 0.0)
    assert bool(torch.isfinite(torch.cat(bands)).all())
    # render_frame_post with SSR on: K13 has no backward
    post = PostConfig(ssr_intensity=0.5, ssr_max_px=8)
    flat = vt.VolumetricRenderer(vt.RenderConfig(**XLA_ROUTE), device="cpu")
    with pytest.raises(NotImplementedError, match="ssr_march_pallas"):
        flat.render_frame_post(flat.init_state(1), fog_scene(bench, True),
                               post)
    rgb, _, _ = flat.render_frame_post(flat.init_state(1),
                                       fog_scene(bench, False), post)
    assert bool(torch.isfinite(rgb).all())


def test_plain_route_is_differentiable(bench):
    """XLA_ROUTE (the JAX package's differentiable route) renders under
    grad: the fog's gradient is finite and non-zero."""
    r = vt.VolumetricRenderer(vt.RenderConfig(**XLA_ROUTE), device="cpu")
    fog = inverse.FogParams.from_medium(bench.media[0])
    img, _, _ = r.render_frame(r.init_state(1),
                               inverse.scene_with_fog(fog, bench), 0.0)
    img[..., :3].square().mean().backward()
    grads = [p.grad for p in fog.parameters()]
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in grads)
    assert any(float(g.abs().max()) > 0.0 for g in grads)


# --------------------------------------------------------------------------
# The data-parallel step on two gloo ranks
# --------------------------------------------------------------------------

def test_sharded_step_matches_one_process(tmp_path):
    out = str(tmp_path / "rank0.pt")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.rank_main,
                         args=(rank, 2, str(tmp_path / "store"), out))
             for rank in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    got = torch.load(out)
    loss, params = worker.reference_step()
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    assert got["params"].keys() == params.keys()
    for name, want in params.items():
        torch.testing.assert_close(got["params"][name], want, rtol=1e-6,
                                   atol=0.0, msg=name)
