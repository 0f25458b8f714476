"""The data-parallel training step of tests/test_torch_training.py: a gloo
rank's worker (spawned by torch.multiprocessing) and the one-process step
over every view that it is held against. Imports no JAX, so that a spawned
rank starts with torch and the port alone."""

import dataclasses

import numpy as np
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import inverse

# tests/test_parallel.py's CFG: map mode, the XLA scatter, the cells
# composite (48/16 and 32/16 are integers)
CFG = vt.RenderConfig(volume_width=16, volume_height=16, volume_depth=8,
                      image_width=48, image_height=32, shadow_map_size=32)
CAMERAS = ((-0.4, 1.9, -15.8), (-0.1, 2.0, -15.2))
LR = 5e-2


def setup():
    """(renderer, scene, state, FogParams, Adam, the views' inputs): the
    demo scene with its terrain cut to 4 steps of 1 octave, and per view
    its camera, a target, a scene colour and a view depth from one seed."""
    renderer = vt.VolumetricRenderer(CFG, device="cpu")
    scene = vt.demo_scene(aspect=48 / 32, device="cpu")
    scene = dataclasses.replace(scene, geometry=dataclasses.replace(
        scene.geometry, hf_steps=4, hf_octaves=1))
    params = inverse.FogParams.from_medium(scene.media[0])
    opt = torch.optim.Adam(params.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(0)
    n, ih, iw = len(CAMERAS), CFG.image_height, CFG.image_width
    views = (torch.tensor(CAMERAS, dtype=torch.float32),
             torch.as_tensor(rng.uniform(0.1, 0.4, (n, ih, iw, 3))
                             .astype(np.float32)),
             torch.full((n, ih, iw, 3), 0.1),
             torch.as_tensor(rng.uniform(20.0, 80.0, (n, ih, iw))
                             .astype(np.float32)))
    return renderer, scene, renderer.init_state(1), params, opt, views


def reference_step():
    """One process's step over every view: the mean of the views' losses,
    its gradient, one Adam step. Returns (loss, {name: parameter})."""
    renderer, scene, state, params, opt, views = setup()
    cams, targets, colors, depths = views
    opt.zero_grad()
    losses = []
    for i in range(len(cams)):
        sc = dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, position=cams[i]))
        losses.append(inverse.render_loss(renderer, params, sc, state,
                                          targets[i], colors[i], depths[i]))
    loss = torch.stack(losses).mean()
    loss.backward()
    opt.step()
    return float(loss.detach()), {n: p.detach().clone()
                                  for n, p in params.named_parameters()}


def rank_main(rank: int, world: int, store_path: str, out_path: str) -> None:
    """Rank `rank` of `world` gloo ranks: make_sharded_train_step on its
    share of the views; rank 0 saves the loss and the parameters."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        renderer, scene, state, params, opt, views = setup()
        share = slice(rank * len(CAMERAS) // world,
                      (rank + 1) * len(CAMERAS) // world)
        step = inverse.make_sharded_train_step(renderer, opt)
        loss = step(params, scene, state, *(v[share] for v in views))
        if rank == 0:
            torch.save({"loss": float(loss),
                        "params": {n: p.detach().clone()
                                   for n, p in params.named_parameters()}},
                       out_path)
    finally:
        dist.destroy_process_group()
