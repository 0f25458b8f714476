"""The gloo world of tests/test_torch_shardmap.py: what each rank runs
(spawned by torch.multiprocessing) and the inputs that the test holds its
results against. Imports no JAX, so that a spawned rank starts with torch
and the port alone.

Each rank of a 2-rank gloo group on the CPU runs, on its shard:
  * make_shardmap_render over three frames of a moving camera from the
    plain layout (shard_state of the renderer's init_state: frame 0 goes
    through _halo_rows, frames 1 and 2 through _refresh_halo), and one
    frame from fn.init_state (the steady layout);
  * make_sharded_render over two frames (map mode, the XLA scatter);
  * accumulate_zsharded on its Z block of a seeded volume;
  * light_sharded_scatter on its half of 8 point and 8 spot lights;
  * checkpoint.save_state_orbax of its rows of a seeded state (DCP, every
    history a DTensor sharded on H), then load_state_orbax of them into
    its rows of a fresh state;
and saves what came out to rank<r>.pt."""

import dataclasses

import numpy as np
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel, pipeline
from volumetricrenderer_tpu_torch.jitter import jitter_for_frame
from volumetricrenderer_tpu_torch.parallel import sharding
from volumetricrenderer_tpu_torch.parallel.shard_render import (
    crop_sharded_state, make_shardmap_render)

WORLD = 2
# the production impl set (the fused frame: K1-K4's twins) at 16x16x8
SHARDMAP = dataclasses.replace(vt.FULL_CONFIG, volume_width=16,
                               volume_height=16, volume_depth=8,
                               image_width=48, image_height=32)
# tests/test_parallel.py's CFG: map mode, the XLA scatter and scan
SHARDED = vt.RenderConfig(volume_width=16, volume_height=16, volume_depth=8,
                          image_width=48, image_height=32,
                          shadow_map_size=32)
# tests/test_parallel.py's light-sharded scatter
LIGHTS = vt.RenderConfig(volume_width=16, volume_height=16, volume_depth=8,
                         image_width=32, image_height=32,
                         shadow_mode="raycast")
SCAN_DHW = (32, 8, 16)


def scenes(cfg, n: int):
    """benchmark_scene with 4 local lights, its camera moved each frame."""
    base = vt.benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                              num_local_lights=4, noise_mode="procedural",
                              device="cpu")
    cam = base.camera
    return [dataclasses.replace(base, camera=dataclasses.replace(
        cam, position=cam.position + torch.tensor([0.3, 0.25, 0.2]) * i))
        for i in range(n)]


def scan_inputs():
    """(in_scatter [3, D, H, W], extinction [D, H, W], step_lengths [D])
    from one seed, at tests/test_parallel.py's shape."""
    rng = np.random.default_rng(3)
    d, h, w = SCAN_DHW
    return (torch.as_tensor(rng.uniform(size=(3, d, h, w)), dtype=torch.float32),
            torch.as_tensor(rng.uniform(size=(d, h, w)) * 0.3,
                            dtype=torch.float32),
            torch.as_tensor(rng.uniform(size=(d,)) * 2.0 + 0.1,
                            dtype=torch.float32))


def light_inputs():
    """(cfg, geometry record, shadow, material, scene) of
    tests/test_parallel.py's light-sharded scatter: 8 point and 8 spot
    lights on circles, one sun, constant material volumes."""
    cfg = LIGHTS
    cam = vt.Camera.create(position=(0.0, 2.0, -10.0),
                           forward=(0.0, 0.0, 1.0), aspect=1.0, device="cpu")
    n = 8
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    points = vt.PointLights.create(
        position=np.stack([5 * np.cos(a), np.full(n, 3.0),
                           5 * np.sin(a) + 5.0], axis=-1),
        color=np.tile([[1.0, 0.6, 0.3]], (n, 1)), intensity=np.full(n, 5.0),
        range=np.full(n, 20.0), has_shadow=[False] * n, device="cpu")
    spots = vt.SpotLights.create(
        position=np.stack([4 * np.sin(a), np.full(n, 5.0),
                           4 * np.cos(a) + 6.0], axis=-1),
        direction=np.tile([[0.2, -0.9, 0.3]], (n, 1)),
        color=np.tile([[0.3, 0.8, 1.0]], (n, 1)), intensity=np.full(n, 4.0),
        range=np.full(n, 25.0), spot_angle_deg=np.full(n, 60.0),
        has_shadow=[False] * n, device="cpu")
    suns = vt.DirectionalLights.create(
        direction=[(0.3, -0.7, 0.5)], color=[(1, 1, 1)], intensity=[2.0],
        has_shadow=[False], device="cpu")
    scene = vt.Scene(camera=cam, dir_lights=suns, point_lights=points,
                     spot_lights=spots, media=(),
                     geometry=vt.Geometry.create(device="cpu"),
                     ambient=torch.zeros(3))
    params = froxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near,
                                       cfg.volume_distance,
                                       cfg.depth_distribution, cfg.grid)
    v2w = cam.view_to_world()
    geo = pipeline.FrameGeometry(params=params, view_to_world=v2w,
                                 prev_world_to_view=froxel.invert_rigid(v2w),
                                 jitter=torch.as_tensor(jitter_for_frame(0)),
                                 alpha=0.0, grid=cfg.grid)
    d, h, w = cfg.grid_dhw
    mat_a = torch.full((4, d, h, w), 0.01)
    mat_b = torch.full((1, d, h, w), 0.3)
    return cfg, geo, torch.ones((1, d, h, w)), (mat_a, mat_b), scene


def seeded_state(cfg=SHARDED) -> "vt.FrameState":
    """A whole-grid state of cfg with seeded histories (the material and
    scatter ones too), view matrix and frame count."""
    rng = np.random.default_rng(11)
    d, h, w = cfg.grid_dhw
    vol = lambda c: torch.as_tensor(rng.uniform(size=(c, d, h, w)),
                                    dtype=torch.float32)
    return vt.FrameState(
        prev_shadow=vol(1), prev_accumulation=vol(4),
        prev_world_to_view=torch.as_tensor(rng.uniform(size=(4, 4)),
                                           dtype=torch.float32),
        frame_count=5, prev_material_a=vol(4), prev_scatter=vol(4))


def _checkpoint(mesh, path: str) -> dict:
    """This rank's rows of seeded_state saved with DCP and loaded into its
    rows of a fresh state of the same structure."""
    from volumetricrenderer_tpu_torch.checkpoint import (load_state_orbax,
                                                         save_state_orbax)
    state = sharding.shard_state(seeded_state(), mesh)
    save_state_orbax(path, state)
    like = sharding.shard_state(vt.FrameState.create(
        SHARDED.grid_dhw, 1, device="cpu", with_material=True,
        with_scatter=True), mesh)
    back = load_state_orbax(path, like)
    return {"histories": histories(back),
            "view": back.prev_world_to_view,
            "frame_count": back.frame_count}


def histories(state) -> dict:
    """A state's histories by name (the ones it holds), as torch.save
    stores plain tensors."""
    return {f: getattr(state, f) for f in ("prev_shadow", "prev_material_a",
                                           "prev_scatter",
                                           "prev_accumulation")
            if getattr(state, f) is not None}


def _shardmap(mesh):
    r = vt.VolumetricRenderer(SHARDMAP, device="cpu")
    fn = make_shardmap_render(r, mesh)
    ih = SHARDMAP.image_height // mesh.size
    band = slice(mesh.rank * ih, (mesh.rank + 1) * ih)
    crop = lambda s: histories(crop_sharded_state(s, 1, fn.halo))
    out = {"bands": [], "states": []}
    state = sharding.shard_state(r.init_state(1), mesh)
    for i, s in enumerate(scenes(SHARDMAP, 3)):
        sc, vd = r.render_scene_inputs(s)
        img, state = fn(state, s, 0.1 * i, sc[band], vd[band])
        out["bands"].append(img)
        out["states"].append(crop(state))
        if i == 0:
            img0, st0 = fn(fn.init_state(1), s, 0.0, sc[band], vd[band])
            out["steady"] = (img0, crop(st0))
    out["halo"] = fn.halo
    return out


def _sharded(mesh):
    r = vt.VolumetricRenderer(SHARDED, device="cpu")
    render = sharding.make_sharded_render(r, mesh)
    state = sharding.shard_state(r.init_state(1), mesh)
    out = []
    for i, s in enumerate(scenes(SHARDED, 2)):
        img, state = render(state, s, 0.1 * i)
        out.append((img, histories(state)))
    return out


def rank_main(rank: int, store_path: str, out_dir: str) -> None:
    """Rank `rank` of the 2-rank gloo world (a FileStore at store_path):
    runs everything above and saves it to out_dir/rank<rank>.pt."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        mesh = sharding.make_mesh("cpu")
        out = {"shardmap": _shardmap(mesh), "sharded": _sharded(mesh)}
        scat, ext, steps = scan_inputs()
        dz = SCAN_DHW[0] // WORLD
        z = slice(rank * dz, (rank + 1) * dz)
        out["zscan"] = sharding.accumulate_zsharded(scat[:, z], ext[z],
                                                    steps[z], mesh)
        out["lights"] = sharding.light_sharded_scatter(*light_inputs(),
                                                       mesh)
        out["checkpoint"] = _checkpoint(mesh, f"{out_dir}/dcp")
        out["backend"] = mesh.backend
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
