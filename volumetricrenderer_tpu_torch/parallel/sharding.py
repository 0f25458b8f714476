"""Multi-device scale-out on torch.distributed.

Port of `volumetricrenderer_tpu/parallel/sharding.py`. The JAX module puts
arrays on a device mesh and lets the GSPMD partitioner insert the
collectives. A torch.distributed program is one process per rank, each
holding its own shard, so here the mesh is the process group and every
function takes and returns the calling rank's shard; the collectives are
written out:

  make_mesh              Mesh: a group, this rank, the group's size and this
                         rank's device
  shard_state            this rank's rows (H axis) of a plain global state
  make_sharded_render    the unsharded frame's contract (image and state
                         equal to render_frame's) over make_shardmap_render:
                         this rank's image band and rows of the new state
  accumulate_zsharded    front-to-back integration with the froxel Z axis
                         split over the ranks: each scans its block
                         (ops/scatter_scan.accumulate_blocked), all_gathers
                         the block totals and composes its exclusive prefix
  light_sharded_scatter  the plain XLA scatter (pipeline.write_scatter_xla)
                         of each rank's subset of the local lights, summed by
                         all_reduce; the suns and the extinction added once

Nothing here picks a backend or a device. The caller initialises the
process group (init_process_group with its address, world size and rank)
and names this rank's device. NCCL carries CUDA tensors; gloo carries host
tensors, so under a gloo group with CUDA data every collective here stages
its (small) payload through host memory explicitly: `.cpu()` before it and
back to the device after it. The work itself stays on the rank's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from volumetricrenderer_tpu_torch import pipeline
from volumetricrenderer_tpu_torch.models.lights import (DirectionalLights,
                                                        PointLights,
                                                        SpotLights)
from volumetricrenderer_tpu_torch.ops.scatter_scan import accumulate_blocked
from volumetricrenderer_tpu_torch.state import FrameState


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group, seen from one of them."""
    group: Any               # torch.distributed ProcessGroup, None: default
    rank: int                # this process's rank in the group
    size: int                # ranks in the group
    device: torch.device     # this rank's device, where its shard lives
    backend: str             # the group's backend ("nccl", "gloo")

    @property
    def host_staged(self) -> bool:
        """Whether collectives stage CUDA payloads through host memory:
        gloo carries host tensors only."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def peer(self, group_rank: int) -> int:
        """The global rank of the group's rank `group_rank` (point-to-point
        operations address global ranks)."""
        if self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the backend carries it: on the host under gloo."""
        return t.cpu() if self.host_staged else t.contiguous()

    def from_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A received tensor back on this rank's device."""
        return t.to(self.device) if self.host_staged else t


def make_mesh(device, group=None) -> Mesh:
    """The Mesh of `group` (None: the default group, which the caller has
    initialised) with this rank's shard on `device`. NCCL needs CUDA
    devices; gloo takes either, staging CUDA payloads through the host."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    device = torch.device(device)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group carries CUDA tensors, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh")
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device,
                backend=backend)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[size, *t.shape]: every rank's `t`, in rank order, on mesh.device."""
    x = mesh.to_wire(t)
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return mesh.from_wire(torch.stack(parts))


def _all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's `t`, on mesh.device."""
    x = mesh.to_wire(t).clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return mesh.from_wire(x)


# the histories split along H, each [C, D, H, W] (H axis 2)
_H_FIELDS = ("prev_shadow", "prev_material_a", "prev_scatter",
             "prev_accumulation")


def shard_state(state: FrameState, mesh: Mesh) -> FrameState:
    """This rank's rows of a plain global state on mesh.device: each
    history's H axis cut into mesh.size equal blocks, block mesh.rank; the
    view matrix and the frame count as they are."""
    def rows(x):
        if x is None:
            return None
        h = x.shape[2]
        if h % mesh.size:
            raise ValueError(f"{h} rows do not split into {mesh.size} ranks")
        hl = h // mesh.size
        return x.narrow(2, mesh.rank * hl, hl).contiguous().to(mesh.device)
    return dataclasses.replace(
        state, prev_world_to_view=state.prev_world_to_view.to(mesh.device),
        **{f: rows(getattr(state, f)) for f in _H_FIELDS})


def make_sharded_render(renderer, mesh: Mesh):
    """The unsharded frame on the mesh's ranks, each rendering its slab
    (parallel/shard_render.make_shardmap_render) on the renderer's device.

    Returns fn(state, scene, time_x) -> (image band [IH/n, IW, 4], new
    state): state is this rank's rows of a plain global state
    (shard_state), and so is the new state, so that the bands and the rows
    of all ranks put together are render_frame's image and state, as the
    JAX function's (GSPMD's partition of the unsharded program) are. Each
    rank computes the G-buffer of the whole image (render_scene_inputs)
    and takes its band; the state's halo rows are exchanged every frame
    (the plain layout's extension, shard_render._halo_rows).

    A slab's halo rows past the grid are froxels at clamped positions,
    which the jittered integrate and the windowed warp sample from their
    own neighbours, where the whole grid repeats its edge row; the slab
    path keeps them (the JAX package's slab semantics), and its composite
    reads them on the image rows nearest the global edges. The shards at
    the global edges here composite their band once more with those rows
    of the accumulation set to the edge row (_clamp_past_grid), as the
    whole grid's composite reads them."""
    from volumetricrenderer_tpu_torch.ops.zg_composite import \
        composite_frame
    from volumetricrenderer_tpu_torch.parallel.shard_render import (
        HALO_AXIS, crop_sharded_state, make_shardmap_render)
    fn = make_shardmap_render(renderer, mesh)
    ih = renderer.config.image_height // mesh.size
    band = slice(mesh.rank * ih, (mesh.rank + 1) * ih)
    h_loc = renderer.config.volume_height // mesh.size
    r_loc = fn.renderer

    def render(state: FrameState, scene, time_x):
        scene_color, view_depth = renderer.render_scene_inputs(scene)
        sc, vd = scene_color[band].contiguous(), view_depth[band].contiguous()
        image, new_state = fn(state, scene, time_x, sc, vd)
        if mesh.rank in (0, mesh.size - 1):
            acc = _clamp_past_grid(new_state.prev_accumulation.float(), mesh,
                                   fn.halo, h_loc, HALO_AXIS)
            image = composite_frame(r_loc.config, acc, sc, vd,
                                    r_loc.froxel_params(scene, fn.slab),
                                    fn.slab)
        return image, crop_sharded_state(new_state, 1, fn.halo)

    return render


def _clamp_past_grid(x: torch.Tensor, mesh: Mesh, p: int, h_loc: int,
                     axis: int) -> torch.Tensor:
    """A halo-extended history of a shard at a global edge with its p halo
    rows past the grid (before global row 0 on rank 0, after row H - 1 on
    the last rank) set to the edge row."""
    rep = lambda row: row.expand(*x.shape[:axis], p, *x.shape[axis + 1:])
    if mesh.rank == 0:
        x = torch.cat([rep(x.narrow(axis, p, 1)), x.narrow(axis, p, h_loc + p)],
                      dim=axis)
    if mesh.rank == mesh.size - 1:
        x = torch.cat([x.narrow(axis, 0, p + h_loc),
                       rep(x.narrow(axis, p + h_loc - 1, 1))], dim=axis)
    return x.contiguous()


def accumulate_zsharded(in_scatter: torch.Tensor, extinction: torch.Tensor,
                        step_lengths: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """Front-to-back integration with the froxel Z axis split over the
    mesh's ranks: this rank's block of ops/scatter_scan.accumulate_scan of
    the whole volume. in_scatter [3, D/n, H, W], extinction [D/n, H, W]
    and step_lengths [D/n] are this rank's Z block (rank r holds slices
    [r D/n, (r + 1) D/n)); returns its [4, D/n, H, W].

    The per-slice integral composes associatively, (L1, T1) + (L2, T2) =
    (L1 + T1 L2, T1 T2): each rank scans its block, all_gathers the blocks'
    totals ([n, 4, H, W], independent of D), composes the exclusive prefix
    of the ranks before it, in rank order as the JAX function does, and
    applies it to its block."""
    acc = accumulate_blocked(in_scatter, extinction, step_lengths)
    totals = _all_gather(mesh, acc[:, -1])                  # [n, 4, H, W]
    l_pre = torch.zeros_like(totals[0, :3])
    t_pre = torch.ones_like(totals[0, 3])
    for k in range(mesh.rank):
        l_pre = l_pre + t_pre[None] * totals[k, :3]
        t_pre = t_pre * totals[k, 3]
    return torch.cat([l_pre[:, None] + t_pre[None, None] * acc[:3],
                      (t_pre[None] * acc[3])[None]])


def _light_block(lights, mesh: Mesh):
    """This rank's contiguous block of a light set (every field's leading
    axis), the count dividing into the mesh's ranks."""
    n = lights.count
    if n % mesh.size:
        raise ValueError(f"{n} lights do not split into {mesh.size} ranks: "
                         "pad with zero-intensity lights")
    per = n // mesh.size
    return dataclasses.replace(lights, **{
        f.name: getattr(lights, f.name)[mesh.rank * per:(mesh.rank + 1) * per]
        for f in dataclasses.fields(lights)})


def light_sharded_scatter(cfg, geo, shadow: torch.Tensor, material, scene,
                          mesh: Mesh) -> torch.Tensor:
    """The plain XLA scatter (pipeline.write_scatter_xla: cfg, the frame's
    geometry record, the blended sun shadow [Nd, D, H, W], the material
    volumes and the scene, on mesh.device) with the local lights split over
    the mesh's ranks: each rank scatters its contiguous block of the point
    and of the spot lights (each count must divide into the ranks: pad with
    zero-intensity lights), the partial volumes' light is summed by one
    all_reduce, and the suns' terms and the extinction, computed on every
    rank, are added once. Returns the whole [4, D, H, W] on every rank. As
    in the JAX function, no cube or spot map reaches the scatter (in map
    mode the local lights go unshadowed)."""
    dev = shadow.device
    part = dataclasses.replace(
        scene, dir_lights=DirectionalLights.empty(device=dev),
        point_lights=_light_block(scene.point_lights, mesh),
        spot_lights=_light_block(scene.spot_lights, mesh))
    local = _all_reduce_sum(mesh, pipeline.write_scatter_xla(
        cfg, geo, shadow, material, part)[:3])
    base = pipeline.write_scatter_xla(
        cfg, geo, shadow, material, dataclasses.replace(
            scene, point_lights=PointLights.empty(device=dev),
            spot_lights=SpotLights.empty(device=dev)))
    return base + torch.cat([local, torch.zeros_like(local[:1])])
