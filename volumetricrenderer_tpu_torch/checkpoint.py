"""Checkpoint and resume of the cross-frame state.

Port of `volumetricrenderer_tpu/checkpoint.py`'s `save_state` /
`load_state`: a FrameState is written to one `.npz` file, each history by
its field name and `frame_count` beside them, and restored into the
structure of a `like` state. A history that exists on one side only (the
material and scatter histories exist only while their blends are on) or a
shape that differs raises ValueError. Volumes are stored as float32 (a
bfloat16 volume converts exactly both ways) and come back on `like`'s
device and dtype.

`save_state_orbax` / `load_state_orbax` keep the JAX package's names for its
distributed pair (orbax there); their backend here is
torch.distributed.checkpoint (DCP): a directory of shards and metadata,
written and read with or without a process group. Under a group each rank
passes its rows of the state (parallel/sharding.shard_state: each
history's H axis cut into equal blocks), and each history is saved as a
DTensor sharded on that axis (Shard(2)) over a one-dimensional device mesh
of the group's ranks: DCP then keeps every rank's rows, where same-key
plain tensors would be de-duplicated to rank 0's. The view matrix and the
frame count are the same on every rank and are saved once. Loading asks
for `like`'s rows (a state of the same structure on this rank) and
restores exactly them. Histories present on one side only, or of another
shape, raise ValueError as in the .npz pair.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from volumetricrenderer_tpu_torch.state import FrameState

FIELDS = tuple(f.name for f in dataclasses.fields(FrameState))


def save_state(path: str, state: FrameState) -> None:
    """Write `state` to `path` (np.savez: `.npz` is appended if missing)."""
    arrays = {}
    for name in FIELDS:
        v = getattr(state, name)
        if v is None:
            continue
        arrays[name] = np.int64(v) if name == "frame_count" \
            else v.detach().to("cpu", torch.float32).numpy()
    np.savez(path, **arrays)


def load_state(path: str, like: FrameState) -> FrameState:
    """The state saved at `path`, in the structure of `like` (the state of
    a renderer with the same config, e.g. its init_state): the same
    histories present, each of the same shape, else ValueError."""
    with np.load(path) as data:
        saved = set(data.files)
        present = {n for n in FIELDS if getattr(like, n) is not None}
        if saved != present:
            raise ValueError(
                f"checkpoint holds {sorted(saved)} but `like` has "
                f"{sorted(present)}: a history present on one side only "
                "(the material and scatter histories exist only while their "
                "blends are on)")
        fields = {}
        for name in sorted(present):
            a = data[name]
            if name == "frame_count":
                fields[name] = int(a)
                continue
            ref = getattr(like, name)
            if a.shape != tuple(ref.shape):
                raise ValueError(f"checkpoint {name} has shape {a.shape}, "
                                 f"the state {tuple(ref.shape)}")
            fields[name] = torch.as_tensor(a).to(ref.device, ref.dtype)
    return dataclasses.replace(like, **fields)


def _dcp_world():
    """The default process group's world size, or None without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return None


def _dcp_dict(state: FrameState, world, copy: bool) -> dict:
    """DCP's state dict of `state`: each history a DTensor of this rank's
    rows under a group (Shard(2) over the ranks), else the tensor; the view
    matrix, and frame_count as a 0-d int64 tensor. copy=True gives fresh
    tensors for DCP to load into."""
    own = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    out = {}
    mesh = None
    for name in FIELDS:
        v = getattr(state, name)
        if v is None:
            continue
        if name == "frame_count":
            out[name] = torch.tensor(int(v), dtype=torch.int64)
        elif name == "prev_world_to_view" or world is None:
            out[name] = own(v)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Shard
            if mesh is None:
                mesh = init_device_mesh(v.device.type, (world,))
            out[name] = DTensor.from_local(own(v).contiguous(), mesh,
                                           [Shard(2)], run_check=False)
    return out


def save_state_orbax(path: str, state: FrameState) -> None:
    """Write `state` into the directory `path` with DCP (under a process
    group: this rank's rows, every rank calling)."""
    import torch.distributed.checkpoint as dcp
    world = _dcp_world()
    dcp.save(_dcp_dict(state, world, copy=False), checkpoint_id=path,
             no_dist=world is None)


def load_state_orbax(path: str, like: FrameState) -> FrameState:
    """The state saved at `path` by save_state_orbax, in the structure of
    `like` (under a process group: this rank's rows, every rank calling):
    the same histories present, each of the same shape, else ValueError."""
    import torch.distributed.checkpoint as dcp
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    present = {n for n in FIELDS if getattr(like, n) is not None}
    if set(meta) != present:
        raise ValueError(
            f"checkpoint holds {sorted(meta)} but `like` has "
            f"{sorted(present)}: a history present on one side only (the "
            "material and scatter histories exist only while their blends "
            "are on)")
    world = _dcp_world()
    target = _dcp_dict(like, world, copy=True)
    for name, t in target.items():
        want = tuple(meta[name].size)
        if tuple(t.shape) != want:
            raise ValueError(f"checkpoint {name} has shape {want}, the "
                             f"state {tuple(t.shape)}")
    dcp.load(target, checkpoint_id=path, no_dist=world is None)
    fields = {}
    for name, t in target.items():
        if name == "frame_count":
            fields[name] = int(t)
        else:
            local = t.to_local() if hasattr(t, "to_local") else t
            ref = getattr(like, name)
            fields[name] = local.to(ref.device, ref.dtype)
    return dataclasses.replace(like, **fields)
