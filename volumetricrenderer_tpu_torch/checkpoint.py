"""Checkpoint and resume of the cross-frame state.

Port of `volumetricrenderer_tpu/checkpoint.py`'s `save_state` /
`load_state`: a FrameState is written to one `.npz` file, each history by
its field name and `frame_count` beside them, and restored into the
structure of a `like` state. A history that exists on one side only (the
material and scatter histories exist only while their blends are on) or a
shape that differs raises ValueError. Volumes are stored as float32 (a
bfloat16 volume converts exactly both ways) and come back on `like`'s
device and dtype.
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
