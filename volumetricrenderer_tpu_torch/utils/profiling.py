"""Tracing and profiling.

Counterpart of `volumetricrenderer_tpu/utils/profiling.py`:

- the renderer's passes run inside `scope` ranges named as the JAX
  package's `jax.named_scope`s (PASS_NAMES), so a profiler trace carries
  the pass names as the reference's named CommandBuffers did;
- `trace()` wraps torch.profiler over the CPU and, where there is one, the
  GPU, and writes a Chrome trace (chrome://tracing, Perfetto);
- `FrameTimer` measures steady-state ms per frame, synchronizing the
  outputs' device.

A torch.profiler.record_function range costs two dispatcher calls, ~11 us
of host time on the card's host even while no profiler records (PERF.md),
where a jax.named_scope costs nothing at run time: `scope` opens one only
while a profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List

import torch

# the JAX renderer's jax.named_scope names, in its pass order (composite
# is scoped twice there: after the staged passes and after volume_fused)
PASS_NAMES = ("gbuffer", "shadow_maps", "write_material_volume",
              "shadow_blend", "write_shadow_volume", "temporal_blend_shadow",
              "write_scatter_volume", "integrate_blend", "accumulate",
              "temporal_blend_accumulation", "composite", "bake_noise_tex",
              "volume_fused")


def scope(name: str):
    """A torch.profiler.record_function range named `name` while a profiler
    records, else a no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str, file_name: str = "trace.json"):
    """Profile the block on the CPU and, when CUDA is available, the GPU;
    write a Chrome trace to logdir/file_name on exit. Yields the
    torch.profiler.profile object (key_averages() for sums by name)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, file_name))


def _sync(out) -> None:
    """Wait for the devices of every CUDA tensor in `out` (nested tuples,
    lists and dicts; dataclasses by their fields)."""
    seen = set()

    def walk(o):
        if isinstance(o, torch.Tensor):
            if o.device.type == "cuda" and o.device not in seen:
                seen.add(o.device)
                torch.cuda.synchronize(o.device)
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (tuple, list)):
            for v in o:
                walk(v)
        elif hasattr(o, "__dataclass_fields__"):
            for name in o.__dataclass_fields__:
                walk(getattr(o, name))

    walk(out)


class FrameTimer:
    """Steady-state frame timing: call per frame; durations include the
    device synchronization."""

    def __init__(self):
        self.times: List[float] = []

    def measure(self, fn: Callable, *args, n_warmup: int = 3,
                n_measure: int = 20):
        out = None
        for _ in range(n_warmup):
            out = fn(*args)
        _sync(out)
        self.times.clear()
        for _ in range(n_measure):
            t0 = time.perf_counter()
            out = fn(*args)
            _sync(out)
            self.times.append(time.perf_counter() - t0)
        return out

    @property
    def median_ms(self) -> float:
        s = sorted(self.times)
        return s[len(s) // 2] * 1e3

    @property
    def best_ms(self) -> float:
        return min(self.times) * 1e3
