"""The port's utils/profiling.py and utils/cache.py on the CPU, without
JAX:

  * FrameTimer measures a function's calls (warm-up first; median and best
    of the measured ones);
  * trace() writes a Chrome trace under its log directory, holding the
    scope ranges of what ran inside it (a scope is a no-op outside a
    profiler);
  * the renderer's passes carry the JAX package's jax.named_scope names
    (profiling.PASS_NAMES, the 13 names of its 14 scopes): all of them
    appear as ranges in a CPU profile of three frames at a
    16x15x8 grid and 128x120 pixels of benchmark_scene -- DEMO_CONFIG's
    (the staged XLA route demo.py renders, its G-buffer and shadow maps
    baked in the frame), FULL_CONFIG's fused frame with a texture-noise fog
    and its staged frame (K5's and K3's routes);
  * enable_persistent_cache points ops/cuda.BUILD_DIR at its argument,
    else at VOLR_TORCH_CACHE, else at the package's _build/, returns it, can
    be called again with the same effect, and refuses to move the
    directory once a kernel library is loaded."""

import contextlib
import dataclasses
import json
import time

import pytest
import torch

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.ops import cuda
from volumetricrenderer_tpu_torch.ops.noise import perlin_texture_3d
from volumetricrenderer_tpu_torch.utils import cache, profiling

import torch_tolerance  # noqa: F401  (torch's threads under xdist)

TINY = dict(volume_width=16, volume_height=15, volume_depth=8,
            image_width=128, image_height=120)


def test_frame_timer_measures_calls():
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)
        return {"out": (torch.ones(3) * x,)}

    timer = profiling.FrameTimer()
    out = timer.measure(fn, 2.0, n_warmup=2, n_measure=5)
    assert len(calls) == 7 and len(timer.times) == 5
    assert torch.equal(out["out"][0], torch.full((3,), 2.0))
    assert 2.0 <= timer.best_ms <= timer.median_ms < 1e3


def test_trace_writes_a_chrome_trace(tmp_path):
    assert isinstance(profiling.scope("idle"), contextlib.nullcontext)
    with profiling.trace(str(tmp_path / "log")) as prof:
        with profiling.scope("my_pass"):
            torch.ones(64).cumsum(0)
    path = tmp_path / "log" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "my_pass" for e in events)
    assert "my_pass" in {e.key for e in prof.key_averages()}


def _frames():
    """(renderer, scene) of the three profiled frames."""
    demo_cfg = dataclasses.replace(vt.DEMO_CONFIG, shadow_map_size=32,
                                   **TINY)
    tex = vt.benchmark_scene(aspect=128 / 120, num_local_lights=2,
                             noise_tex=perlin_texture_3d(8),
                             noise_mode="texture", device="cpu")
    bench = vt.benchmark_scene(aspect=128 / 120, num_local_lights=2,
                               noise_mode="procedural", device="cpu")
    full = dataclasses.replace(vt.FULL_CONFIG, **TINY)
    return [(vt.VolumetricRenderer(demo_cfg, device="cpu"), bench),
            (vt.VolumetricRenderer(full, device="cpu"), tex),
            (vt.VolumetricRenderer(dataclasses.replace(
                full, frame_fused=False), device="cpu"), bench)]


def test_pass_ranges_in_a_profile():
    frames = _frames()
    assert frames[1][0].fuses_frame(frames[1][1])
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for r, scene in frames:
            r.render_frame(r.init_state(1), scene, 0.0)
    names = {e.key for e in prof.key_averages()}
    assert len(profiling.PASS_NAMES) == 13
    assert set(profiling.PASS_NAMES) <= names, \
        set(profiling.PASS_NAMES) - names


@pytest.fixture
def build_dir(monkeypatch):
    """ops/cuda's build directory and loaded libraries, restored after."""
    monkeypatch.setattr(cuda, "BUILD_DIR", cuda.BUILD_DIR)
    monkeypatch.setattr(cuda, "_LIBS", {})
    monkeypatch.delenv("VOLR_TORCH_CACHE", raising=False)


def test_enable_persistent_cache_moves_the_build_dir(build_dir, tmp_path,
                                                     monkeypatch):
    default = cache.DEFAULT_DIR
    assert default.name == "_build"
    where = tmp_path / "kernels"
    assert cache.enable_persistent_cache(str(where)) == str(where)
    assert cuda.BUILD_DIR == where
    assert cache.enable_persistent_cache(str(where)) == str(where)
    monkeypatch.setenv("VOLR_TORCH_CACHE", str(tmp_path / "env"))
    assert cache.enable_persistent_cache() == str(tmp_path / "env")
    assert cuda.BUILD_DIR == tmp_path / "env"
    monkeypatch.delenv("VOLR_TORCH_CACHE")
    assert cache.enable_persistent_cache() == str(default)
    assert cuda.BUILD_DIR == default


def test_enable_persistent_cache_refuses_after_a_load(build_dir, tmp_path):
    cuda._LIBS["composite"] = object()
    with pytest.raises(RuntimeError, match="already loaded"):
        cache.enable_persistent_cache(str(tmp_path / "other"))
    assert cache.enable_persistent_cache() == str(cuda.BUILD_DIR)
