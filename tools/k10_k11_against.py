"""Hold kernels K10 (temporal_blend) and K11 (windowed_warp) of the
PyTorch/CUDA port against the same kernels built from other checkouts of
the repository, on one NVIDIA GPU.

    python3 tools/k10_k11_against.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/temporal_blend.cu and csrc/windowed_warp.cu with the same
flags, then renders 2 frames of each path of chip_smoke.py that launches
K10 or K11, recording the inputs of each launch's last call by row:

  K10 weight  map_dir, xla_shadow, demo_map_dir (the shadow blend, 1 sun);
  K10 alpha   history, xla_shadow (the accumulation blend, 4 channels);
  K11         history and xla_shadow, each its material blend and its
              scatter blend (4 channels);

and three rows of the same inputs after a large camera move (K10 weight
on map_dir's and alpha on history's with the blend table's translation
shifted, K11 on history's material blend with its targets moved by
whole cells), whose offsets reach the window's clip.

On each: this tree's kernel against its twin (max abs error), and against
each other checkout's kernel, bit for bit (torch.equal); both kernels'
times, CUDA-event means of 20 launches behind a device-side spin, in the
order other, this, this, other. Then the device busy time of a frame of
history, xla_shadow and map_dir (torch.profiler over 5 warm frames) with
this tree's K10 and K11 and with each other checkout's swapped in, in the
order this, other, other, this. Prints the card's name and power limit
first and a JSON line of the rows last. Exits non-zero on a disagreement
or without a GPU. The other checkouts' kernels take the same arguments
(vr_temporal_blend, vr_windowed_warp; a tree with index forms at its
vr_temporal_blend_form and vr_windowed_warp_form, called there in the size
rule's form).
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from k3_k4_against import rule_entry, spin_time_ms  # noqa: E402

SOURCES = ("temporal_blend", "windowed_warp")
# (path, K10 modes recorded, K11 recorded)
PATHS = (("map_dir", ("weight",), False),
         ("xla_shadow", ("weight", "alpha"), True),
         ("demo_map_dir", ("weight",), False),
         ("history", ("alpha",), True))
BUSY_PATHS = ("history", "xla_shadow", "map_dir")


def declare(libs: dict) -> dict:
    """Each other library's launch in the size rule's form at its
    `vr_<name>` (rule_entry), with the argument types ops/cuda declares;
    and, for a tree from before the index forms, a `vr_<name>_form` that
    takes the narrow form alone, which this tree's wrappers launch when the
    library is swapped in (frame_busy)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("temporal_blend", [vp] * 4 + [ci] * 7 + [vp]),
                           ("windowed_warp", [vp] * 5 + [ci] * 5 + [vp])):
        lib = libs[name]
        had_form = getattr(lib, f"vr_{name}_form", None) is not None
        rule = rule_entry(lib, name, argtypes)
        setattr(lib, f"vr_{name}", rule)
        if not had_form:
            setattr(lib, f"vr_{name}_form",
                    lambda *a, rule=rule: rule(*a[:-2], a[-1])
                    if a[-2] <= 0 else 1)
    return libs


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K10 and K11 libraries, built with this tree's
    flags into `out`."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        src = other / "volumetricrenderer_tpu_torch" / "csrc" / f"{name}.cu"
        procs[name] = subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(f"# nvcc {other} {name}:\n{log}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return declare(libs)


def scene_and_inputs(chip_smoke, r, path, scenes):
    scn = scenes[chip_smoke.DEMO_PATHS[path][0]] \
        if path in chip_smoke.DEMO_PATHS else scenes["bench"]
    colour, depth = r.render_scene_inputs(scn)
    return scn, colour, depth, r.bake_shadow_data(scn)


def record_paths(chip_smoke, pipeline, scenes, records) -> None:
    """Render 2 frames of each path and keep, per row, the inputs of its
    last K10 or K11 launch in `records` ({(kernel, row): args}, cloned)."""
    from volumetricrenderer_tpu_torch import FULL_CONFIG, VolumetricRenderer
    label = {"path": "", "blend": ""}
    real = {n: getattr(pipeline, n) for n in (
        "temporal_blend", "windowed_warp", "temporal_blend_material",
        "temporal_blend_scatter")}

    def rec_k10(bpar, prev, cur, grid_whd, h_glob, k, mode):
        records[("temporal_blend", f"{mode} {label['path']}")] = (
            bpar.clone(), prev.clone(), cur.clone(), grid_whd, h_glob, k,
            mode)
        return real["temporal_blend"](bpar, prev, cur, grid_whd, h_glob, k,
                                      mode)

    def rec_k11(vol, tx, ty, tz, k):
        records[("windowed_warp", f"{label['path']} {label['blend']}")] = (
            vol.clone(), tx.clone(), ty.clone(), tz.clone(), k)
        return real["windowed_warp"](vol, tx, ty, tz, k)

    def blend_of(name, blend):
        def run(*args, **kw):
            label["blend"] = blend
            return real[name](*args, **kw)
        return run

    pipeline.temporal_blend = rec_k10
    pipeline.windowed_warp = rec_k11
    pipeline.temporal_blend_material = blend_of("temporal_blend_material",
                                                "material blend")
    pipeline.temporal_blend_scatter = blend_of("temporal_blend_scatter",
                                               "scatter blend")
    try:
        for path, _, _ in PATHS:
            r = VolumetricRenderer(dataclasses.replace(
                FULL_CONFIG, **chip_smoke.PATHS[path][0]))
            scn, colour, depth, shadow_data = scene_and_inputs(
                chip_smoke, r, path, scenes)
            st = r.init_state(scn.dir_lights.count)
            label["path"] = path
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth,
                                          shadow_data)
            del r, colour, depth, st, shadow_data
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
    torch.cuda.synchronize()
    for path, modes, k11 in PATHS:
        want = [("temporal_blend", f"{m} {path}") for m in modes]
        if k11:
            want += [("windowed_warp", f"{path} {b} blend")
                     for b in ("material", "scatter")]
        missing = [w for w in want if w not in records]
        if missing:
            raise RuntimeError(f"no launch recorded for {missing}")
    # the same inputs after a large camera move: the view -> previous view
    # translation shifted (K10) and the targets moved by whole cells (K11),
    # so that offsets reach the +-k clip and the warp's taps the region's
    # edges
    for mode, path in (("weight", "map_dir"), ("alpha", "history")):
        bpar, *rest = records[("temporal_blend", f"{mode} {path}")]
        moved = bpar.clone()
        moved[0, 3] += 2.0
        moved[0, 7] -= 1.0
        records[("temporal_blend", f"{mode} {path}, camera moved")] = (
            moved, *rest)
    vol, tx, ty, tz, k = records[("windowed_warp",
                                  "history material blend")]
    records[("windowed_warp", "history material blend, targets moved")] = (
        vol, tx + 3.5, ty - 2.25, tz + 1.5, k)


def busy_ms(step, n: int = 5) -> float:
    """Device time a frame: torch.profiler's kernel time over n warm
    frames."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    # the pass ranges' GPU annotations span kernels: not device work
    from volumetricrenderer_tpu_torch.utils.profiling import PASS_NAMES
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in PASS_NAMES]
    total = sum(e.self_device_time_total for e in kern) / 1e3 / n
    if total <= 0.0:
        raise RuntimeError("the profiler recorded no device time")
    return total


def frame_busy(chip_smoke, cuda, scenes, others) -> dict:
    """Device busy a frame of BUSY_PATHS with this tree's K10 and K11 and
    with each other checkout's in their place."""
    from volumetricrenderer_tpu_torch import FULL_CONFIG, VolumetricRenderer
    mine = {n: cuda.lib(n) for n in SOURCES}
    out = {}
    for path in BUSY_PATHS:
        r = VolumetricRenderer(dataclasses.replace(
            FULL_CONFIG, **chip_smoke.PATHS[path][0]))
        scn, colour, depth, shadow_data = scene_and_inputs(
            chip_smoke, r, path, scenes)
        st = r.init_state(scn.dir_lights.count)
        for i in range(3):
            _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth,
                                      shadow_data)

        def frame():
            r.render_frame(st, scn, 0.5, colour, depth, shadow_data)

        row = {}
        for o_name, other in others.items():
            def with_libs(libs):
                cuda._LIBS.update(libs)
                try:
                    return busy_ms(frame)
                finally:
                    cuda._LIBS.update(mine)
            t1 = with_libs(mine)
            o1, o2 = with_libs(other), with_libs(other)
            t2 = with_libs(mine)
            print(f"# {path} frame, device busy: this {t1:.4f} {t2:.4f} ms, "
                  f"{o_name} {o1:.4f} {o2:.4f} ms", flush=True)
            row[o_name] = {"this_ms": [t1, t2], "other_ms": [o1, o2]}
        out[path] = row
        del r, colour, depth, st, shadow_data
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k10_k11_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, benchmark_scene,
                                              demo_scene, pipeline)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import warp as wp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda.build(verbose=True)
    for src in SOURCES:
        print(f"# kernel attributes, {src}: {cuda.kernel_attrs(src)}",
              flush=True)
    with ThreadPoolExecutor() as pool:  # every other checkout at once
        builds = [pool.submit(build_other, Path(arg).resolve(),
                              cuda.BUILD_DIR / f"k10k11_other{i}", cuda)
                  for i, arg in enumerate(sys.argv[1:])]
        others = {arg: b.result() for arg, b in zip(sys.argv[1:], builds)}
    aspect = FULL_CONFIG.image_width / FULL_CONFIG.image_height
    scenes = {"bench": benchmark_scene(aspect=aspect, num_local_lights=16,
                                       noise_mode="procedural"),
              "demo": demo_scene(aspect=aspect)}
    records = {}
    record_paths(chip_smoke, pipeline, scenes, records)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bad, rows = [], []
    for (kernel, lab), args in records.items():
        if kernel == "temporal_blend":
            bpar, prev, cur, whd, hg, k, mode = args
            run_this = lambda: tmp.temporal_blend(bpar, prev, cur, whd, hg, k,
                                                  mode)
            got = run_this()
            want = tmp.temporal_blend_plain(bpar, prev, cur, whd, hg, k,
                                            mode)
            shape = f"{tuple(prev.shape)}, h_glob {hg}, k {k}"
        else:
            vol, tx, ty, tz, k = args
            run_this = lambda: wp.windowed_warp(vol, tx, ty, tz, k)
            got = run_this()
            want = wp.windowed_warp_plain(vol, tx, ty, tz, k)
            shape = f"{tuple(vol.shape)}, k {k}"
        twin = float((got - want).abs().max())
        print(f"# {kernel} {lab}, {shape}: max abs err vs twin {twin:.3e}",
              flush=True)
        row = {"kernel": kernel, "row": lab, "shape": shape,
               "twin_err": twin}
        for o_name, other in others.items():
            ref = torch.empty_like(got)
            if kernel == "temporal_blend":
                run_other = lambda: other[kernel].vr_temporal_blend(
                    cuda.ptr(bpar), cuda.ptr(prev), cuda.ptr(cur),
                    cuda.ptr(ref), prev.shape[0], *whd, hg, k,
                    tmp.MODES.index(mode), stream())
            else:
                c_, d_, h_, w_ = vol.shape
                run_other = lambda: other[kernel].vr_windowed_warp(
                    cuda.ptr(vol), cuda.ptr(tx), cuda.ptr(ty), cuda.ptr(tz),
                    cuda.ptr(ref), c_, d_, h_, w_, k, stream())
            if run_other():
                raise RuntimeError(f"{o_name}'s {kernel} failed to launch")
            same = torch.equal(got, ref)
            o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
            n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms ({(o1 + o2) / (n1 + n2):.2f}x); = {o_name} "
                  f"bit for bit: {same}", flush=True)
            if not same:
                diff = (got - ref).abs()
                at = tuple(int(v) for v in torch.unravel_index(
                    diff.argmax(), diff.shape))
                print(f"#   differs on {int((diff > 0).sum())} of "
                      f"{diff.numel()} elements, max {float(diff.max()):.3e}"
                      f" at {at}", flush=True)
            row[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            bad += [] if same else [f"{kernel} {lab} against {o_name}"]
        rows.append(row)
    del records
    busy = frame_busy(chip_smoke, cuda, scenes, others)
    print(json.dumps({"device": smi, "rows": rows, "frame_busy": busy}),
          flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K10 and K11 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
