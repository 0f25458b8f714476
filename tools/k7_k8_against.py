"""Hold kernels K7 (dir_shadow) and K8 (integrate) of the PyTorch/CUDA port
against the same kernels built from other checkouts of the repository, on
one NVIDIA GPU.

    python3 tools/k7_k8_against.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/dir_shadow.cu and csrc/integrate.cu with the same flags,
then renders 2 frames of each path of chip_smoke.py that launches K7 or
K8, recording the inputs of each kernel's last launch by row:

  K7  no_shadow_blend (benchmark_scene: solid primitives),
      demo_no_shadow_blend (demo_scene: every sun ray marches the terrain),
      fractional_no_shadow_blend (the terrain, three boxes at opacity
      0.5), and no_shadow_blend with 9 suns (many_suns_scene: the general
      form, and beside it its gen_global form forced, the suns' inverse
      directions in device memory, timed other, this, gen_global,
      gen_global, this, other);
  K8  no_acc_blend, and the same configuration at the demo grid
      (160x88x64 froxels: 14,080 columns, where a form that is parallel
      over columns fills the card least).

On each: this tree's kernel against its twin (max abs error; the twin's
time, a CUDA-event mean of 3 calls), and against
each other checkout's kernel, bit for bit (torch.equal); both kernels'
times, CUDA-event means of 20 launches behind a device-side spin, in the
order other, this, this, other. Then the device busy time of a frame of
each of those rows (torch.profiler over 5 warm frames) with this
tree's K7 and K8 and with each other checkout's swapped in, in the order
this, other, other, this. Prints the card's name and power limit first and
a JSON line of the rows last. Exits non-zero on a disagreement or without a
GPU. The other checkouts' kernels take the same arguments (vr_dir_shadow,
vr_integrate, or vr_dir_shadow_form and vr_integrate_form in the size
rule's form: k3_k4_against.rule_entry; a tree from before those has its
narrow form alone, which this tree's wrappers reach when its library is
swapped in).
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

from k10_k11_against import busy_ms  # noqa: E402
from k3_k4_against import (new_form_turns, rule_entry,  # noqa: E402
                           spin_time_ms)

SOURCES = ("dir_shadow", "integrate")
DEMO_GRID = dict(volume_width=160, volume_height=88, volume_depth=64)
# row -> (chip_smoke.py path whose configuration it runs, the grid it
# changes, the kernel recorded)
ROWS = {"no_shadow_blend": ("no_shadow_blend", {}, "dir_shadow"),
        "demo_no_shadow_blend": ("demo_no_shadow_blend", {}, "dir_shadow"),
        "fractional_no_shadow_blend": ("fractional_no_shadow_blend", {},
                                       "dir_shadow"),
        "no_acc_blend": ("no_acc_blend", {}, "integrate"),
        "no_acc_blend, demo grid": ("no_acc_blend", DEMO_GRID, "integrate"),
        "no_shadow_blend, 9 suns": ("no_shadow_blend", {}, "dir_shadow")}
# rows on a scene of their own (scenes' keys), the rest on their path's
ROW_SCENES = {"no_shadow_blend, 9 suns": "many9"}


def declare(libs: dict) -> dict:
    """The launch entry points' argument types, as ops/cuda declares them."""
    vp = ctypes.c_void_p
    for name, argtypes in (("dir_shadow", [vp, vp, vp]),
                           ("integrate", [vp, vp, vp, vp])):
        lib = libs[name]
        setattr(lib, f"vr_{name}", rule_entry(lib, name, argtypes))
        if getattr(lib, f"vr_{name}_form", None) is None:
            # this tree's wrappers, with the library swapped in, launch the
            # form-taking entry: a tree from before it has the narrow form
            old = getattr(lib, f"vr_{name}")
            setattr(lib, f"vr_{name}_form",
                    lambda *a, old=old: old(*a[:-2], a[-1])
                    if a[-2] <= 0 else 1)
    return libs


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K7 and K8 libraries, built with this tree's
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


def renderer_and_inputs(chip_smoke, row, scenes):
    """The row's renderer, scene, G-buffer and initial state."""
    from volumetricrenderer_tpu_torch import FULL_CONFIG, VolumetricRenderer
    path, grid, _ = ROWS[row]
    r = VolumetricRenderer(dataclasses.replace(
        FULL_CONFIG, **chip_smoke.PATHS[path][0], **grid))
    scn = scenes[ROW_SCENES[row]] if row in ROW_SCENES \
        else scenes[chip_smoke.DEMO_PATHS[path][0]] \
        if path in chip_smoke.DEMO_PATHS else scenes["bench"]
    colour, depth = r.render_scene_inputs(scn)
    return r, scn, colour, depth, r.init_state(scn.dir_lights.count)


def record_rows(chip_smoke, pipeline, scenes) -> dict:
    """Render 2 frames of each row's path and keep the inputs of its
    kernel's last launch: {row: tables} for K7, {row: (tables, scatter)}
    for K8."""
    records, label = {}, {"row": ""}
    real = {"raycast_dir_shadow": pipeline.raycast_dir_shadow,
            "accumulate_kernel": pipeline.accumulate_kernel}

    def rec_k7(t):
        records[label["row"]] = t
        return real["raycast_dir_shadow"](t)

    def rec_k8(t, scatter):
        records[label["row"]] = (t, scatter.clone())
        return real["accumulate_kernel"](t, scatter)

    pipeline.raycast_dir_shadow = rec_k7
    pipeline.accumulate_kernel = rec_k8
    try:
        for row in ROWS:
            r, scn, colour, depth, st = renderer_and_inputs(chip_smoke, row,
                                                            scenes)
            label["row"] = row
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth)
            del r, colour, depth, st
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
    torch.cuda.synchronize()
    missing = [row for row in ROWS if row not in records]
    if missing:
        raise RuntimeError(f"no launch recorded for {missing}")
    return records


def frame_busy(chip_smoke, cuda, scenes, others) -> dict:
    """Device busy a frame of each row's path with this tree's K7 and K8
    and with each other checkout's in their place."""
    mine = {n: cuda.lib(n) for n in SOURCES}
    out = {}
    for row in ROWS:
        r, scn, colour, depth, st = renderer_and_inputs(chip_smoke, row,
                                                        scenes)
        for i in range(3):
            _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth)

        def frame():
            r.render_frame(st, scn, 0.5, colour, depth)

        out[row] = {}
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
            print(f"# {row} frame, device busy: this {t1:.4f} {t2:.4f} ms, "
                  f"{o_name} {o1:.4f} {o2:.4f} ms", flush=True)
            out[row][o_name] = {"this_ms": [t1, t2], "other_ms": [o1, o2]}
        del r, colour, depth, st
    return out


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k7_k8_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, Geometry,
                                              benchmark_scene, demo_scene,
                                              pipeline)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import integrate as integ

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
                              cuda.BUILD_DIR / f"k7k8_other{i}", cuda)
                  for i, arg in enumerate(sys.argv[1:])]
        others = {arg: b.result() for arg, b in zip(sys.argv[1:], builds)}
    aspect = FULL_CONFIG.image_width / FULL_CONFIG.image_height
    demo = demo_scene(aspect=aspect)
    scenes = {"bench": benchmark_scene(aspect=aspect, num_local_lights=16,
                                       noise_mode="procedural"),
              "demo": demo,
              "fractional": chip_smoke.fractional_scene(demo, Geometry)}
    scenes["many9"] = chip_smoke.many_suns_scene(scenes["bench"], 9, 9)
    records = record_rows(chip_smoke, pipeline, scenes)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bad, rows = [], []
    for row, args in records.items():
        kernel = ROWS[row][2]
        if kernel == "dir_shadow":
            tables = args
            run_this = lambda: ds.dir_shadow(tables)
            run_twin = lambda: ds.dir_shadow_plain(tables)
        else:
            tables, sc = args
            run_this = lambda: integ.accumulate(tables, sc)
            run_twin = lambda: integ.accumulate_plain(tables, sc)
        got, want = run_this(), run_twin()
        shape = f"{tuple(got.shape)}"
        st = tables.c_struct()
        twin = float((got - want).abs().max())
        plain = chip_smoke.cuda_time_ms(run_twin, 3)
        print(f"# {kernel} {row}, {shape}: max abs err vs twin {twin:.3e}, "
              f"twin {plain:.3f} ms (CUDA events, mean of 3)", flush=True)
        out = {"kernel": kernel, "row": row, "shape": shape,
               "twin_err": twin, "plain_ms": plain}
        for o_name, other in others.items():
            ref = torch.empty_like(got)
            if kernel == "dir_shadow":
                run_other = lambda: other[kernel].vr_dir_shadow(
                    ctypes.byref(st), cuda.ptr(ref), stream())
            else:
                run_other = lambda: other[kernel].vr_integrate(
                    ctypes.byref(st), cuda.ptr(sc), cuda.ptr(ref), stream())
            if run_other():
                raise RuntimeError(f"{o_name}'s {kernel} failed to launch")
            same = torch.equal(got, ref)
            new_ms = None
            if kernel == "dir_shadow" and tables.n_dir > 4:
                # the general form, and gen_global forced beside it
                run_new = lambda: ds.dir_shadow(tables, form="gen_global")
                new_same = torch.equal(run_new(), ref)
                (o1, o2), (n1, n2), new_ms = new_form_turns(
                    run_other, run_this, run_new)
                print(f"#   gen_global {new_ms[0]:.4f} {new_ms[1]:.4f} ms "
                      f"({sum(new_ms) / (n1 + n2):.3f}x this); = {o_name} "
                      f"bit for bit: {new_same}", flush=True)
                same = same and new_same
            else:
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
            out[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            if new_ms is not None:
                out[o_name]["gen_global_ms"] = new_ms
            bad += [] if same else [f"{kernel} {row} against {o_name}"]
        rows.append(out)
    del records
    busy = frame_busy(chip_smoke, cuda, scenes, others)
    print(json.dumps({"device": smi, "rows": rows, "frame_busy": busy}),
          flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K7 and K8 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
