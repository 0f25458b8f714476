"""Hold kernels K1 (bake_radiance) and K5 (shadow_blend) of the PyTorch/CUDA
port against the same kernels built from other checkouts of the
repository, on one NVIDIA GPU.

    python3 tools/k1_k5_against.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/bake_radiance.cu and csrc/shadow_blend.cu with the same
flags, then renders 2 frames of each path of chip_smoke.py whose K1 or K5
launch stands for a row of PERF.md's kernel table, recording the inputs of
the last K1 or K5 launch of each:

  K1  full grid (fused), local terrain (demo_hf_local), demo grid
      (demo_production), fractional, 40 lights (the fused frame on
      benchmark_scene with 40 local lights: two passes of lights), each
      shard of slab3 and slab5 (every y phase), and 9 fBm channels
      (many_suns_scene: the general form, and beside it the chunked form
      forced with 4 of the 9 staged, timed other, this, chunked, chunked,
      this, other);
  K5  full grid (staged), terrain (demo_exact_hf), each shard of
      slab3_staged, and 9 suns (the general form, and its gen_global form
      forced beside it, the suns' inverse directions in device memory).

On each: this tree's kernel against its twin (max abs error), and against
each other checkout's kernel, bit for bit (torch.equal of every output);
both kernels' times, CUDA-event means of 20 launches behind a device-side
spin, in the order other, this, this, other. Prints the card's name and
power limit first and a JSON line of the rows last. Exits non-zero on a
disagreement or without a GPU. The other checkouts' kernels take the same
VrTables and entry points (vr_bake_radiance; vr_shadow_blend, or
vr_shadow_blend_form in the size rule's form: k3_k4_against.rule_entry).
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

from k3_k4_against import (new_form_turns, rule_entry,  # noqa: E402
                           spin_time_ms)

SOURCES = ("bake_radiance", "shadow_blend")


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K1 and K5 libraries, built with this tree's
    flags into `out`, each entry point given its argument types."""
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
    vp = ctypes.c_void_p
    tp = ctypes.POINTER(cuda.VrTables)
    libs["bake_radiance"].vr_bake_radiance.argtypes = [tp, vp, vp]
    libs["shadow_blend"].vr_shadow_blend = rule_entry(
        libs["shadow_blend"], "shadow_blend", [tp, vp, vp, vp])
    return libs


def record_paths(chip_smoke, ff, renderer_mod, pipeline, shr,
                 records) -> None:
    """Render 2 frames of each path and keep, per row label, the inputs of
    its last K1 or K5 launch in `records` ({(kernel, label): args})."""
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, Geometry,
                                              VolumetricRenderer,
                                              benchmark_scene, demo_scene)
    label = {"v": "", "kernels": ()}
    real_k1, real_k5 = ff.bake_radiance, renderer_mod.dir_shadow_blend

    def slab_label(t):
        if t.grid_whd[1] == t.h_glob:
            return label["v"]
        return (f"{label['v']} y0 {int(float(t.spar[0, 23]))} phase "
                f"{int(float(t.spar[0, 24]))}")

    def rec_k1(t, noise=None):
        if "bake_radiance" in label["kernels"]:
            records[("bake_radiance", slab_label(t))] = (t, None)
        return real_k1(t, noise)

    def rec_k5(t, prev_shadow):
        if "shadow_blend" in label["kernels"]:
            records[("shadow_blend", slab_label(t))] = (t, prev_shadow)
        return real_k5(t, prev_shadow)

    cfg = FULL_CONFIG
    aspect = cfg.image_width / cfg.image_height
    scene = benchmark_scene(aspect=aspect, num_local_lights=16,
                            noise_mode="procedural")
    demo = demo_scene(aspect=aspect)
    scenes = {"demo": demo,
              "fractional": chip_smoke.fractional_scene(demo, Geometry),
              "lights40": benchmark_scene(aspect=aspect,
                                          num_local_lights=40,
                                          noise_mode="procedural"),
              "many9": chip_smoke.many_suns_scene(scene, 9, 9)}
    # (row label, path, scene or None for the path's own, kernel recorded)
    k1, k5 = ("bake_radiance",), ("shadow_blend",)
    paths = (("full grid", "fused", None, k1),
             ("local terrain", "demo_hf_local", None, k1),
             ("demo grid", "demo_production", None, k1),
             ("fractional", "fractional", None, k1),
             ("40 lights", "fused", "lights40", k1),
             ("9 fBm channels", "fused", "many9", k1),
             ("full grid", "staged", None, k5),
             ("terrain", "demo_exact_hf", None, k5),
             ("9 suns", "staged", "many9", k5))
    ff.bake_radiance = pipeline.bake_radiance = rec_k1
    renderer_mod.dir_shadow_blend = rec_k5
    try:
        for lab, path, scn_name, kernels in paths:
            r = VolumetricRenderer(dataclasses.replace(
                cfg, **chip_smoke.PATHS[path][0]))
            if scn_name is not None:
                scn = scenes[scn_name]
            elif path in chip_smoke.DEMO_PATHS:
                scn = scenes[chip_smoke.DEMO_PATHS[path][0]]
            else:
                scn = scene
            colour, depth = r.render_scene_inputs(scn)
            st = r.init_state(scn.dir_lights.count)
            label.update(v=lab, kernels=kernels)
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth)
            del r, colour, depth, st
        for name in ("slab3", "slab5", "slab3_staged"):
            kw, n_sh, _, _ = chip_smoke.SLAB_PATHS[name]
            r = VolumetricRenderer(dataclasses.replace(cfg, **kw))
            colour, depth = r.render_scene_inputs(scene)
            fn = shr.make_multislab_render(r, n_sh, fixed_inputs=(
                list(colour.chunk(n_sh)), list(depth.chunk(n_sh))))
            carry = fn.init_carry(scene.dir_lights.count)
            label.update(v=name, kernels=k1 + k5)
            for i in range(2):
                _, carry = fn(carry, scene, 0.1 * i)
            del r, colour, depth, fn, carry
    finally:
        ff.bake_radiance = pipeline.bake_radiance = real_k1
        renderer_mod.dir_shadow_blend = real_k5
    torch.cuda.synchronize()


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k1_k5_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import pipeline
    from volumetricrenderer_tpu_torch import renderer as renderer_mod
    from volumetricrenderer_tpu_torch.ops import cuda, frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.parallel import shard_render as shr

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
                              cuda.BUILD_DIR / f"k1k5_other{i}", cuda)
                  for i, arg in enumerate(sys.argv[1:])]
        others = {arg: b.result() for arg, b in zip(sys.argv[1:], builds)}
    records = {}
    record_paths(chip_smoke, ff, renderer_mod, pipeline, shr, records)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bad, rows = [], []
    for (kernel, lab), (t, prev) in records.items():
        st = t.c_struct()
        if kernel == "bake_radiance":
            run_this = lambda: ff.bake_radiance(t)
            got = run_this()
            want = ff.bake_radiance_plain(t)
            geo = ff.k1_geometry(t.lights.shape[0], t.n_noise, t.low_dims)
            shape = f"low grid {t.low_dims}, {geo}"
        else:
            run_this = lambda: sb.dir_shadow_blend(t, prev)
            got = run_this()
            want = sb.dir_shadow_blend_plain(t, prev)
            shape = f"grid {t.grid_whd}"
        twin = float((got - want).abs().max())
        print(f"# {kernel} {lab}, {shape}: max abs err vs twin "
              f"{twin:.3e}", flush=True)
        row = {"kernel": kernel, "row": lab, "grid": t.grid_whd,
               "low_grid": t.low_dims, "twin_err": twin}
        for o_name, other in others.items():
            ref = torch.empty_like(got)
            if kernel == "bake_radiance":
                run_other = lambda: other[kernel].vr_bake_radiance(
                    ctypes.byref(st), cuda.ptr(ref), stream())
            else:
                run_other = lambda: other[kernel].vr_shadow_blend(
                    ctypes.byref(st), cuda.ptr(prev), cuda.ptr(ref),
                    stream())
            if run_other():
                raise RuntimeError(f"{o_name}'s {kernel} failed to launch")
            same = torch.equal(got, ref)
            # the general forms, and the new form forced beside them
            run_new, new_name, new_ms = None, "", None
            if kernel == "bake_radiance" and t.n_noise > 4:
                new_name = "chunked, 4 staged"
                run_new = lambda: ff.bake_radiance(t, form="chunked",
                                                   chunk=4)
            elif kernel == "shadow_blend" and t.n_dir > 4:
                new_name = "gen_global"
                run_new = lambda: sb.dir_shadow_blend(t, prev,
                                                      form="gen_global")
            if run_new is not None:
                new_same = torch.equal(run_new(), ref)
                (o1, o2), (n1, n2), new_ms = new_form_turns(
                    run_other, run_this, run_new)
                print(f"#   {new_name} {new_ms[0]:.4f} {new_ms[1]:.4f} ms "
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
            row[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            if new_ms is not None:
                row[o_name]["new_form_ms"] = new_ms
            bad += [] if same else [f"{kernel} {lab} against {o_name}"]
        rows.append(row)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K1 and K5 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
