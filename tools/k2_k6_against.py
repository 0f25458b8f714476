"""Hold kernels K2 (shadow_scatter) and K6 (scatter) of the PyTorch/CUDA
port against the same kernels built from other checkouts of the
repository, on one NVIDIA GPU.

    python3 tools/k2_k6_against.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/shadow_scatter.cu and csrc/scatter.cu with the same flags,
then renders 2 frames of each path of chip_smoke.py whose K2 or K6 launch
stands for a row of PERF.md's kernel table, recording the inputs of the
last K2 or K6 launch of each:

  K2  radiance (fused, and uhd: UHD_CONFIG), terrain (demo_full), demo
      grid (demo_production), fractional, rays (fused_exact), baked
      (fused_vis), each shard of slab3 and slab5 (the phased tent at
      every y phase), and radiance, rays and baked with 9 suns and 9 fBm
      channels (many_suns_scene: the general form, and beside it its
      gen_global form forced, the suns' inverse directions in device
      memory, timed other, this, gen_global, gen_global, this, other);
  K6  radiance x fused (staged), rays x fused (exact), rays over the terrain
      (demo_exact_hf), baked x planes (history), baked x fused (vis_bake),
      radiance x planes (history's inputs with K1's bake), and each shard
      of slab3_staged (rays on the slab's rows).

On each: this tree's kernel against its twin (max abs error), and against
each other checkout's kernel, bit for bit (torch.equal of every output);
both kernels' times, CUDA-event means of 20 launches behind a device-side
spin, in the order other, this, this, other. Prints the card's name and
power limit first and a JSON line of the rows last. Exits non-zero on a
disagreement or without a GPU. The other checkouts' kernels take the same
VrTables and entry points (vr_shadow_scatter and vr_scatter, or
vr_shadow_scatter_form and vr_scatter_form in the size rule's form:
k3_k4_against.rule_entry).
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

SOURCES = ("shadow_scatter", "scatter")


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K2 and K6 libraries, built with this tree's
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    tp = ctypes.POINTER(cuda.VrTables)
    libs["shadow_scatter"].vr_shadow_scatter = rule_entry(
        libs["shadow_scatter"], "shadow_scatter",
        [tp, vp, vp, vp, vp, ci, vp])
    libs["scatter"].vr_scatter = rule_entry(
        libs["scatter"], "scatter", [tp, vp, vp, vp, vp, vp, ci, vp])
    return libs


def record_paths(chip_smoke, ff, pipeline, shr, records) -> None:
    """Render 2 frames of each path and keep, per row label, the inputs of
    its last K2 or K6 launch in `records` ({label: (kernel, args)})."""
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, Geometry,
                                              VolumetricRenderer,
                                              benchmark_scene, demo_scene)
    label = {"v": ""}
    real_k2, real_k6 = ff.shadow_scatter, pipeline.scatter_local

    def slab_label(t):
        if t.grid_whd[1] == t.h_glob:
            return label["v"]
        return f"{label['v']} y0 {int(float(t.spar[0, 23]))}"

    def rec_k2(t, prev_shadow, bake=None, vis=None):
        records[slab_label(t)] = ("shadow_scatter",
                                  (t, prev_shadow, bake, vis, None))
        return real_k2(t, prev_shadow, bake, vis)

    def rec_k6(t, shadow, bake=None, vis=None, material=None):
        records[slab_label(t)] = ("scatter", (t, shadow, bake, vis, material))
        return real_k6(t, shadow, bake, vis, material)

    cfg = FULL_CONFIG
    aspect = cfg.image_width / cfg.image_height
    scene = benchmark_scene(aspect=aspect, num_local_lights=16,
                            noise_mode="procedural")
    demo = demo_scene(aspect=aspect)
    scenes = {"demo": demo,
              "fractional": chip_smoke.fractional_scene(demo, Geometry),
              "many9": chip_smoke.many_suns_scene(scene, 9, 9)}
    # (row label, path[, scene]): the 9-sun rows take K2's general form,
    # and its gen_global form forced beside it (main)
    paths = (("radiance", "fused"), ("uhd", "uhd"),
             ("terrain", "demo_full"), ("demo grid", "demo_production"),
             ("fractional", "fractional"),
             ("rays", "fused_exact"), ("baked", "fused_vis"),
             ("radiance x fused", "staged"), ("rays x fused", "exact"),
             ("rays over the terrain", "demo_exact_hf"),
             ("baked x planes", "history"), ("baked x fused", "vis_bake"),
             ("9 suns radiance", "fused", "many9"),
             ("9 suns rays", "fused_exact", "many9"),
             ("9 suns baked", "fused_vis", "many9"))
    ff.shadow_scatter, pipeline.scatter_local = rec_k2, rec_k6
    try:
        for lab, path, *scn_name in paths:
            r = VolumetricRenderer(dataclasses.replace(
                cfg, **chip_smoke.PATHS[path][0]))
            scn = scenes[scn_name[0]] if scn_name \
                else scenes[chip_smoke.DEMO_PATHS[path][0]] \
                if path in chip_smoke.DEMO_PATHS else scene
            colour, depth = r.render_scene_inputs(scn)
            st = r.init_state(scn.dir_lights.count)
            label["v"] = lab
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth)
            if path == "history":
                # radiance x planes: history's last K6 inputs with K1's bake
                t, sh, _, _, mat = records[lab][1]
                records["radiance x planes"] = (
                    "scatter", (t, sh, ff.bake_radiance(t), None, mat))
            del r, colour, depth, st
        for name in ("slab3", "slab5", "slab3_staged"):
            kw, n_sh, _, _ = chip_smoke.SLAB_PATHS[name]
            r = VolumetricRenderer(dataclasses.replace(cfg, **kw))
            colour, depth = r.render_scene_inputs(scene)
            fn = shr.make_multislab_render(r, n_sh, fixed_inputs=(
                list(colour.chunk(n_sh)), list(depth.chunk(n_sh))))
            carry = fn.init_carry(scene.dir_lights.count)
            label["v"] = name
            for i in range(2):
                _, carry = fn(carry, scene, 0.1 * i)
            del r, colour, depth, fn, carry
    finally:
        ff.shadow_scatter, pipeline.scatter_local = real_k2, real_k6
    torch.cuda.synchronize()


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k2_k6_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import pipeline
    from volumetricrenderer_tpu_torch.ops import cuda, frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import scatter as sca
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
                              cuda.BUILD_DIR / f"k2k6_other{i}", cuda)
                  for i, arg in enumerate(sys.argv[1:])]
        others = {arg: b.result() for arg, b in zip(sys.argv[1:], builds)}
    records = {}
    record_paths(chip_smoke, ff, pipeline, shr, records)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    opt = lambda x: None if x is None else cuda.ptr(x)
    bad, rows = [], []
    for lab, (kernel, (t, shadow, bake, vis, mat)) in records.items():
        st = t.c_struct()
        mode = sca.local_mode(bake, vis)
        low = bake if bake is not None else vis
        if kernel == "shadow_scatter":
            run_this = lambda: ff.shadow_scatter(t, shadow, bake, vis)
            got = run_this()
            want = ff.shadow_scatter_plain(t, shadow, bake, vis)
        else:
            run_this = lambda: sca.scatter_local(t, shadow, bake, vis, mat)
            got = (run_this(),)
            want = (sca.scatter_local_plain(t, shadow, bake, vis, mat),)
        twin = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
        print(f"# {kernel} {lab} {t.grid_whd}: max abs err vs twin "
              f"{twin:.3e}", flush=True)
        n = 5 if mode == sca.LOCAL_RAY else 20
        row = {"kernel": kernel, "row": lab, "grid": t.grid_whd,
               "twin_err": twin}
        for o_name, other in others.items():
            ref = [torch.empty_like(g) for g in got]
            if kernel == "shadow_scatter":
                run_other = lambda: other[kernel].vr_shadow_scatter(
                    ctypes.byref(st), cuda.ptr(shadow), opt(low),
                    cuda.ptr(ref[0]), cuda.ptr(ref[1]), mode, stream())
            else:
                run_other = lambda: other[kernel].vr_scatter(
                    ctypes.byref(st), cuda.ptr(shadow), opt(low),
                    opt(mat[0] if mat else None), opt(mat[1] if mat else None),
                    cuda.ptr(ref[0]), mode, stream())
            if run_other():
                raise RuntimeError(f"{o_name}'s {kernel} failed to launch")
            same = all(torch.equal(g, r_) for g, r_ in zip(got, ref))
            if kernel == "shadow_scatter" and t.n_dir > 4:
                # the general form, and gen_global forced (the suns'
                # inverse directions in device memory), against the other
                run_new = lambda: ff.shadow_scatter(t, shadow, bake, vis,
                                                    form="gen_global")
                new_same = all(torch.equal(g, r_)
                               for g, r_ in zip(run_new(), ref))
                (o1, o2), (n1, n2), new_ms = new_form_turns(
                    run_other, run_this, run_new, n)
                print(f"#   gen_global {new_ms[0]:.4f} {new_ms[1]:.4f} ms "
                      f"({sum(new_ms) / (n1 + n2):.3f}x this); = {o_name} "
                      f"bit for bit: {new_same}", flush=True)
                same = same and new_same
            else:
                o1, n1 = spin_time_ms(run_other, n), spin_time_ms(run_this, n)
                n2, o2 = spin_time_ms(run_this, n), spin_time_ms(run_other, n)
                new_ms = None
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms ({(o1 + o2) / (n1 + n2):.2f}x); = {o_name} "
                  f"bit for bit: {same}", flush=True)
            row[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            if new_ms is not None:
                row[o_name]["gen_global_ms"] = new_ms
            bad += [] if same else [f"{kernel} {lab} against {o_name}"]
        rows.append(row)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K2 and K6 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
