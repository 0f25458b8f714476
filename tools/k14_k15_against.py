"""Hold kernels K14 (composite_grad) and K15 (ssr_march_grad) of the
PyTorch/CUDA port against the same kernels built from other checkouts of
the repository, on one NVIDIA GPU.

    python3 tools/k14_k15_against.py [--rows-only] OTHER_CHECKOUT [...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/composite_grad.cu and csrc/ssr_march_grad.cu with the same
flags. Then:

  K14, in each of chip_smoke.K14_FORMS (the per-pixel form at 1280x720
  and the cells form at 1280x704 on 160x88x64, the cells form at 1920x1080
  on 240x135x128, the per-pixel form on 160x88x1024 in 2 chunks of slices,
  held against another checkout's only where its K14 takes chunks), on
  chip_smoke.k14_forms' seeded inputs: this tree's
  kernel against its twin (bit for bit), against itself over two launches
  (bit for bit), and against each other checkout's (within 1e-5 + 1e-5
  |value|: a kernel that adds with atomics sums in a run-dependent order);
  both wrappers' times, CUDA-event means of 20 calls behind a device-side
  spin (k3_k4_against.spin_time_ms), in the order other, this, this,
  other. The wrapper call is what is timed: an atomic form's includes the
  zeroing of its output.

  K15, on the inputs of K13's last launch of 4 frames of chip_smoke.py's
  post_showcase loop (k13_against.showcase; the default march, 8 bins of
  <= 12 taps, and ssr_steps=24, ssr_dirs=16), K13's RECORD instance's hit
  record and a seeded random cotangent: the same checks, each other
  checkout's bit for bit (a gather in the same order).

  The steps' backward: train_fog's step (DEMO_CONFIG on demo_scene at
  1280x720, FogParams; K4 forward, K14 backward) and train_ssr's (the same
  frame through render_frame_post with SSR on; K13 forward, K15 and K14
  backward), loss.backward()'s CUDA-event mean of 5 with this tree's K14
  and K15 and with each other checkout's in their place, in the order
  this, other, other, this (not with --rows-only).

Prints the card's name and power limit first and a JSON line of the rows
last; exits non-zero on a disagreement or without a GPU. Another
checkout's library is called through its own entry points: this tree's
(the gather forms, which take the footprint tables of
ops/zg_composite.grad_footprint and the offset extent of
ops/ssr.tap_extent) where its source has them, else the atomic K14's
(`vr_composite_grad` on K4's cell table, `vr_composite_grad_pixels` on
pixel_taps' tables, into a zeroed volume) and the first K15's (K13's table
without an extent). A gather tree from before K14 and K15 took one
form-taking entry point each (`vr_composite_grad_chunks`,
`vr_ssr_march_grad_form`) is called through its one-launch
`vr_composite_grad` and its int16 `vr_ssr_march_grad` (one_entry_shim),
for the size rule's one-launch plan and fixed form only.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from k13_against import showcase  # noqa: E402
from k3_k4_against import spin_time_ms  # noqa: E402

K15_ROWS = {"post_showcase": {},
            "ssr_steps=24, ssr_dirs=16": dict(ssr_steps=24, ssr_dirs=16)}
# a kernel whose source holds this marker takes this tree's arguments
GATHER_MARK = {"composite_grad": "vr_composite_grad_geometry",
               "ssr_march_grad": "oy_lo"}
# this tree's one form-taking entry point of each
ONE_ENTRY = {"composite_grad": "vr_composite_grad_chunks",
             "ssr_march_grad": "vr_ssr_march_grad_form"}
BACKWARD_N = 5


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K14 and K15 libraries, built with this tree's
    flags into `out`: name -> (library, takes this tree's arguments)."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in GATHER_MARK:
        src = other / "volumetricrenderer_tpu_torch" / "csrc" / f"{name}.cu"
        procs[name] = (src, subprocess.Popen(
            [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"# nvcc {other} {name}:\n{log}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {other}'s {name}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        gather = GATHER_MARK[name] in src.read_text()
        if gather and hasattr(lib, ONE_ENTRY[name]):
            cuda._declare(lib, name)
        elif gather:
            lib = one_entry_shim(lib, name)
        elif name == "composite_grad":
            lib.vr_composite_grad.argtypes = [vp] * 6 + [ci] * 5 + [vp, vp]
            lib.vr_composite_grad_pixels.argtypes = ([vp] * 8 + [ci] * 5
                                                     + [vp, vp])
            lib.vr_composite_grad.restype = ci
            lib.vr_composite_grad_pixels.restype = ci
        else:
            lib.vr_ssr_march_grad.argtypes = [vp] * 7 + [ci] * 4 + [vp] * 4
            lib.vr_ssr_march_grad.restype = ci
        libs[name] = (lib, gather)
    return libs


def one_entry_shim(lib, name: str):
    """A gather tree's library from before the one form-taking entry point
    (ONE_ENTRY), as an object with this tree's entry: it calls the tree's
    vr_composite_grad (all d slices in one launch) for the size rule's
    plan (zc 0) and its vr_ssr_march_grad (int16 codes, the offsets in
    static shared memory) for the fixed form (0), and refuses any other
    (cudaErrorInvalidValue)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "composite_grad":
        old = lib.vr_composite_grad
        old.argtypes = [vp] * 7 + [ci] * 7 + [vp, vp]

        def entry(*a):      # a[14]: the slices a chunk
            return old(*a[:14], *a[15:]) if a[14] <= 0 else 1
    else:
        old = lib.vr_ssr_march_grad
        old.argtypes = [vp] * 7 + [ci] * 8 + [vp] * 4 + [vp]

        def entry(*a):      # a[16]: the form
            return old(*a[:16], *a[17:]) if a[16] == 0 else 1
    old.restype = ci
    return types.SimpleNamespace(**{ONE_ENTRY[name]: entry})


@contextlib.contextmanager
def library(cuda, name: str, lib):
    """This tree's wrappers launching `lib` in place of kernel `name`."""
    real = cuda.lib(name)
    cuda._LIBS[name] = lib
    try:
        yield
    finally:
        cuda._LIBS[name] = real


def other_k14(cuda, zg, froxel, lib, gather):
    """Another tree's K14 with zg._k14's signature."""
    if gather:
        k14 = zg._k14

        def run(form, *args):
            with library(cuda, "composite_grad", lib):
                return k14(form, *args)
        return run

    def run(form, g_img, sc, vd, params, grid):
        w, h, d = grid
        ih, iw = vd.shape
        dev = g_img.device
        fp = froxel.depth_params(params).to(dev)
        out = torch.zeros((4, d, h, w), dtype=torch.float32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        if form == "cells":
            w9 = zg.cell_weights(ih // h, iw // w)
            tables = zg._device_cell_taps(w9.tobytes(), w9.shape[1], dev)
            fn = lib.vr_composite_grad
        else:
            tables = zg._device_taps(ih, iw, (h, ih, 0), w, dev)
            fn = lib.vr_composite_grad_pixels
        err = fn(*(cuda.ptr(t) for t in (g_img, sc, vd, *tables, fp)), w, h,
                 d, ih, iw, cuda.ptr(out), stream)
        if err:
            raise RuntimeError(f"the other K14 failed to launch: {err}")
        return out
    return run


def other_k15(cuda, ssr_ops, lib, gather):
    """Another tree's K15 with ssr_ops.ssr_march_grad's signature."""
    if gather:
        k15 = ssr_ops.ssr_march_grad

        def run(*args):
            with library(cuda, "ssr_march_grad", lib):
                return k15(*args)
        return run

    def run(grads, bin_idx, hit_k, offsets, max_px):
        hq, wq = bin_idx.shape
        taps, counts = ssr_ops.tap_table(offsets, float(max_px),
                                         bin_idx.device)
        outs = [torch.empty_like(bin_idx) for _ in range(3)]
        err = lib.vr_ssr_march_grad(
            *(cuda.ptr(p) for p in (*grads, bin_idx, hit_k, taps, counts)),
            len(offsets), taps.shape[1], hq, wq,
            *(cuda.ptr(o) for o in outs),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the other K15 failed to launch: {err}")
        return tuple(outs)
    return run


def timed_pair(run_other, run_this):
    """(this ms x2, other ms x2), in the order other, this, this, other."""
    o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
    n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
    return [n1, n2], [o1, o2]


def k14_rows(chip_smoke, cuda, zg, froxel, camera, others, bad):
    """K14 in each form on k14_forms' seeded inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    rows = []
    for form, (k4_form, (ih, iw), grid, _) in chip_smoke.K14_FORMS.items():
        w, h, d = grid
        p = froxel.make_froxel_params(camera.fov_y, camera.aspect,
                                      camera.near, 100.0, 0.5, grid)
        rnd = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
        g_img = (rnd(ih, iw, 4) * 2.0 - 1.0).contiguous()
        sc = rnd(ih, iw, 3).contiguous()
        vd = (float(camera.near) + rnd(ih, iw) * 140.0).contiguous()
        args = (g_img, sc, vd, p, grid)
        run_this = lambda: zg.composite_grad(*args, k4_form)
        occ = (ctypes.c_int * 1)()
        fw = zg.grad_footprint(ih, iw, grid, k4_form)[1]
        err = cuda.lib("composite_grad").vr_composite_grad_occupancy(
            int(k4_form == "cells"), d, fw,
            ctypes.cast(occ, ctypes.c_void_p))
        print(f"# composite_grad {form}: footprints {fw} pixels wide, "
              f"{zg.k14_shared_bytes(d, fw)} B of shared memory, {occ[0]} "
              f"blocks an SM (error {err})", flush=True)
        got = run_this()
        twin = zg.composite_grad_plain(*args, k4_form)
        same_twin = torch.equal(got, twin)
        same_self = torch.equal(got, run_this())
        print(f"# composite_grad {form} ({k4_form}, {iw}x{ih} on "
              f"{w}x{h}x{d}): max abs err vs twin "
              f"{float((got - twin).abs().max()):.3e}, = twin bit for bit: "
              f"{same_twin}, two launches bit for bit equal: {same_self}",
              flush=True)
        if not same_twin or not same_self:
            bad.append(f"composite_grad {form} against its twin or itself")
        out = {"row": f"composite_grad {form}", "twin_same": same_twin,
               "self_same": same_self}
        chunked = zg.k14_chunks(d, fw)[0] > 1
        for o_name, libs in others.items():
            if chunked and not hasattr(libs["composite_grad"][0],
                                       "vr_composite_grad_plan"):
                print(f"#   {o_name}: its K14 takes no chunks of slices",
                      flush=True)
                continue
            theirs = other_k14(cuda, zg, froxel, *libs["composite_grad"])
            run_other = lambda: theirs(k4_form, *args)
            ref = run_other()
            err = (got - ref).abs()
            within = bool((err <= 1e-5 + 1e-5 * got.abs()).all())
            this_ms, other_ms = timed_pair(run_other, run_this)
            print(f"#   this {this_ms[0]:.4f} {this_ms[1]:.4f} ms, {o_name}"
                  f" {other_ms[0]:.4f} {other_ms[1]:.4f} ms "
                  f"({sum(other_ms) / sum(this_ms):.2f}x); max abs diff "
                  f"{float(err.max()):.3e}, within 1e-5 + 1e-5 |value|: "
                  f"{within}", flush=True)
            out[o_name] = {"this_ms": this_ms, "other_ms": other_ms,
                           "max_abs_diff": float(err.max()),
                           "within": within}
            bad += [] if within else [f"composite_grad {form} against "
                                      f"{o_name}"]
        rows.append(out)
    return rows


def k15_rows(chip_smoke, cuda, ssr_ops, post, renderer, scene, others,
             bad):
    """K15 on post_showcase's recorded march inputs and its hit record."""
    rows = []
    for row, kw in K15_ROWS.items():
        m_args = showcase(chip_smoke, post, renderer, scene, kw)[0]
        hit_k = ssr_ops.ssr_march(*m_args, record=True)[5]
        gen = torch.Generator(device="cuda")
        gen.manual_seed(23)
        hq, wq = m_args[0].shape
        args = ([torch.randn((hq, wq), generator=gen, device="cuda")
                 for _ in range(3)], m_args[4], hit_k, m_args[6], m_args[8])
        run_this = lambda: ssr_ops.ssr_march_grad(*args)
        got = torch.stack(run_this())
        twin = torch.stack(ssr_ops.ssr_march_grad_plain(*args[:4]))
        same_twin = torch.equal(got, twin)
        same_self = torch.equal(got, torch.stack(run_this()))
        print(f"# ssr_march_grad {row}: {hq}x{wq}, {len(m_args[6])} bins, "
              f"offsets over {ssr_ops.tap_extent(m_args[6])}, fed "
              f"{float((got != 0).float().mean()):.4f}; = twin bit for bit:"
              f" {same_twin}, two launches bit for bit equal: {same_self}",
              flush=True)
        if not same_twin or not same_self:
            bad.append(f"ssr_march_grad {row} against its twin or itself")
        out = {"row": f"ssr_march_grad {row}", "twin_same": same_twin,
               "self_same": same_self}
        for o_name, libs in others.items():
            theirs = other_k15(cuda, ssr_ops, *libs["ssr_march_grad"])
            run_other = lambda: theirs(*args)
            same = torch.equal(got, torch.stack(run_other()))
            this_ms, other_ms = timed_pair(run_other, run_this)
            print(f"#   this {this_ms[0]:.4f} {this_ms[1]:.4f} ms, {o_name}"
                  f" {other_ms[0]:.4f} {other_ms[1]:.4f} ms "
                  f"({sum(other_ms) / sum(this_ms):.2f}x); = {o_name} bit "
                  f"for bit: {same}", flush=True)
            out[o_name] = {"this_ms": this_ms, "other_ms": other_ms,
                           "same": same}
            bad += [] if same else [f"ssr_march_grad {row} against {o_name}"]
        rows.append(out)
    return rows


def backward_ms(loss_of, params) -> float:
    """loss.backward()'s CUDA-event mean over BACKWARD_N steps (one warm
    step first)."""
    total = 0.0
    for i in range(BACKWARD_N + 1):
        for q in params.parameters():
            q.grad = None
        loss = loss_of()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss.backward()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end) if i else 0.0
    return total / BACKWARD_N


def step_rows(chip_smoke, cuda, zg, froxel, ssr_ops, post, demo, others):
    """train_fog's and train_ssr's backward with each tree's K14 and K15."""
    from volumetricrenderer_tpu_torch import (DEMO_CONFIG,
                                              VolumetricRenderer, inverse)
    r = VolumetricRenderer(DEMO_CONFIG)
    colour, depth = r.render_scene_inputs(demo)
    maps = r.bake_shadow_data(demo)
    params, apply_fn, target_scene = chip_smoke.train_setup("fog", inverse,
                                                            demo)
    state = r.init_state(demo.dir_lights.count)
    cfg = post.PostConfig(**chip_smoke.TRAIN_SSR_POST)
    with torch.no_grad():
        fog_target = r.render_frame(state, target_scene, 0.0, colour, depth,
                                    maps)[0][..., :3].contiguous()
        ssr_target = r.render_frame_post(state, target_scene, cfg, 0.0,
                                         colour, depth, maps)[0].contiguous()
    losses = {
        "train_fog": lambda: inverse.image_loss(
            r, apply_fn(params, demo), state, fog_target, colour, depth,
            maps),
        "train_ssr": lambda: torch.mean((r.render_frame_post(
            state, apply_fn(params, demo), cfg, 0.0, colour, depth,
            maps)[0] - ssr_target) ** 2)}
    real = zg._k14, ssr_ops.ssr_march_grad

    def with_kernels(k14, k15, loss_of):
        zg._k14, ssr_ops.ssr_march_grad = k14, k15
        try:
            return backward_ms(loss_of, params)
        finally:
            zg._k14, ssr_ops.ssr_march_grad = real

    rows = []
    for step, loss_of in losses.items():
        out = {"row": f"{step} backward"}
        for o_name, libs in others.items():
            theirs = (other_k14(cuda, zg, froxel, *libs["composite_grad"]),
                      other_k15(cuda, ssr_ops, *libs["ssr_march_grad"]))
            t1 = with_kernels(*real, loss_of)
            o1 = with_kernels(*theirs, loss_of)
            o2 = with_kernels(*theirs, loss_of)
            t2 = with_kernels(*real, loss_of)
            print(f"# {step} backward (CUDA events, mean of {BACKWARD_N}): "
                  f"this {t1:.3f} {t2:.3f} ms, {o_name} {o1:.3f} {o2:.3f} "
                  "ms", flush=True)
            out[o_name] = {"this_ms": [t1, t2], "other_ms": [o1, o2]}
        rows.append(out)
    return rows


def main() -> int:
    rows_only = "--rows-only" in sys.argv[1:]
    trees = [a for a in sys.argv[1:] if a != "--rows-only"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k14_k15_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, VolumetricRenderer,
                                              benchmark_scene, demo_scene,
                                              froxel, post)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops
    from volumetricrenderer_tpu_torch.ops import zg_composite as zg

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda.build(verbose=True)
    for name in GATHER_MARK:
        print(f"# kernel attributes, {name}: {cuda.kernel_attrs(name)}",
              flush=True)
    others = {arg: build_other(Path(arg).resolve(),
                               cuda.BUILD_DIR / f"k14_k15_other{i}", cuda)
              for i, arg in enumerate(trees)}
    aspect = FULL_CONFIG.image_width / FULL_CONFIG.image_height
    demo = demo_scene(aspect=aspect)
    bad = []
    rows = k14_rows(chip_smoke, cuda, zg, froxel, demo.camera, others, bad)
    renderer = VolumetricRenderer(FULL_CONFIG)
    scene = benchmark_scene(aspect=aspect, num_local_lights=16,
                            noise_mode="procedural")
    rows += k15_rows(chip_smoke, cuda, ssr_ops, post, renderer, scene,
                     others, bad)
    if not rows_only:
        rows += step_rows(chip_smoke, cuda, zg, froxel, ssr_ops, post, demo,
                          others)
    print(json.dumps({"device": smi, "rows": rows}), flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K14 and K15 case agrees", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
