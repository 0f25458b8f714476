"""Hold kernels K3 (integrate_blend) and K4 (composite, cells form) of the
PyTorch/CUDA port against the same kernels built from other checkouts of
the repository, on one NVIDIA GPU.

    python3 tools/k3_k4_against.py OTHER_CHECKOUT [OTHER_CHECKOUT ...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/integrate_blend.cu and csrc/composite.cu with the same
flags, then renders 2 frames each of the fused frame (FULL_CONFIG), the
slab path in 3 shards (make_multislab_render), the demo grid (160x88x64 at
1280x720), UHD at composite_upsample=1 (16x16-pixel cells) and UHD_CONFIG
(the co-sited planes), recording the inputs of each K3 and K4 launch. On
the last inputs of each: this tree's kernel against its twin (max abs
error) and against each other checkout's kernel (bit for bit), and both
kernels' times, CUDA-event means of 20 launches behind a device-side spin,
in the order other, this, this, other. Prints the card's name and power
limit first. Exits non-zero on a disagreement or without a GPU. An other
checkout's K4 takes the [9, py*px] weight table, as the first cells form
did, unless its library has `vr_composite_attrs` (the 2x2 tables of
zg_composite.cell_taps); its K3 takes the same VrTables.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def spin_time_ms(fn, n: int = 20) -> float:
    """Mean device time of fn() over n launches queued behind a spin."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def new_form_turns(run_other, run_this, run_new, n: int = 20) -> tuple:
    """Times of another tree's kernel, this tree's in its size rule's form
    and this tree's in a forced new form, in the order other, this, new,
    new, this, other: ([other], [this], [new]), two each."""
    o1, n1 = spin_time_ms(run_other, n), spin_time_ms(run_this, n)
    x1, x2 = spin_time_ms(run_new, n), spin_time_ms(run_new, n)
    n2, o2 = spin_time_ms(run_this, n), spin_time_ms(run_other, n)
    return [o1, o2], [n1, n2], [x1, x2]


def rule_entry(lib, name: str, argtypes: list):
    """Kernel `name`'s launch in the size rule's form through another
    tree's library `lib`, with the arguments of its `vr_<name>` entry
    (argtypes, the stream last): a tree with one form-taking entry point
    `vr_<name>_form` (K2, K3 and K9 since their wide forms, K5, K6, K7 and
    K8 since theirs) is called there with the form -1 before the stream, an
    older tree at `vr_<name>`."""
    form = getattr(lib, f"vr_{name}_form", None)
    if form is None:
        old = getattr(lib, f"vr_{name}")
        old.argtypes, old.restype = argtypes, ctypes.c_int
        return old
    form.argtypes = argtypes[:-1] + [ctypes.c_int, argtypes[-1]]
    form.restype = ctypes.c_int
    return lambda *a: form(*a[:-1], -1, a[-1])


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K3 and K4 libraries, built with this tree's
    flags into `out`, each library loaded with its entry point's argument
    types."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in ("integrate_blend", "composite"):
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
    libs["integrate_blend"].vr_integrate_blend = rule_entry(
        libs["integrate_blend"], "integrate_blend",
        [ctypes.POINTER(cuda.VrTables), vp, vp, vp, vp])
    n_ptr = 6 if hasattr(libs["composite"], "vr_composite_attrs") else 5
    libs["composite"].vr_composite.argtypes = \
        [vp] * n_ptr + [ci] * 7 + [vp, vp]
    return libs


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k3_k4_against: no CUDA device", file=sys.stderr)
        return 2
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, VolumetricRenderer,
                                              benchmark_scene, demo_scene)
    from volumetricrenderer_tpu_torch.ops import cuda, frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import zg_composite as zg
    from volumetricrenderer_tpu_torch.parallel import shard_render as shr

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cuda.build(verbose=True)
    for src in cuda.ATTR_KERNELS:
        print(f"# kernel attributes, {src}: {cuda.kernel_attrs(src)}",
              flush=True)
    others = {arg: build_other(Path(arg).resolve(),
                               cuda.BUILD_DIR / f"other{i}", cuda)
              for i, arg in enumerate(sys.argv[1:])}

    k3_in, k4_in = {}, {}
    label = {"v": ""}
    real_k3, real_k4 = ff.integrate_blend, zg._launch

    def rec_k3(t, scatter, prev_acc):
        k3_in[label["v"]] = (t, scatter, prev_acc)
        return real_k3(t, scatter, prev_acc)

    def rec_k4(*args, **kw):
        k4_in[label["v"]] = (args, kw)
        return real_k4(*args, **kw)

    ff.integrate_blend, zg._launch = rec_k3, rec_k4
    cfg = FULL_CONFIG
    scene = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                            num_local_lights=16, noise_mode="procedural")
    uhd = dict(image_width=3840, image_height=2160)
    production = dict(volume_width=160, volume_height=88, volume_depth=64,
                      image_width=1280, image_height=720,
                      raycast_shadow_subsample=2, dir_shadow_subsample=1)
    try:
        for name, kw, scn in (
                ("full grid", {}, scene),
                ("demo grid", production, demo_scene(
                    aspect=cfg.image_width / cfg.image_height)),
                ("16x16 cells 4K", dict(uhd, composite_upsample=1), scene),
                ("co-sited planes", dict(uhd, composite_upsample=2), scene)):
            r = VolumetricRenderer(dataclasses.replace(cfg, **kw))
            colour, depth = r.render_scene_inputs(scn)
            st = r.init_state(scn.dir_lights.count)
            label["v"] = name
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth)
        r = VolumetricRenderer(cfg)
        colour, depth = r.render_scene_inputs(scene)
        fn = shr.make_multislab_render(r, 3, fixed_inputs=(
            list(colour.chunk(3)), list(depth.chunk(3))))
        carry = fn.init_carry(scene.dir_lights.count)
        label["v"] = "slab3 shard"
        for i in range(2):
            _, carry = fn(carry, scene, 0.1 * i)
    finally:
        ff.integrate_blend, zg._launch = real_k3, real_k4
    torch.cuda.synchronize()

    bad = []
    for name, (t, sc, prev) in k3_in.items():
        st = t.c_struct()
        run_this = lambda: ff.integrate_blend(t, sc, prev)
        got = run_this()
        twin = float((got - ff.integrate_blend_plain(t, sc, prev)).abs()
                     .max())
        print(f"# K3 {name} {t.grid_whd}: max abs err vs twin {twin:.3e}",
              flush=True)
        for o_name, other in others.items():
            ref = torch.empty_like(prev)
            run_other = lambda: other["integrate_blend"].vr_integrate_blend(
                ctypes.byref(st), cuda.ptr(sc), cuda.ptr(prev),
                cuda.ptr(ref),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if run_other():
                raise RuntimeError(f"{o_name}'s K3 failed to launch")
            same = torch.equal(got, ref)
            o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
            n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms; = {o_name} bit for bit: {same}",
                  flush=True)
            bad += [] if same else [f"K3 {name} against {o_name}"]
    for name, (args, kw) in k4_in.items():
        acc, colour, depth, params, grid, w9, out, *rest = args
        row_off = rest[0] if rest else kw.get("row_off", 0)
        w, h, d = grid
        ih, iw = depth.shape
        fp = torch.stack([params.z, params.w, params.near]).to(
            device=acc.device, dtype=torch.float32)
        run_this = lambda: real_k4(*args, **kw)
        got = run_this().clone()
        if colour is None:
            want = zg._sample_plain(acc, depth, params, grid, w9)
        else:
            want = zg.composite_plain(acc, colour, depth, params, grid,
                                      row_off)
        twin = float((got - want).abs().max())
        print(f"# K4 {name} {tuple(depth.shape)} row_off {row_off}: max abs "
              f"err vs twin {twin:.3e}", flush=True)
        bad += [] if twin == 0.0 else [f"K4 {name} against its twin"]
        for o_name, other in others.items():
            ref = torch.empty_like(out)
            tables = (zg._device_cell_taps(w9.tobytes(), w9.shape[1],
                                           acc.device)
                      if hasattr(other["composite"], "vr_composite_attrs")
                      else (cuda.upload(w9, acc.device),))
            run_other = lambda: other["composite"].vr_composite(
                cuda.ptr(acc), None if colour is None else cuda.ptr(colour),
                cuda.ptr(depth), *(cuda.ptr(x) for x in tables),
                cuda.ptr(fp), w, h, d, ih, iw, acc.shape[2], row_off,
                cuda.ptr(ref),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if run_other():
                raise RuntimeError(f"{o_name}'s K4 failed to launch")
            same = torch.equal(got, ref)
            o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
            n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms; = {o_name} bit for bit: {same}",
                  flush=True)
            bad += [] if same else [f"K4 {name} against {o_name}"]
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K3 and K4 case agrees with its twin and the others",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
