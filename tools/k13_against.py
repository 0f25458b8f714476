"""Hold kernel K13 (ssr_march) of the PyTorch/CUDA port against the same
kernel built from other checkouts of the repository, on one NVIDIA GPU.

    python3 tools/k13_against.py [--rows-only] OTHER_CHECKOUT [...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/ssr_march.cu with the same flags, then records the inputs
of K13's last launch on two rows, each the last of 4 frames of
chip_smoke.py's post_showcase loop (the fused frame at full width, the
camera orbiting, demo.py's showcase PostConfig):

  post_showcase               the default march: 8 bins of <= 12 taps;
  ssr_steps=24, ssr_dirs=16   a larger table than any chip run has seen.

On each: this tree's kernel against its twin (max abs error, the share of
elements past chip_smoke.CHECKS' tolerance, and bit for bit; the twin's
time, a CUDA-event mean of 3 calls), and against
each other checkout's kernel, bit for bit (torch.equal); both kernels'
times, CUDA-event means of 20 launches behind a device-side spin
(k3_k4_against.spin_time_ms), in the order other, this, this, other. Then
the device busy time of a post_showcase frame (torch.profiler over 5
frames, k10_k11_against.busy_ms) with this tree's K13 and with each other
checkout's in its place, in the order this, other, other, this (not with
--rows-only). Prints the card's name and power limit first and a JSON line
of the rows last. Exits non-zero on a disagreement or without a GPU.

Another checkout's K13 is called through vr_ssr_march_form (no hit
record, the size rule's form) where its library has that entry, else
through its vr_ssr_march, which takes the same arguments less those two;
its tap table is the packed float4 rows of ops/ssr.pack_taps where its
library has vr_ssr_march_geometry, else the first form's [n_bins,
max_taps, 5] rows (t_prev, t, t / max_px, oy, ox).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from k10_k11_against import busy_ms  # noqa: E402
from k3_k4_against import spin_time_ms  # noqa: E402

ROWS = {"post_showcase": {},
        "ssr_steps=24, ssr_dirs=16": dict(ssr_steps=24, ssr_dirs=16)}
FRAMES = 4


def build_other(other: Path, out: Path, cuda):
    """The other checkout's K13 library, built with this tree's flags into
    `out`, with its launch entry point's argument types."""
    out.mkdir(parents=True, exist_ok=True)
    src = other / "volumetricrenderer_tpu_torch" / "csrc" / "ssr_march.cu"
    proc = subprocess.run(
        [cuda._nvcc(), *cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(out / "ssr_march.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    print(f"# nvcc {other} ssr_march:\n{proc.stdout}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {other}'s ssr_march")
    lib = ctypes.CDLL(str(out / "ssr_march.so"))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if hasattr(lib, "vr_ssr_march_form"):
        cuda._declare(lib, "ssr_march")
    else:
        lib.vr_ssr_march.argtypes = ([vp] * 10 + [ci, ci, ci, ci, cf]
                                     + [vp] * 6)
        lib.vr_ssr_march.restype = ci
    return lib


def first_form_table(offsets: tuple, max_px: float):
    """The first form's tap table: [n_bins, max_taps, 5] float32 rows
    (t_prev, t, t / max_px, oy, ox) and int32 counts."""
    n_taps = max(max((len(b) for b in offsets), default=0), 1)
    rows = np.zeros((len(offsets), n_taps, 5), np.float32)
    for b, taps in enumerate(offsets):
        for i, (t_prev, t, oy, ox) in enumerate(taps):
            rows[b, i] = (t_prev, t, t / max_px, oy, ox)
    return rows, np.array([len(b) for b in offsets], np.int32)


def other_march(lib, cuda, ssr_ops):
    """Another tree's K13 in ops/ssr.ssr_march's place, with its own tap
    table (made once per table)."""
    packed = hasattr(lib, "vr_ssr_march_geometry")
    # one entry point: no hit record, the size rule's form
    launch = (lambda *a: lib.vr_ssr_march_form(*a[:-1], None, -1, a[-1])) \
        if hasattr(lib, "vr_ssr_march_form") else lib.vr_ssr_march
    tables = {}

    def run(dq, colors, invz0, g, bin_idx, valid, offsets, thickness,
            max_px, outs=None):
        key = (offsets, float(max_px))
        if key not in tables:
            rows, counts = (ssr_ops.pack_taps if packed
                            else first_form_table)(offsets, float(max_px))
            tables[key] = (cuda.upload(rows, dq.device),
                           cuda.upload(counts, dq.device, torch.int32))
        taps, counts = tables[key]
        hq, wq = dq.shape
        if outs is None:
            outs = [torch.empty_like(dq) for _ in range(5)]
        planes = (dq, *colors, invz0, g, bin_idx, valid)
        err = launch(
            *(cuda.ptr(p) for p in planes), cuda.ptr(taps), cuda.ptr(counts),
            len(offsets), taps.shape[1], hq, wq,
            float(np.float32(thickness)), *(cuda.ptr(o) for o in outs),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"the other K13 failed to launch: {err}")
        return tuple(outs)
    return run


def showcase(chip_smoke, post, renderer, scene, kw):
    """post_showcase's 4 frames with PostConfig changes kw: the inputs of
    K13's last launch, and (the state, adapted luma) after the last
    frame."""
    from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops
    cfg = post.PostConfig(**{**chip_smoke.SHOWCASE_POST, **kw})
    state = renderer.init_state(scene.dir_lights.count)
    carry = torch.ones((), device="cuda")
    rec, real = [], ssr_ops.ssr_march

    def recording(*args):
        rec[:] = [args]
        return real(*args)

    ssr_ops.ssr_march = recording
    try:
        for i in range(FRAMES):
            _, state, carry = chip_smoke.post_frame(
                "post_showcase", renderer, post, cfg, state,
                chip_smoke.orbit(scene, i), 0.1 * i, None, None, carry)
    finally:
        ssr_ops.ssr_march = real
    torch.cuda.synchronize()
    if not rec:
        raise RuntimeError("post_showcase launched no K13")
    return rec[0], cfg, state, carry


def main() -> int:
    rows_only = "--rows-only" in sys.argv[1:]
    trees = [a for a in sys.argv[1:] if a != "--rows-only"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k13_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, VolumetricRenderer,
                                              benchmark_scene, post)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cuda.build(verbose=True)
    print(f"# kernel attributes, ssr_march: {cuda.kernel_attrs('ssr_march')}",
          flush=True)
    others = {arg: build_other(Path(arg).resolve(),
                               cuda.BUILD_DIR / f"k13_other{i}", cuda)
              for i, arg in enumerate(trees)}
    renderer = VolumetricRenderer(FULL_CONFIG)
    scene = benchmark_scene(
        aspect=FULL_CONFIG.image_width / FULL_CONFIG.image_height,
        num_local_lights=16, noise_mode="procedural")
    colour, depth = renderer.render_scene_inputs(scene)
    records = {row: showcase(chip_smoke, post, renderer, scene, kw)
               for row, kw in ROWS.items()}

    atol, rtol, frac_ok, _ = chip_smoke.CHECKS["ssr_march"]
    bad, rows = [], []
    for row, (args, _, _, _) in records.items():
        run_this = lambda: ssr_ops.ssr_march(*args)
        got = torch.stack(run_this())
        want = torch.stack(ssr_ops.ssr_march_reference(*args))
        err = (got - want).abs()
        twin = float(err.max())
        flipped = float((err > atol + rtol * want.abs()).float().mean())
        same_twin = torch.equal(got, want)
        hq, wq = args[0].shape
        offsets = args[6]
        plain = chip_smoke.cuda_time_ms(
            lambda: ssr_ops.ssr_march_reference(*args), 3)
        print(f"# ssr_march {row}, {hq}x{wq} planes, {len(offsets)} bins, "
              f"taps {[len(b) for b in offsets]}, hit share "
              f"{float(got[3].mean()):.4f}: max abs err vs twin {twin:.3e}, "
              f"share past the tolerance {flipped:.3e} (allowed {frac_ok}),"
              f" = twin bit for bit: {same_twin}; twin {plain:.3f} ms (CUDA "
              "events, mean of 3)", flush=True)
        if not bool(torch.isfinite(got).all()) or flipped > frac_ok \
                or not same_twin:
            bad.append(f"ssr_march {row} against its twin")
        out = {"row": row, "shape": [hq, wq], "bins": len(offsets),
               "taps": [len(b) for b in offsets], "twin_err": twin,
               "twin_flipped": flipped, "twin_same": same_twin,
               "plain_ms": plain}
        for o_name, lib in others.items():
            theirs = other_march(lib, cuda, ssr_ops)
            ref = [torch.empty_like(args[0]) for _ in range(5)]
            run_other = lambda: theirs(*args, outs=ref)
            run_other()
            same = torch.equal(got, torch.stack(ref))
            o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
            n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms ({(o1 + o2) / (n1 + n2):.2f}x); = {o_name} "
                  f"bit for bit: {same}", flush=True)
            if not same:
                diff = (got - torch.stack(ref)).abs()
                print(f"#   differs on {int((diff > 0).sum())} of "
                      f"{diff.numel()} elements, max {float(diff.max()):.3e}",
                      flush=True)
            out[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            bad += [] if same else [f"ssr_march {row} against {o_name}"]
        rows.append(out)

    busy = {}
    if not rows_only:
        # post_showcase's frame with a fixed camera and G-buffer
        _, cfg, state, carry = records["post_showcase"]

        def frame():
            chip_smoke.post_frame("post_showcase", renderer, post, cfg,
                                  state, scene, 0.5, colour, depth, carry)

        real = ssr_ops.ssr_march
        for o_name, lib in others.items():
            theirs = other_march(lib, cuda, ssr_ops)

            def with_march(march):
                ssr_ops.ssr_march = march
                try:
                    return busy_ms(frame)
                finally:
                    ssr_ops.ssr_march = real
            t1, o1 = with_march(real), with_march(theirs)
            o2, t2 = with_march(theirs), with_march(real)
            print(f"# post_showcase frame, device busy: this {t1:.4f} "
                  f"{t2:.4f} ms, {o_name} {o1:.4f} {o2:.4f} ms", flush=True)
            busy[o_name] = {"this_ms": [t1, t2], "other_ms": [o1, o2]}
    print(json.dumps({"device": smi, "rows": rows,
                      "post_showcase_busy": busy}), flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K13 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
