"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's production frame (FULL_CONFIG: 240x135x128 froxels,
1920x1080, on benchmark_scene with 16 local lights and procedural noise)
through VolumetricRenderer, the entry point a user calls, and:

  1. prints the device and `nvidia-smi` name + power limit; exits non-zero
     without CUDA;
  2. builds every CUDA kernel from csrc/ (nvcc, all sources in parallel);
  3. computes the G-buffer once;
  4. renders a deterministic 4-frame sequence from a fresh state
     (time_x = 0.1 i) with the launch counters set to 0 just before and read
     just after; prints the float32 image checksum and checks that the image
     is finite and not flat;
  5. holds each kernel against its plain-torch twin on the inputs of a real
     frame, with the tolerances stated in CHECKS;
  6. times warm frames and each kernel (CUDA events), each twin, and
     torch.nn.functional.grid_sample as a yardstick for the composite;
  7. prints the `kernels` JSON line, then the result line.

Every failure raises: the script exits 0 only if every phase passed.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

# bytes/s of HBM and fp32 (non-tensor-core) FLOP/s of an H100 SXM at its
# full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel -> (allowed |kernel - twin| per element: atol + rtol*|twin|, the
# largest fraction of elements allowed past it, why)
CHECKS = {
    "bake_radiance": (1e-6, 1e-5, 1e-3,
                      "any-hit booleans may flip for rays within ulps of an "
                      "epsilon"),
    "shadow_scatter": (1e-6, 1e-5, 5e-3,
                       "shadow rays at primitive boundaries may flip"),
    "integrate_blend": (1e-6, 1e-4, 0.0,
                        "128-slice front-to-back sums of exp/log terms "
                        "differ by a few ulp per slice"),
    "composite": (1e-6, 1e-5, 0.0, "log() ulps in the froxel z mapping"),
}

REPLACES = {
    "bake_radiance": "volumetricrenderer_tpu/ops/pallas/frame_fused.py:124",
    "shadow_scatter": "volumetricrenderer_tpu/ops/pallas/frame_fused.py:124",
    "integrate_blend": "volumetricrenderer_tpu/ops/pallas/frame_fused.py:124",
    "composite": "volumetricrenderer_tpu/ops/pallas/zg_composite.py:83",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, n: int) -> float:
    """Mean device time of fn() over n calls after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Check a kernel output against its twin per CHECKS; returns the max
    abs error."""
    atol, rtol, frac_ok, why = CHECKS[name]
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    frac = float((err > atol + rtol * want.abs()).float().mean())
    max_err = float(err.max())
    log(f"# check {name}: max_abs_err {max_err:.3e}, fraction past "
        f"atol {atol:g} + rtol {rtol:g} = {frac:.2e} (allowed {frac_ok:g}: "
        f"{why})")
    if frac > frac_ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def profile_frames(step, n: int) -> None:
    """torch.profiler over n warm frames: device busy share of the window
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern or busy_ms <= 0.0:
        log("# profile: no device time recorded (device busy share not "
            "measured)")
        return
    log(f"# profile over {n} frames: window {window_ms / n:.3f} ms/frame "
        f"(host clock, profiler on), device busy {busy_ms / n:.3f} "
        f"ms/frame = {busy_ms / window_ms:.1%}, {len(kern)} kernel names, "
        f"{sum(e.count for e in kern) / n:.0f} launches/frame")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"#   {e.self_device_time_total / 1e3 / n:8.4f} ms/frame "
            f"x{e.count // n:<4d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from volumetricrenderer_tpu_torch import (FULL_CONFIG, VolumetricRenderer,
                                              benchmark_scene)
    from volumetricrenderer_tpu_torch.ops import cuda, frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import zg_composite as zg

    t_start = time.perf_counter()
    # 1. device
    dev_name = torch.cuda.get_device_name(0)
    n_dev = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"# device: {dev_name} x{n_dev}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda.build(verbose=True)
    log(f"# build: {time.perf_counter() - t0:.1f} s wall, per source "
        f"{json.dumps({k: round(v, 1) for k, v in build_s.items()})}")

    # 3. production config, scene and G-buffer
    cfg = FULL_CONFIG
    renderer = VolumetricRenderer(cfg)
    scene = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                            num_local_lights=16, noise_mode="procedural")
    t0 = time.perf_counter()
    scene_color, view_depth = renderer.render_scene_inputs(scene)
    torch.cuda.synchronize()
    log(f"# gbuffer: {1e3 * (time.perf_counter() - t0):.1f} ms "
        f"{tuple(scene_color.shape)}")

    # 4. the main path: 4 frames from a fresh state
    cuda.reset_launches()
    state = renderer.init_state(scene.dir_lights.count)
    states = [state]
    img = None
    for i in range(4):
        img, _, state = renderer.render_frame(state, scene, 0.1 * i,
                                              scene_color, view_depth)
        states.append(state)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"# launches in the 4-frame run: {json.dumps(launches)}")
    if not all(launches[k] > 0 for k in cuda.SOURCES):
        raise AssertionError("a kernel of the main path was never launched")
    checksum = float(img.sum(dtype=torch.float32))
    finite = bool(torch.isfinite(img).all())
    std = float(img[..., :3].std())
    log(f"# image {tuple(img.shape)} checksum {checksum!r} std {std:.4g}")
    if not finite:
        raise AssertionError("non-finite frame output")
    if not std > 1e-4:
        raise AssertionError("degenerate frame output")

    # 5. each kernel against its twin on the inputs of frame 4 (index 3)
    prev = states[3]
    tables, params, _ = renderer.frame_tables(prev, scene, 0.1 * 3)
    prev_sh = prev.prev_shadow.float().contiguous()
    prev_acc = prev.prev_accumulation.float().contiguous()
    bake = ff.bake_radiance(tables)
    sh, sc = ff.shadow_scatter(tables, prev_sh, bake)
    acc = ff.integrate_blend(tables, sc, prev_acc)
    out = zg.composite(acc, scene_color, view_depth, params, cfg.grid)
    errs = {}
    errs["bake_radiance"] = compare("bake_radiance", bake,
                                    ff.bake_radiance_plain(tables))
    sh_p, sc_p = ff.shadow_scatter_plain(tables, prev_sh, bake)
    errs["shadow_scatter"] = max(compare("shadow_scatter", sh, sh_p),
                                 compare("shadow_scatter", sc, sc_p))
    # K2's two non-production branches: the jittered sun scatter and the
    # fBm evaluated per froxel (no baked noise channel)
    opt = dataclasses.replace(tables, jitter_dir=True, n_noise=0)
    bake_rgb = bake[:3].contiguous()
    errs["shadow_scatter"] = max(
        errs["shadow_scatter"],
        compare("shadow_scatter", ff.shadow_scatter(opt, prev_sh, bake_rgb)[1],
                ff.shadow_scatter_plain(opt, prev_sh, bake_rgb)[1]))
    errs["integrate_blend"] = compare(
        "integrate_blend", acc, ff.integrate_blend_plain(tables, sc, prev_acc))
    errs["composite"] = compare(
        "composite", out, zg.composite_plain(acc, scene_color, view_depth,
                                             params, cfg.grid))
    frame4 = torch.equal(out, img)
    log(f"# frame-4 inputs reproduce the main path's image: {frame4}")
    if not frame4:
        raise AssertionError("the kernel chain on frame-4 inputs differs "
                             "from the main path's last image")

    # 6. timing
    n_frames = 20
    st = states[-1]

    def one_frame():
        nonlocal st
        _, _, st = renderer.render_frame(st, scene, 0.5, scene_color,
                                         view_depth)

    frame_ms = cuda_time_ms(one_frame, n_frames)
    t0 = time.perf_counter()
    for _ in range(n_frames):
        one_frame()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_frames
    log(f"# frame: {frame_ms:.3f} ms device-event mean, {wall_ms:.3f} ms "
        f"host wall mean over {n_frames} warm frames")
    t0 = time.perf_counter()
    for _ in range(n_frames):
        renderer.frame_tables(st, scene, 0.5)
    torch.cuda.synchronize()
    log(f"# host prep (frame_tables): "
        f"{1e3 * (time.perf_counter() - t0) / n_frames:.3f} ms/frame")
    profile_frames(one_frame, 5)

    n = 20
    ms = {
        "bake_radiance": cuda_time_ms(lambda: ff.bake_radiance(tables), n),
        "shadow_scatter": cuda_time_ms(
            lambda: ff.shadow_scatter(tables, prev_sh, bake), n),
        "integrate_blend": cuda_time_ms(
            lambda: ff.integrate_blend(tables, sc, prev_acc), n),
        "composite": cuda_time_ms(
            lambda: zg.composite(acc, scene_color, view_depth, params,
                                 cfg.grid), n),
    }
    n_p = 3
    plain_ms = {
        "bake_radiance": cuda_time_ms(lambda: ff.bake_radiance_plain(tables),
                                      n_p),
        "shadow_scatter": cuda_time_ms(
            lambda: ff.shadow_scatter_plain(tables, prev_sh, bake), n_p),
        "integrate_blend": cuda_time_ms(
            lambda: ff.integrate_blend_plain(tables, sc, prev_acc), n_p),
        "composite": cuda_time_ms(
            lambda: zg.composite_plain(acc, scene_color, view_depth, params,
                                       cfg.grid), n_p),
    }
    # yardstick for K4: one grid_sample computing the same trilinear of
    # (L, T) at (pixel -> froxel xy, fz), border clamp (used nowhere else)
    w, h, d = cfg.grid
    ih, iw = view_depth.shape
    from volumetricrenderer_tpu_torch import froxel
    fz = torch.clamp(froxel.depth_to_froxel_z(params, view_depth) - 0.5,
                     0.0, d - 1.0)
    gx = ((torch.arange(iw, device="cuda") + 0.5) / iw * 2.0 - 1.0)
    gy = ((torch.arange(ih, device="cuda") + 0.5) / ih * 2.0 - 1.0)
    gz = (fz + 0.5) / d * 2.0 - 1.0
    grid = torch.stack([gx[None, :].expand(ih, iw), gy[:, None].expand(ih, iw),
                        gz], dim=-1)[None, None].contiguous()
    vol = acc[None]
    gs = lambda: torch.nn.functional.grid_sample(
        vol, grid, mode="bilinear", padding_mode="border",
        align_corners=False)
    lib_ms = cuda_time_ms(gs, n)
    gs_err = float((gs()[0, :, 0].permute(1, 2, 0)[..., 3]
                    - out[..., 3]).abs().max())
    log(f"# grid_sample yardstick: {lib_ms:.4f} ms, max |T - K4 T| "
        f"{gs_err:.2e}")

    # bounds from this run's inputs (bytes each read once / written once;
    # the operations the function needs, counted from the plain versions'
    # arithmetic, at the fp32 rate)
    wl, hl, dl = tables.low_dims
    n_low = wl * hl * dl
    n_fro = w * h * d
    n_pix = ih * iw
    nd = tables.n_dir
    prims = tables.n_planes + tables.n_spheres + tables.n_boxes
    ops_ray = 14 * tables.n_planes + 22 * tables.n_spheres \
        + 30 * tables.n_boxes
    active_pairs = int(tables.active.sum()) * hl * wl
    ops_perlin = 3 * 8 * 40      # 3 octaves x 8 corners x hash + grad + lerp
    n_noise = tables.n_noise
    # one reprojection per froxel and blend: the three tent passes read
    # offsets taken at their own output points, so each froxel's offset
    # triple serves all three (the kernels recompute neighbours' offsets,
    # which is their choice, not the function's work)
    ops_reproj = 45
    # the three 1-D tent passes: 6 tent weights (4 ops each) per froxel,
    # then 6 taps (multiply + add) per channel
    warp = lambda channels: 24 + 12 * channels
    work = {
        "bake_radiance": (
            4 * (3 + n_noise) * n_low,
            n_low * (60 + ops_perlin * n_noise)
            + active_pairs * (60 + ops_ray)),
        "shadow_scatter": (
            4 * (nd * n_fro + (3 + n_noise) * n_low
                 + nd * n_fro + 4 * n_fro),
            n_fro * (ops_reproj + warp(nd) + nd * (30 + ops_ray)
                     + (3 + n_noise) * 20 + 60 * len(scene.media)
                     + 40 * nd + 40)),
        "integrate_blend": (
            4 * (4 * n_fro + 4 * n_fro + 4 * n_fro),
            n_fro * (4 * 20 + 30 + ops_reproj + warp(4) + 12)),
        "composite": (
            4 * (4 * n_fro + n_pix + 3 * n_pix + 4 * n_pix),
            n_pix * (20 + 8 * 4 * 2 + 16)),
    }
    log(f"# bound inputs: {prims} primitives, {active_pairs} active "
        f"(low sample, light) pairs, {n_noise} noise channel(s)")
    kernels = []
    for name in cuda.SOURCES:
        nbytes, nops = work[name]
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * nops / FP32_FLOPS
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"volumetricrenderer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms if name == "composite" else None,
        })
        log(f"# {name}: {ms[name]:.4f} ms/launch, plain {plain_ms[name]:.3f}"
            f" ms, bound {max(t_bytes, t_ops):.4f} ms "
            f"({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP)")
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
