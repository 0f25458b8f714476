"""Hold kernels K9 (bake_visibility) and K12 (pcf_shadow) of the
PyTorch/CUDA port against the same kernels built from other checkouts of
the repository, on one NVIDIA GPU.

    python3 tools/k9_k12_against.py [--rows-only] OTHER_CHECKOUT [...]

Builds this tree's kernels (cuda.build, ptxas report on) and each other
checkout's csrc/bake_visibility.cu and csrc/pcf_shadow.cu with the same
flags, then renders 2 frames of each path of chip_smoke.py below,
recording the inputs of each kernel's last launch by row:

  K12  map_dir (the low-rate grid, 120x135x64), map_dir_full_rate
       (240x135x128) and demo_map_dir; map_dir's tables with a second
       sun (chip_smoke.two_suns: one launch here, two for a tree that
       launches a sun at a time); and map_dir's tables on a slab's rows
       (chip_smoke.band_pcf_tables: the slab form, its first row in the
       tables);
  K9   vis_bake, history, demo_vis_hf (one spot light whose rays march the
       terrain) and vis_bake's configuration on
       benchmark_scene(num_local_lights=40).

On each: this tree's kernel against its twin (max abs error and the share
of elements past chip_smoke.CHECKS' tolerance), and against each other
checkout's kernel, bit for bit (torch.equal); both kernels' times,
CUDA-event means of 20 launches behind a device-side spin, in the order
other, this, this, other. Then the device busy time of a frame of map_dir,
map, vis_bake and history (torch.profiler over 5 warm frames) with this
tree's K9 and K12 and with each other checkout's in their place, in the
order this, other, other, this (not with --rows-only). Prints the card's name and power limit
first and a JSON line of the rows last. Exits non-zero on a disagreement
or without a GPU. The other checkouts' kernels take the same arguments
(vr_bake_visibility, and vr_pcf_shadow for one sun).
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
from k3_k4_against import rule_entry, spin_time_ms  # noqa: E402

SOURCES = ("bake_visibility", "pcf_shadow")
# row -> (chip_smoke.py path whose configuration it runs, its scene, the
# kernel recorded)
ROWS = {"map_dir": ("map_dir", "bench", "pcf_shadow"),
        "map_dir_full_rate": ("map_dir_full_rate", "bench", "pcf_shadow"),
        "demo_map_dir": ("demo_map_dir", "demo", "pcf_shadow"),
        "vis_bake": ("vis_bake", "bench", "bake_visibility"),
        "history": ("history", "bench", "bake_visibility"),
        "demo_vis_hf": ("demo_vis_hf", "demo", "bake_visibility"),
        "vis_bake, 40 lights": ("vis_bake", "bench40", "bake_visibility")}
BUSY_PATHS = ("map_dir", "map", "vis_bake", "history")
# K12's slab row: the first row and the rows of slab3's middle shard with
# its halo (parallel/shard_render)
SLAB_ROWS = (39, 57)


def declare(libs: dict) -> dict:
    """The launch entry points' argument types, as ops/cuda declares them."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    vis = libs["bake_visibility"]
    vis.vr_bake_visibility = rule_entry(vis, "bake_visibility", [vp, vp, vp])
    if getattr(vis, "vr_bake_visibility_form", None) is None:
        # this tree's wrapper, with the library swapped in, launches the
        # form-taking entry: a tree from before it has the narrow form alone
        old = vis.vr_bake_visibility
        vis.vr_bake_visibility_form = (
            lambda t, out, form, stream: old(t, out, stream)
            if form <= 0 else 1)
    libs["pcf_shadow"].vr_pcf_shadow.argtypes = [vp] * 6 + [ci] * 6 + [vp,
                                                                      vp]
    libs["pcf_shadow"].vr_pcf_shadow.restype = ci
    return libs


def build_other(other: Path, out: Path, cuda) -> dict:
    """The other checkout's K9 and K12 libraries, built with this tree's
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


def other_pcf(lib, cuda):
    """K12 of another tree in ops/pcf_shadow.pcf_shadow's place: its
    vr_pcf_shadow, one launch a sun (into `out` where one is given)."""
    def run(t, atlas, out=None):
        w, h, d = t.grid_whd
        nd, nc = t.par.shape[0], t.spheres.shape[1]
        if out is None:
            out = torch.empty((nd, d, h, w), dtype=torch.float32,
                              device=atlas.device)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for li in range(nd):
            if lib.vr_pcf_shadow(
                    cuda.ptr(t.par[li]), cuda.ptr(t.coef[li]),
                    cuda.ptr(t.order[li]), cuda.ptr(t.count[li]),
                    cuda.ptr(t.spheres[li]), cuda.ptr(atlas[li]), w, h, d,
                    t.h_glob, atlas.shape[-1], nc, cuda.ptr(out[li]),
                    stream):
                raise RuntimeError("the other K12 failed to launch")
        return out
    return run


def footprint(t, tile) -> str:
    """K12's atlas footprint of a tile: over the active (slice, cascade)
    pairs of sun 0, the mean texels a column and a row step (a_u; |a_v| +
    |b_v|) and the mean texels of a tile's footprint beside its froxels'
    4 taps a pair."""
    d = t.grid_whd[2]
    ranks = torch.arange(t.order.shape[2], device=t.order.device)
    active = ranks[None] < t.count[0][:, None]                  # [D, C]
    ci = t.order[0].long()
    coef = t.coef[0][torch.arange(d)[:, None], ci][active]      # [P, 8]
    au, av, bv = coef[:, 0].abs(), coef[:, 2].abs(), coef[:, 3].abs()
    tx, ty = tile
    texels = (tx * au + 2) * (tx * av + ty * bv + 2)
    return (f"{int(active.sum())} active (slice, cascade) pairs; texels a "
            f"column step {float(au.mean()):.2f}, a row step "
            f"{float((av + bv).mean()):.2f}; a {tx}x{ty} tile's footprint "
            f"{float(texels.mean()):.0f} texels for {4 * tx * ty} taps")


def renderer_and_inputs(chip_smoke, path, scene_name, scenes):
    """The path's renderer, scene, G-buffer, shadow maps and initial
    state."""
    from volumetricrenderer_tpu_torch import FULL_CONFIG, VolumetricRenderer
    kw = chip_smoke.DEMO_PATHS[path][1] if path in chip_smoke.DEMO_PATHS \
        else chip_smoke.PATHS[path][0]
    r = VolumetricRenderer(dataclasses.replace(FULL_CONFIG, **kw))
    scn = scenes[scene_name]
    colour, depth = r.render_scene_inputs(scn)
    return (r, scn, colour, depth, r.bake_shadow_data(scn),
            r.init_state(scn.dir_lights.count))


def record_rows(chip_smoke, modules, scenes) -> dict:
    """Render 2 frames of each row's path and keep the inputs of its
    kernel's last launch: {row: (tables, atlas)} for K12, {row: tables}
    for K9."""
    records, label = {}, {"row": ""}
    pipeline, ff, pcf, vis = modules
    real_pcf, real_vis = pcf.pcf_shadow, vis.bake_visibility

    def rec_k12(t, atlas):
        records[label["row"]] = (t, atlas)
        return real_pcf(t, atlas)

    def rec_k9(t):
        records[label["row"]] = t
        return real_vis(t)

    pipeline.pcf_shadow = rec_k12
    pipeline.bake_visibility = ff.bake_visibility = rec_k9
    try:
        for row, (path, scene_name, _) in ROWS.items():
            r, scn, colour, depth, maps, st = renderer_and_inputs(
                chip_smoke, path, scene_name, scenes)
            label["row"] = row
            for i in range(2):
                _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth,
                                          maps)
            del r, colour, depth, st, maps
    finally:
        pipeline.pcf_shadow = real_pcf
        pipeline.bake_visibility = ff.bake_visibility = real_vis
    torch.cuda.synchronize()
    missing = [row for row in ROWS if row not in records]
    if missing:
        raise RuntimeError(f"no launch recorded for {missing}")
    records["map_dir, 2 suns"] = chip_smoke.two_suns(*records["map_dir"])
    # K12's slab form: map_dir's tables on a band of rows, as a slab3
    # shard's with its halo (its first row y0 in the tables)
    r, scn, colour, depth, maps, st = renderer_and_inputs(
        chip_smoke, "map_dir", "bench", scenes)
    for i in range(2):
        _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth, maps)
    y0, rows = SLAB_ROWS
    records[f"map_dir, slab rows {y0}-{y0 + rows - 1}"] = (
        chip_smoke.band_pcf_tables(r.config, st, scn, maps[0], y0, rows),
        maps[0].atlas)
    return records


def frame_busy(chip_smoke, cuda, modules, scenes, others) -> dict:
    """Device busy a frame of BUSY_PATHS with this tree's K9 and K12 and
    with each other checkout's in their place."""
    pipeline, ff, pcf, vis = modules
    mine_vis = cuda.lib("bake_visibility")
    out = {}
    for path in BUSY_PATHS:
        r, scn, colour, depth, maps, st = renderer_and_inputs(
            chip_smoke, path, "bench", scenes)
        for i in range(3):
            _, _, st = r.render_frame(st, scn, 0.1 * i, colour, depth, maps)

        def frame():
            r.render_frame(st, scn, 0.5, colour, depth, maps)

        out[path] = {}
        for o_name, other in others.items():
            def with_libs(lib_vis, run_pcf):
                cuda._LIBS["bake_visibility"] = lib_vis
                pipeline.pcf_shadow = run_pcf
                try:
                    return busy_ms(frame)
                finally:
                    cuda._LIBS["bake_visibility"] = mine_vis
                    pipeline.pcf_shadow = pcf.pcf_shadow
            theirs = (other["bake_visibility"],
                      other_pcf(other["pcf_shadow"], cuda))
            t1 = with_libs(mine_vis, pcf.pcf_shadow)
            o1, o2 = with_libs(*theirs), with_libs(*theirs)
            t2 = with_libs(mine_vis, pcf.pcf_shadow)
            print(f"# {path} frame, device busy: this {t1:.4f} {t2:.4f} ms, "
                  f"{o_name} {o1:.4f} {o2:.4f} ms", flush=True)
            out[path][o_name] = {"this_ms": [t1, t2], "other_ms": [o1, o2]}
        del r, colour, depth, st, maps
    return out


def main() -> int:
    rows_only = "--rows-only" in sys.argv[1:]
    trees = [a for a in sys.argv[1:] if a != "--rows-only"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("k9_k12_against: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, benchmark_scene,
                                              demo_scene, pipeline)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import pcf_shadow as pcf
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    modules = (pipeline, ff, pcf, vis)

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
                              cuda.BUILD_DIR / f"k9k12_other{i}", cuda)
                  for i, arg in enumerate(trees)]
        others = {arg: b.result() for arg, b in zip(trees, builds)}
    aspect = FULL_CONFIG.image_width / FULL_CONFIG.image_height
    scenes = {"bench": benchmark_scene(aspect=aspect, num_local_lights=16,
                                       noise_mode="procedural"),
              "bench40": benchmark_scene(aspect=aspect, num_local_lights=40,
                                         noise_mode="procedural"),
              "demo": demo_scene(aspect=aspect)}
    records = record_rows(chip_smoke, modules, scenes)

    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    bad, rows = [], []
    for row, args in records.items():
        kernel = ROWS[row][2] if row in ROWS else "pcf_shadow"
        if kernel == "pcf_shadow":
            tables, atlas = args
            run_this = lambda: pcf.pcf_shadow(tables, atlas)
            got = run_this()
            want = pcf.pcf_shadow_plain(tables, atlas)
        else:
            tables = args
            run_this = lambda: vis.bake_visibility(tables)
            got = run_this()
            want = vis.bake_visibility_plain(tables)
        if kernel == "pcf_shadow":
            print(f"# {row} atlas: {footprint(tables, pcf.K12_TILE)}",
                  flush=True)
        atol, rtol, frac_ok, _ = chip_smoke.CHECKS[kernel]
        err = (got - want).abs()
        twin = float(err.max())
        flipped = float((err > atol + rtol * want.abs()).float().mean())
        shape = f"{tuple(got.shape)}"
        print(f"# {kernel} {row}, {shape}: max abs err vs twin {twin:.3e}, "
              f"share past the tolerance {flipped:.3e} (allowed {frac_ok})",
              flush=True)
        if not bool(torch.isfinite(got).all()) or flipped > frac_ok:
            bad.append(f"{kernel} {row} against its twin")
        out = {"kernel": kernel, "row": row, "shape": shape,
               "twin_err": twin, "twin_flipped": flipped}
        for o_name, other in others.items():
            ref = torch.empty_like(got)
            if kernel == "pcf_shadow":
                theirs = other_pcf(other[kernel], cuda)
                run_other = lambda: theirs(tables, atlas, ref)
            else:
                st = tables.c_struct()

                def run_other():
                    if other[kernel].vr_bake_visibility(
                            ctypes.byref(st), cuda.ptr(ref), stream()):
                        raise RuntimeError(f"{o_name}'s K9 failed to launch")
            run_other()
            same = torch.equal(got, ref)
            o1, n1 = spin_time_ms(run_other), spin_time_ms(run_this)
            n2, o2 = spin_time_ms(run_this), spin_time_ms(run_other)
            print(f"#   this {n1:.4f} {n2:.4f} ms, {o_name} {o1:.4f} "
                  f"{o2:.4f} ms ({(o1 + o2) / (n1 + n2):.2f}x); = {o_name} "
                  f"bit for bit: {same}", flush=True)
            if not same:
                diff = (got - ref).abs()
                at = tuple(int(v) for v in torch.unravel_index(
                    diff.nan_to_num(1e30).argmax(), diff.shape))
                print(f"#   differs on {int((diff > 0).sum())} of "
                      f"{diff.numel()} elements, max {float(diff.max()):.3e}"
                      f" at {at}", flush=True)
            out[o_name] = {"this_ms": [n1, n2], "other_ms": [o1, o2],
                           "same": same}
            bad += [] if same else [f"{kernel} {row} against {o_name}"]
        rows.append(out)
    del records
    busy = {} if rows_only else frame_busy(chip_smoke, cuda, modules, scenes,
                                           others)
    print(json.dumps({"device": smi, "rows": rows, "frame_busy": busy}),
          flush=True)
    if bad:
        print(f"# disagree: {bad}", flush=True)
        return 1
    print("# every K9 and K12 case agrees with the others", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
