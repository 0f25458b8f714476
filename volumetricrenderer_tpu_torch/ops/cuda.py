"""Build, load and launch the hand-written CUDA kernels under `csrc/`.

Each `csrc/*.cu` file is compiled by `nvcc` for sm_90a into a shared library
with a plain C interface and loaded with ctypes. The build happens at first
use, all sources in parallel, into `volumetricrenderer_tpu_torch/_build/`
(listed in .gitignore), named by a hash of the sources and flags so a stale
library is never loaded. No fast math: `__expf`/`__logf` would move every
froxel's z mapping. FMA contraction is off so that a kernel repeats its
plain-torch twin's rounding.

LAUNCHES counts, per kernel, the launches its wrapper made; a run resets it
with `reset_launches()` and reads it afterwards to prove which kernels ran.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("bake_radiance", "shadow_scatter", "integrate_blend", "composite",
           "shadow_blend", "scatter", "dir_shadow", "integrate",
           "bake_visibility", "temporal_blend", "windowed_warp",
           "pcf_shadow", "ssr_march", "composite_grad", "ssr_march_grad")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {name: 0 for name in SOURCES}
_LIBS: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class VrTables(ctypes.Structure):
    """Mirror of `struct VrTables` in csrc/common.cuh (same field order)."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "spar", "sbpar", "abpar", "slights", "dirs", "lights", "planes",
        "spheres", "boxes", "med", "med_static", "active", "tent_xk",
        "tent_xw", "tent_yk", "tent_yw", "order", "count", "hf")]
        + [(n, ctypes.c_int) for n in (
            "n_dir", "n_lights", "n_planes", "n_spheres", "n_boxes",
            "n_media", "n_noise", "jitter_dir", "w", "h", "d", "h_glob", "k",
            "ss", "wl", "hl", "dl", "hf_octaves", "hf_period", "hf_seed",
            "hf_steps", "hf_local", "fractional")]
        + [("hf_far", ctypes.c_float)])


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest(name: str) -> str:
    """Hash of the kernel's source, the shared headers and the flags that
    shape its code."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> dict:
    """Compile every kernel source that has no up-to-date library, all at
    once, and return {name: seconds} spent per build (0 for cached).
    verbose=True prints ptxas's register and spill report."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    procs, times = {}, {}
    for name in SOURCES:
        lib = BUILD_DIR / f"{name}-{_digest(name)}.so"
        if lib.exists():
            times[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    def finish(item):
        # each build's own time: its process waited for on a thread of its
        # own, not in turn behind the slower ones
        name, (proc, tmp, lib, t0) = item
        out, _ = proc.communicate()
        return name, proc.returncode, out, tmp, lib, time.perf_counter() - t0

    failed = []
    with ThreadPoolExecutor(max_workers=max(1, len(procs))) as pool:
        done = list(pool.map(finish, procs.items()))
    for name, rc, out, tmp, lib, secs in done:
        times[name] = secs
        if verbose and out:
            print(f"# nvcc {name}:\n{out}", flush=True)
        if rc != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it if needed."""
    if name not in _LIBS:
        path = BUILD_DIR / f"{name}-{_digest(name)}.so"
        if not path.exists():
            build()
        cdll = ctypes.CDLL(str(path))
        _declare(cdll, name)
        _LIBS[name] = cdll
    return _LIBS[name]


def _declare(cdll: ctypes.CDLL, name: str) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tp = ctypes.POINTER(VrTables)
    # source -> {entry point: argument types before the stream}
    sig = {
        "bake_radiance": {"vr_bake_radiance": [tp, vp],
                          "vr_bake_radiance_chunked": [tp, vp, ci],
                          "vr_bake_radiance_geometry": [ci] * 5 + [vp],
                          "vr_bake_radiance_plan": [ci, ci, vp],
                          "vr_bake_radiance_forms": [vp]},
        "shadow_scatter": {"vr_shadow_scatter_form":
                           [tp, vp, vp, vp, vp, ci, ci],
                           "vr_shadow_scatter_global":
                           [tp, vp, vp, vp, vp, ci, vp, ci],
                           "vr_shadow_scatter_region":
                           [tp, vp, vp, vp, vp, ci, vp, vp],
                           "vr_shadow_scatter_region_form_of": [ci, vp],
                           "vr_shadow_scatter_region_forms": [vp],
                           "vr_shadow_scatter_sun_form_of": [ci] * 3 + [vp],
                           "vr_shadow_scatter_form_of": [tp, ci, vp],
                           "vr_shadow_scatter_index_forms": [vp],
                           "vr_shadow_scatter_geometry": [ci, ci, vp],
                           "vr_shadow_scatter_general_shared": [ci, ci, vp],
                           "vr_shadow_scatter_forms": [vp]},
        "integrate_blend": {"vr_integrate_blend_form": [tp, vp, vp, vp, ci],
                            "vr_integrate_blend_region": [tp] + [vp] * 4,
                            "vr_integrate_blend_region_form_of": [ci, vp],
                            "vr_integrate_blend_region_forms": [vp],
                            "vr_integrate_blend_form_of": [tp, vp],
                            "vr_integrate_blend_index_forms": [vp]},
        "composite": {
            "vr_composite": [vp] * 6 + [ci] * 7 + [vp],
            "vr_composite_pixels": [vp] * 8 + [ci] * 5 + [vp]},
        "composite_grad": {
            "vr_composite_grad_chunks": [vp] * 7 + [ci] * 8 + [vp],
            "vr_composite_grad_geometry": [ci] * 2 + [vp],
            "vr_composite_grad_plan": [ci] * 2 + [vp],
            "vr_composite_grad_forms": [vp],
            "vr_composite_grad_occupancy": [ci] * 3 + [vp]},
        "shadow_blend": {"vr_shadow_blend_form": [tp, vp, vp, ci],
                         "vr_shadow_blend_global": [tp, vp, vp, vp, ci],
                         "vr_shadow_blend_region": [tp] + [vp] * 4,
                         "vr_shadow_blend_region_form_of": [ci, vp],
                         "vr_shadow_blend_region_forms": [vp],
                         "vr_shadow_blend_sun_form_of": [ci, ci, vp],
                         "vr_shadow_blend_form_of": [tp, vp],
                         "vr_shadow_blend_index_forms": [vp],
                         "vr_shadow_blend_geometry": [ci, vp],
                         "vr_shadow_blend_general_shared": [ci, ci, vp],
                         "vr_shadow_blend_forms": [vp]},
        "scatter": {"vr_scatter_form": [tp, vp, vp, vp, vp, vp, ci, ci],
                    "vr_scatter_form_of": [tp, ci, vp],
                    "vr_scatter_index_forms": [vp],
                    "vr_scatter_geometry": [ci, vp],
                    "vr_scatter_forms": [vp]},
        "dir_shadow": {"vr_dir_shadow_form": [tp, vp, ci],
                       "vr_dir_shadow_global": [tp, vp, vp, ci],
                       "vr_dir_shadow_sun_form_of": [ci, vp],
                       "vr_dir_shadow_form_of": [tp, vp],
                       "vr_dir_shadow_index_forms": [vp],
                       "vr_dir_shadow_geometry": [vp],
                       "vr_dir_shadow_general_shared": [ci, vp],
                       "vr_dir_shadow_forms": [vp]},
        "integrate": {"vr_integrate_form": [tp, vp, vp, ci],
                      "vr_integrate_form_of": [tp, vp],
                      "vr_integrate_index_forms": [vp],
                      "vr_integrate_geometry": [vp]},
        "bake_visibility": {"vr_bake_visibility_form": [tp, vp, ci],
                            "vr_bake_visibility_form_of": [tp, vp],
                            "vr_bake_visibility_index_forms": [vp],
                            "vr_bake_visibility_geometry": [ci] * 4 + [vp]},
        "temporal_blend": {"vr_temporal_blend_form": [vp] * 4 + [ci] * 8,
                           "vr_temporal_blend_region": [vp] * 5 + [ci] * 8,
                           "vr_temporal_blend_region_form_of": [ci, vp],
                           "vr_temporal_blend_region_forms": [vp],
                           "vr_temporal_blend_form_of": [ci] * 4 + [vp],
                           "vr_temporal_blend_index_forms": [vp],
                           "vr_temporal_blend_geometry": [ci, vp]},
        "windowed_warp": {"vr_windowed_warp_form": [vp] * 5 + [ci] * 6,
                          "vr_windowed_warp_form_of": [ci] * 4 + [vp],
                          "vr_windowed_warp_index_forms": [vp],
                          "vr_windowed_warp_geometry": [ci, vp]},
        "pcf_shadow": {"vr_pcf_shadow": [vp] * 6 + [ci] * 6 + [vp],
                       "vr_pcf_shadow_form":
                       [vp] * 6 + [ci] * 7 + [vp, ci],
                       "vr_pcf_shadow_form_of": [ci] * 6 + [vp],
                       "vr_pcf_shadow_index_forms": [vp],
                       "vr_pcf_shadow_geometry": [ci, vp]},
        "ssr_march": {"vr_ssr_march_form":
                      [vp] * 10 + [ci, ci, ci, ci, cf] + [vp] * 6 + [ci],
                      "vr_ssr_march_geometry": [ci, ci, vp],
                      "vr_ssr_march_form_of": [ci, ci, vp],
                      "vr_ssr_march_forms": [vp]},
        "ssr_march_grad": {"vr_ssr_march_grad_form": [vp] * 7 + [ci] * 8
                           + [vp, ci] + [vp] * 3,
                           "vr_ssr_march_grad_geometry": [ci] * 6 + [vp],
                           "vr_ssr_march_grad_form_of": [ci, ci, vp],
                           "vr_ssr_march_grad_forms": [vp]},
    }[name]
    for entry, argtypes in sig.items():
        fn = getattr(cdll, entry)
        # every launching entry point takes the stream last
        fn.argtypes = argtypes + ([] if entry.endswith(
            ("_geometry", "_occupancy", "_shared", "_forms", "_form_of",
             "_plan")) else [vp])
        fn.restype = ctypes.c_int


def launch(name: str, *args, entry: str = "") -> None:
    """Launch kernel `name` (its entry point `vr_<name>`, or `entry` of the
    same source) on the current stream and count it under `name`; raises if
    the launch was refused."""
    fn = getattr(lib(name), entry or "vr_" + name)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
    LAUNCHES[name] += 1


# The sources whose launchers take a fixed or a general form by the frame's
# counts of suns and fBm channels (csrc/common.cuh needs_general; the
# general instantiations are the kernels named with GEN below): each
# library counts its launches of each form (form_launches), in FORM_NAMES'
# order. Past a block's shared memory K2, K5 and K7 keep the suns' inverse
# directions in device memory (gen_global: ops/scatter.sun_form) and K1
# takes its fBm channels in chunks (chunked: ops/frame_fused.k1_geometry).
FORM_SOURCES = ("bake_radiance", "shadow_scatter", "shadow_blend", "scatter",
                "dir_shadow")
SUN_FORMS = ("fixed", "general", "gen_global")
FORM_NAMES = {"bake_radiance": ("fixed", "general", "chunked"),
              "shadow_scatter": SUN_FORMS, "shadow_blend": SUN_FORMS,
              "scatter": ("fixed", "general"), "dir_shadow": SUN_FORMS}


# The sources whose launchers pick a form by the size of their tables
# (K13's instance and table placement, K15's placement and code width,
# K14's slices in one launch or in chunks; ops/ssr.k13_form, k15_form,
# ops/zg_composite.k14_chunks mirror the choice): the names of the forms
# their libraries count, in their `vr_<name>_forms` order.
_K13_FORMS = ("fixed", "gen", "gen_global")
SIZE_FORMS = {
    "ssr_march": _K13_FORMS + tuple(f"record_{f}" for f in _K13_FORMS),
    "ssr_march_grad": ("fixed", "optin", "global", "global_wide"),
    "composite_grad": ("one", "chunked"),
}


# The sources whose launchers take a narrow form (32-bit indices, a slice,
# row or (sun, slice) pair on each launch-grid index) wherever it fits and a
# wide one past it (64-bit indices, the slices, rows or pairs launched in
# parts of at most MAX_GRID_Z; csrc/common.cuh VR_FORM_*): K2, K3, K5, K6,
# K7, K8, K9, K10, K11 and K12. The wrappers mirror the choice
# (ops/frame_fused.k2_form, k3_form, ops/shadow_blend.k5_form,
# ops/scatter.k6_form, ops/dir_shadow.k7_form, ops/integrate.k8_form,
# ops/visibility.k9_form, ops/temporal.k10_form, ops/warp.k11_form,
# ops/pcf_shadow.k12_form; K10 and K11 for each launch of a channel group)
# and take `form=` to force one; each library counts its launches of either
# (`vr_<name>_index_forms`).
INDEX_FORMS = ("narrow", "wide")
INDEX_SOURCES = ("bake_visibility", "shadow_scatter", "integrate_blend",
                 "shadow_blend", "scatter", "dir_shadow", "integrate",
                 "temporal_blend", "windowed_warp", "pcf_shadow")
MAX_GRID_Z = 65535


def grid_parts(n: int) -> list:
    """Mirror of the wide forms' launches: the (first, count) parts of n
    slices (rows) on a launch-grid axis, in order, at most MAX_GRID_Z
    each (csrc/common.cuh grid_part_count)."""
    return [(a, min(MAX_GRID_Z, n - a)) for a in range(0, n, MAX_GRID_Z)]


INT32_MAX = 2 ** 31 - 1


def index_form(kernel: str, narrow_why: Optional[str],
               wide_why: Optional[str], form: Optional[str] = None) -> str:
    """The form of INDEX_FORMS that `kernel`'s launcher takes: the narrow
    one where it takes the table (narrow_why None; else what it cannot
    index), else the wide one (wide_why None; else why not). form: a form to
    force instead. Raises ValueError, naming the kernel, where the form
    cannot take the table: before any launch."""
    why = {"narrow": narrow_why, "wide": wide_why}
    if form is None:
        form = "narrow" if narrow_why is None else "wide"
    if form not in why:
        raise ValueError(f"{kernel}: form {form!r} is none of {INDEX_FORMS}")
    if why[form] is not None:
        raise ValueError(f"{kernel}'s {form} form cannot take the table: "
                         f"{why[form]}")
    return form


def past_int32(what: str, *factors: int) -> Optional[str]:
    """Why an array of the product of `factors` floats (or a launch grid of
    that many blocks) passes a 32-bit index, or None where it does not."""
    n = 1
    for f in factors:
        n *= f
    return f"{what}: {n} past 2^31 - 1" if n > INT32_MAX else None


def split_form(kernel: str, form, *groups: tuple) -> tuple:
    """`form` of a wrapper that takes an index form of INDEX_FORMS and a
    form of each of `groups` (SUN_FORMS, K1's "chunked", REGION_FORMS):
    None, one name, or a tuple of at most one of each group. Returns (index
    form or None, then each group's form or None); raises ValueError,
    naming the kernel, for any other name."""
    names = () if form is None else (form,) if isinstance(form, str) \
        else tuple(form)
    picked = [[f for f in names if f in g] for g in (INDEX_FORMS, *groups)]
    if any(len(p) > 1 for p in picked) \
            or sum(len(p) for p in picked) != len(names):
        raise ValueError(f"{kernel}: form {form!r} is not one of "
                         + " and one of ".join(
                             str(g) for g in (INDEX_FORMS, *groups)))
    return tuple((p or [None])[0] for p in picked)


def form_launches(name: str) -> tuple:
    """The launches of each of source `name`'s forms since its library was
    loaded (its `vr_<name>_forms`): in FORM_NAMES' order for FORM_SOURCES,
    in SIZE_FORMS' order for those."""
    n = len(SIZE_FORMS.get(name) or FORM_NAMES[name])
    buf = (ctypes.c_int * n)()
    getattr(lib(name), f"vr_{name}_forms")(ctypes.cast(buf, ctypes.c_void_p))
    return tuple(buf)


def index_form_launches(name: str) -> tuple:
    """The (narrow, wide) launches of an INDEX_SOURCES source since its
    library was loaded (its `vr_<name>_index_forms`)."""
    buf = (ctypes.c_int * len(INDEX_FORMS))()
    getattr(lib(name), f"vr_{name}_index_forms")(
        ctypes.cast(buf, ctypes.c_void_p))
    return tuple(buf)


# The sources whose launchers keep their reprojection offsets in shared
# memory up to a window and in device memory past it (K2, K5, K10 from
# k = 52, K3 from k = 159; csrc/common.cuh VR_REGION_*): the wrappers
# mirror the choice (ops/temporal.region_form, ops/frame_fused.
# k3_window_form) and take a name of REGION_FORMS in `form=` to force one.
# Each library counts its launches of either and of the region_global
# form's pre-pass (`vr_<name>_region_forms`, REGION_COUNTS' order).
REGION_FORMS = ("region_shared", "region_global")
REGION_COUNTS = REGION_FORMS + ("region_pass",)
REGION_SOURCES = ("shadow_scatter", "shadow_blend", "temporal_blend",
                  "integrate_blend")


def region_launches(name: str) -> tuple:
    """The launches of a REGION_SOURCES source's region forms and of the
    region_global form's pre-pass since its library was loaded."""
    buf = (ctypes.c_int * len(REGION_COUNTS))()
    getattr(lib(name), f"vr_{name}_region_forms")(
        ctypes.cast(buf, ctypes.c_void_p))
    return tuple(buf)


def form_counts(name: str) -> dict:
    """form_launches of a SIZE_FORMS source by its forms' names, or
    index_form_launches of an INDEX_SOURCES source by INDEX_FORMS, of a
    FORM_SOURCES source by FORM_NAMES and of a REGION_SOURCES source by
    REGION_COUNTS (all that apply to the source)."""
    if name in SIZE_FORMS:
        return dict(zip(SIZE_FORMS[name], form_launches(name)))
    out = dict(zip(FORM_NAMES[name], form_launches(name))) \
        if name in FORM_NAMES else {}
    if name in INDEX_SOURCES:
        out.update(zip(INDEX_FORMS, index_form_launches(name)))
    if name in REGION_SOURCES:
        out.update(zip(REGION_COUNTS, region_launches(name)))
    return out


# source -> the kernels its `vr_<source>_attrs` entry reports, in its order
_K6_MODES = tuple(f"{local}, {planes}, false" for local in
                  ("RADIANCE", "RAY", "BAKED") for planes in ("false", "true")
                  ) + ("RAY, false, true", "RAY, true, true")
ATTR_KERNELS = {"bake_radiance": tuple(
                    f"bake_radiance_kernel<{arms}, {spread}>"
                    for spread in ("true", "false")
                    for arms in ("false", "true"))
                + ("bake_radiance_kernel<false, true, GEN>",
                   "bake_radiance_kernel<true, true, GEN>",
                   "bake_radiance_kernel<false, true, GEN, CHUNKED>",
                   "bake_radiance_kernel<true, true, GEN, CHUNKED>"),
                "shadow_blend": tuple(
                    f"shadow_blend_kernel<{arms}{gen}{wide}>"
                    for wide in ("", ", WIDE") for gen in ("", ", GEN")
                    for arms in ("false", "true")) + tuple(
                    f"shadow_blend_kernel<{arms}, GEN{wide}, GLOBAL>"
                    for wide in ("", ", WIDE")
                    for arms in ("false", "true")) + tuple(
                    f"shadow_blend_kernel<{arms}, GEN, WIDE, GLOBAL, REGION>"
                    for arms in ("false", "true")),
                "shadow_scatter": tuple(
                    f"shadow_scatter_kernel<{local}, {arms}{gen}{wide}>"
                    for wide in ("", ", WIDE")
                    for gen in ("", ", GEN")
                    for local in ("RADIANCE", "RAY", "BAKED")
                    for arms in ("false", "true")) + tuple(
                    f"shadow_scatter_kernel<{local}, {arms}, GEN{wide}, "
                    "GLOBAL>"
                    for wide in ("", ", WIDE")
                    for local in ("RADIANCE", "RAY", "BAKED")
                    for arms in ("false", "true")) + tuple(
                    f"shadow_scatter_kernel<{local}, {arms}, GEN, WIDE, "
                    "GLOBAL, REGION>"
                    for local in ("RADIANCE", "RAY", "BAKED")
                    for arms in ("false", "true")),
                "scatter": tuple(f"scatter_kernel<{mode}{gen}{wide}>"
                                 for wide in ("", ", WIDE")
                                 for gen in ("", ", GEN")
                                 for mode in _K6_MODES),
                "integrate_blend": ("integrate_blend_kernel",
                                    "integrate_blend_kernel<WIDE>",
                                    "integrate_blend_kernel<WIDE, REGION>"),
                "dir_shadow": tuple(
                    f"dir_shadow_kernel<{arms}{gen}{wide}>"
                    for wide in ("", ", WIDE") for gen in ("", ", GEN")
                    for arms in ("false", "true")) + tuple(
                    f"dir_shadow_kernel<{arms}, GEN{wide}, GLOBAL>"
                    for wide in ("", ", WIDE")
                    for arms in ("false", "true")),
                "integrate": ("integrate_kernel", "integrate_kernel<WIDE>"),
                "temporal_blend": ("temporal_blend_kernel<1, true>",
                                   "temporal_blend_kernel<4, false>",
                                   "temporal_blend_kernel<1, true, WIDE>",
                                   "temporal_blend_kernel<4, false, WIDE>",
                                   "temporal_blend_kernel<1, true, WIDE, "
                                   "REGION>",
                                   "temporal_blend_kernel<4, false, WIDE, "
                                   "REGION>"),
                "windowed_warp": ("windowed_warp_kernel<4>",
                                  "windowed_warp_kernel<4, WIDE>"),
                "bake_visibility": ("bake_visibility_kernel<false>",
                                    "bake_visibility_kernel<true>",
                                    "bake_visibility_kernel<false, WIDE>",
                                    "bake_visibility_kernel<true, WIDE>"),
                "pcf_shadow": ("pcf_shadow_kernel",
                               "pcf_shadow_kernel<WIDE>"),
                "ssr_march": ("ssr_march_kernel<16, false>",
                              "ssr_march_kernel<32, false>",
                              "ssr_march_kernel<16, true>",
                              "ssr_march_kernel<32, true>",
                              "ssr_march_kernel<GEN, false>",
                              "ssr_march_kernel<GEN, true>",
                              "ssr_march_kernel<GEN, false, GLOBAL>",
                              "ssr_march_kernel<GEN, true, GLOBAL>"),
                "ssr_march_grad": ("ssr_march_grad_kernel",
                                   "ssr_grad_codes_kernel",
                                   "ssr_march_grad_kernel<GLOBAL>",
                                   "ssr_march_grad_kernel<GLOBAL, int32>",
                                   "ssr_grad_codes_kernel<int32>"),
                "composite": ("composite_kernel<8, 8>",
                              "composite_kernel<0, 0>",
                              "composite_pixels_kernel"),
                "composite_grad": ("composite_grad_kernel<true>",
                                   "composite_grad_kernel<false>",
                                   "composite_grad_kernel<true, CHUNKED>",
                                   "composite_grad_kernel<false, CHUNKED>")}


def kernel_attrs(name: str) -> dict:
    """cudaFuncGetAttributes of source `name`'s kernels (ATTR_KERNELS):
    {kernel: {"registers": per thread, "shared_bytes": static per block,
    "local_bytes": per thread, "max_threads": per block}}."""
    kernels = ATTR_KERNELS[name]
    buf = (ctypes.c_int * (4 * len(kernels)))()
    fn = getattr(lib(name), f"vr_{name}_attrs")
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    err = fn(ctypes.cast(buf, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed for {name}: "
                           f"error {err}")
    keys = ("registers", "shared_bytes", "local_bytes", "max_threads")
    return {k: dict(zip(keys, buf[4 * i:4 * i + 4]))
            for i, k in enumerate(kernels)}


def check_cuda(*tensors: torch.Tensor, dtype=torch.float32) -> None:
    """Every tensor a contiguous CUDA tensor of `dtype` on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{t.device}")
        if t.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    """The tensor's device address for a kernel's argument. A kernel writes
    through it, out of autograd's sight, so a tensor that requires grad
    raises while grad is on: its gradient would be dropped without an
    error. CompositeFn (K4 forward, K14 backward) passes detached tensors."""
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "a kernel's input requires grad: the kernel has no backward, so "
            "its gradient would be lost (render_frame refuses such routes "
            "by name; this one reached a launch)")
    return ctypes.c_void_p(t.data_ptr())


def upload(values, device, dtype=torch.float32) -> torch.Tensor:
    """A host constant on `device`. On CUDA it is staged in pinned memory
    and copied asynchronously: a copy from pageable memory would block the
    host until every kernel queued before it has run."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def move_tables(tables, device):
    """A dataclass of float32 and int32 tables (tensors, or tuples of
    tensors) moved to `device`: packed into one buffer per dtype, copied
    once (pinned and asynchronous from the CPU to CUDA), and split back into
    views. Other fields are kept as they are."""
    device = torch.device(device)
    names, tensors = [], []
    for f in dataclasses.fields(tables):
        v = getattr(tables, f.name)
        if isinstance(v, torch.Tensor):
            names.append((f.name, None))
            tensors.append(v)
        elif isinstance(v, tuple) and v and isinstance(v[0], torch.Tensor):
            for i, t in enumerate(v):
                names.append((f.name, i))
                tensors.append(t)
    if any(t.dtype not in (torch.float32, torch.int32) for t in tensors):
        raise TypeError("the tables hold float32 and int32 tensors")
    moved = {}
    for dtype in (torch.float32, torch.int32):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        if not idx:
            continue
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if flat.device.type == "cpu" and device.type == "cuda":
            flat = flat.pin_memory().to(device, non_blocking=True)
        else:
            flat = flat.to(device)
        for i, part in zip(idx, flat.split(
                [tensors[i].numel() for i in idx])):
            moved[i] = part.view(tensors[i].shape)
    fields = {}
    for i, (name, sub) in enumerate(names):
        if sub is None:
            fields[name] = moved[i]
        else:
            fields.setdefault(name, []).append(moved[i])
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in fields.items()}
    return dataclasses.replace(tables, **fields)
