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
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("bake_radiance", "shadow_scatter", "integrate_blend", "composite",
           "shadow_blend", "scatter", "dir_shadow", "integrate",
           "bake_visibility", "temporal_blend", "windowed_warp",
           "pcf_shadow", "ssr_march", "composite_grad")
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
    failed = []
    for name, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if verbose and out:
            print(f"# nvcc {name}:\n{out}", flush=True)
        if proc.returncode != 0:
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
                          "vr_bake_radiance_geometry": [ci] * 5 + [vp]},
        "shadow_scatter": {"vr_shadow_scatter": [tp, vp, vp, vp, vp, ci],
                           "vr_shadow_scatter_geometry": [ci, ci, vp]},
        "integrate_blend": {"vr_integrate_blend": [tp, vp, vp, vp]},
        "composite": {
            "vr_composite": [vp] * 6 + [ci] * 7 + [vp],
            "vr_composite_pixels": [vp] * 8 + [ci] * 5 + [vp]},
        "composite_grad": {
            "vr_composite_grad": [vp] * 6 + [ci] * 5 + [vp],
            "vr_composite_grad_pixels": [vp] * 8 + [ci] * 5 + [vp]},
        "shadow_blend": {"vr_shadow_blend": [tp, vp, vp],
                         "vr_shadow_blend_geometry": [ci, vp]},
        "scatter": {"vr_scatter": [tp, vp, vp, vp, vp, vp, ci],
                    "vr_scatter_geometry": [ci, vp]},
        "dir_shadow": {"vr_dir_shadow": [tp, vp],
                       "vr_dir_shadow_geometry": [vp]},
        "integrate": {"vr_integrate": [tp, vp, vp],
                      "vr_integrate_geometry": [vp]},
        "bake_visibility": {"vr_bake_visibility": [tp, vp],
                            "vr_bake_visibility_geometry": [ci] * 4 + [vp]},
        "temporal_blend": {"vr_temporal_blend":
                           [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci],
                           "vr_temporal_blend_geometry": [ci, vp]},
        "windowed_warp": {"vr_windowed_warp":
                          [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci],
                          "vr_windowed_warp_geometry": [ci, vp]},
        "pcf_shadow": {"vr_pcf_shadow": [vp] * 6 + [ci] * 6 + [vp],
                       "vr_pcf_shadow_suns": [vp] * 6 + [ci] * 7 + [vp],
                       "vr_pcf_shadow_geometry": [ci, vp]},
        "ssr_march": {"vr_ssr_march":
                      [vp] * 10 + [ci, ci, ci, ci, cf] + [vp] * 5,
                      "vr_ssr_march_geometry": [ci, ci, vp]},
    }[name]
    for entry, argtypes in sig.items():
        fn = getattr(cdll, entry)
        # every launching entry point takes the stream last
        fn.argtypes = argtypes + ([] if entry.endswith("_geometry")
                                  else [vp])
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


# source -> the kernels its `vr_<source>_attrs` entry reports, in its order
ATTR_KERNELS = {"bake_radiance": tuple(
                    f"bake_radiance_kernel<{arms}, {spread}>"
                    for spread in ("true", "false")
                    for arms in ("false", "true")),
                "shadow_blend": ("shadow_blend_kernel<false>",
                                 "shadow_blend_kernel<true>"),
                "shadow_scatter": tuple(
                    f"shadow_scatter_kernel<{local}, {arms}>"
                    for local in ("RADIANCE", "RAY", "BAKED")
                    for arms in ("false", "true")),
                "scatter": tuple(
                    f"scatter_kernel<{local}, {planes}, false>"
                    for local in ("RADIANCE", "RAY", "BAKED")
                    for planes in ("false", "true"))
                + ("scatter_kernel<RAY, false, true>",
                   "scatter_kernel<RAY, true, true>"),
                "integrate_blend": ("integrate_blend_kernel",),
                "dir_shadow": ("dir_shadow_kernel<false>",
                               "dir_shadow_kernel<true>"),
                "integrate": ("integrate_kernel",),
                "temporal_blend": ("temporal_blend_kernel<1, true>",
                                   "temporal_blend_kernel<4, false>"),
                "windowed_warp": ("windowed_warp_kernel<4>",),
                "bake_visibility": ("bake_visibility_kernel<false>",
                                    "bake_visibility_kernel<true>"),
                "pcf_shadow": ("pcf_shadow_kernel",),
                "ssr_march": ("ssr_march_kernel<16>",
                              "ssr_march_kernel<32>"),
                "composite": ("composite_kernel<8, 8>",
                              "composite_kernel<0, 0>",
                              "composite_pixels_kernel"),
                "composite_grad": ("composite_grad_kernel<8, 8>",
                                   "composite_grad_kernel<0, 0>",
                                   "composite_grad_pixels_kernel")}


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
