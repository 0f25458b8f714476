"""Where the built kernels are kept, for CLI entry points.

Counterpart of `volumetricrenderer_tpu/utils/cache.py`, which points JAX's
persistent compilation cache at a directory. The port compiles no graph:
what it keeps between runs is the nvcc build of its CUDA kernels
(ops/cuda.py), one shared library per source, named by a hash of the
source and flags, so a stale one is never loaded. `enable_persistent_cache`
points that build directory (ops/cuda.BUILD_DIR) at a path.
"""

from __future__ import annotations

import os
from pathlib import Path

from volumetricrenderer_tpu_torch.ops import cuda

# the build directory ops/cuda.py starts with (listed in .gitignore)
DEFAULT_DIR = cuda.BUILD_DIR


def enable_persistent_cache(path: str | None = None) -> str:
    """Point the kernels' build directory at `path`, else at the
    VOLR_TORCH_CACHE environment variable, else at the package's _build/,
    and return it. Call it before the first kernel is loaded: once a
    library is loaded, moving the directory would leave kernels in two
    places, so a call naming another directory then raises RuntimeError; a
    call naming the current one, first or again, changes nothing."""
    cache_dir = Path(path or os.environ.get("VOLR_TORCH_CACHE", "")
                     or DEFAULT_DIR).resolve()
    if cache_dir != Path(cuda.BUILD_DIR).resolve() and cuda._LIBS:
        raise RuntimeError(
            f"kernels are already loaded from {cuda.BUILD_DIR}: call "
            "enable_persistent_cache before the first kernel is built or "
            "loaded")
    cuda.BUILD_DIR = cache_dir
    return str(cache_dir)
