"""The tolerance the port's end-to-end tests hold it to against JAX, and
the CPU the port's tests take under pytest-xdist.

Importing this module (every port test file that holds frames does) gives
torch os.cpu_count() // PYTEST_XDIST_WORKER_COUNT intra-op threads in an
xdist worker, at least one: by default each of the workers would run
torch on every core, and the suite's workers would thrash the CPU between
them (a 6-worker run of six port test files took 197 s so, 93 s with one
thread a worker on 8 cores). One process without xdist keeps torch's
default."""

import os

import numpy as np
import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 0:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def assert_boundary_close(got, want, msg):
    """rtol 1e-5 / atol 1e-6 per element, except for at most 5e-3 of the
    elements, which may also sit beyond 1e-3 relative: shadow rays that pass
    within ulps of a primitive edge may flip (the any-hit boundary class of
    tests/test_frame_fused.py)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    err = np.abs(got - want)
    past = (err > 1e-6 + 1e-5 * np.abs(want)).mean()
    far = (err / (1.0 + np.abs(want)) > 1e-3).mean()
    assert past <= 5e-3 and far <= 5e-3, (msg, past, far)
