"""The tolerance the port's end-to-end tests hold it to against JAX."""

import numpy as np


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
