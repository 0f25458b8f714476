"""Temporal jitter sequence.

7 offsets from a close-packing-of-equal-spheres pattern rotated 15 degrees,
xy in (-0.5, 0.5)^2 and z stratified at (2k+1)/14, selected per frame by
frame_count % 7 and added to the continuous froxel position.
"""

from __future__ import annotations

import math

import numpy as np


def jitter_sequence() -> np.ndarray:
    """[7, 3] float32 jitter offsets (x, y, z)."""
    r = 0.17054068870105443882
    d = 2.0 * r
    s = r * math.sqrt(3.0)
    seq = np.array(
        [
            [0.0, 0.0, 3.0 / 14.0],
            [-d, 0.0, 11.0 / 14.0],
            [d, 0.0, 1.0 / 14.0],
            [-r, -s, 9.0 / 14.0],
            [r, s, 7.0 / 14.0],
            [r, -s, 13.0 / 14.0],
            [-r, s, 5.0 / 14.0],
        ],
        dtype=np.float64,
    )
    cos15 = 0.96592582628906828675
    sin15 = 0.25881904510252076235
    x = seq[:, 0] * cos15 - seq[:, 1] * sin15
    y = seq[:, 0] * sin15 + seq[:, 1] * cos15
    seq[:, 0] = x
    seq[:, 1] = y
    return seq.astype(np.float32)


JITTER_SEQUENCE = jitter_sequence()


def jitter_for_frame(frame_count: int) -> np.ndarray:
    """[3] float32 offset for a frame counter."""
    return JITTER_SEQUENCE[int(frame_count) % 7]
