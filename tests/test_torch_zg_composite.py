"""The port's composite (the plain-torch twin of kernel K4) against the JAX
zgather composite `composite_zgather` in interpret mode: random
accumulation planes, random scene colour, and view depths that include
values before the near plane and past the volume's far end (both clamp).

Tolerance: rtol 1e-6 / atol 1e-6 -- the same float32 trilinear; only the
log() in the froxel z mapping can differ by an ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.ops.pallas.zg_composite import composite_zgather

from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.models.camera import Camera as TCamera
from volumetricrenderer_tpu_torch.ops import zg_composite as t_zg

GRID = (16, 15, 8)
IMAGE = (120, 128)      # (IH, IW): 8x8 pixel cells


@pytest.fixture(scope="module")
def inputs():
    w, h, d = GRID
    ih, iw = IMAGE
    kw = dict(position=(0.0, 1.0, 0.0), forward=(0.0, 0.0, 1.0),
              aspect=iw / ih, near=0.3)
    jc, tc = JCamera.create(**kw), TCamera.create(**kw, device="cpu")
    jp = jfroxel.make_froxel_params(jc.fov_y, jc.aspect, jc.near, 40.0, 2.0,
                                    GRID)
    tp = tfroxel.make_froxel_params(tc.fov_y, tc.aspect, tc.near, 40.0, 2.0,
                                    GRID)
    rng = np.random.default_rng(11)
    acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    scene = rng.uniform(0, 1, (ih, iw, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 45.0, (ih, iw)).astype(np.float32)
    depth[::7, ::5] = 0.01          # before the near plane (log clamp)
    depth[3::11, 2::9] = 500.0      # past the volume's far end
    return jp, tp, acc, scene, depth


def test_composite_matches_zgather(inputs):
    jp, tp, acc, scene, depth = inputs
    fz = jfroxel.depth_to_froxel_z(jp, jnp.asarray(depth)) - 0.5
    want = composite_zgather(tuple(jnp.asarray(p) for p in acc),
                             jnp.asarray(scene), fz, GRID, interpret=True)
    got = t_zg.composite(torch.as_tensor(acc), torch.as_tensor(scene),
                         torch.as_tensor(depth), tp, GRID)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cell_weights_are_a_partition_of_unity():
    """Each pixel's 3x3 cell weights sum to 1 and at most 4 are non-zero."""
    for py, px in ((8, 8), (16, 16), (8, 16)):
        w9 = t_zg.cell_weights(py, px)
        np.testing.assert_allclose(w9.sum(axis=0), 1.0, rtol=0, atol=1e-6)
        assert ((w9 > 0).sum(axis=0) <= 4).all()


def test_composite_rejects_bad_shapes(inputs):
    _, tp, acc, scene, depth = inputs
    with pytest.raises(ValueError):
        t_zg.composite(torch.as_tensor(acc[:3]), torch.as_tensor(scene),
                       torch.as_tensor(depth), tp, GRID)
