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


def _expand(first, wts):
    """The [9, py*px] table that K4's 2x2 entries stand for."""
    cp = first.shape[0]
    out = np.zeros((3, 3, cp), np.float32)
    for a in range(2):
        for b in range(2):
            out[first[:, 0] + a, first[:, 1] + b, np.arange(cp)] = \
                wts[:, 2 * a + b]
    return out.reshape(9, cp)


@pytest.mark.parametrize("py,px,us", [(8, 8, 1), (16, 16, 1), (8, 16, 1),
                                      (8, 8, 2)])
def test_cell_taps_expand_to_the_cell_weights(py, px, us):
    """K4's 2x2 table (first tap and four weights per in-cell position)
    holds every non-zero weight of the 3x3 table, bit for bit: the cells of
    the 1080p and 4K frames and the co-sited us=2 weights."""
    w9 = t_zg.cell_weights(py, px, us)
    first, wts = t_zg.cell_taps(w9)
    assert first.dtype == np.int32 and wts.dtype == np.float32
    assert first.shape == (py * px, 2) and wts.shape == (py * px, 4)
    assert ((first >= 0) & (first <= 1)).all()
    np.testing.assert_array_equal(_expand(first, wts).view(np.uint32),
                                  w9.view(np.uint32))


@pytest.mark.parametrize("taps", [(0, 2), (0, 6), (1, 7)])
def test_cell_taps_reject_three_taps_on_an_axis(taps):
    """A position whose non-zero weights span all three neighbours of an
    axis (row dx 0 and 2, or column dy 0 and 2) has no 2x2 window."""
    w9 = t_zg.cell_weights(8, 8).copy()
    w9[list(taps), 5] = 0.25
    with pytest.raises(ValueError):
        t_zg.cell_taps(w9)


def test_depth_params_view_the_packed_params():
    """The (z, w, near) the composite kernels read: a view of the packed
    params of froxel.params_to (no launch on the card), equal to the stack
    of the three; the unpacked params of make_froxel_params are stacked."""
    kw = dict(position=(0.0, 1.0, 0.0), forward=(0.0, 0.0, 1.0),
              aspect=1.5, near=0.3)
    tc = TCamera.create(**kw, device="cpu")
    p = tfroxel.make_froxel_params(tc.fov_y, tc.aspect, tc.near, 40.0, 2.0,
                                   GRID)
    want = torch.stack([p.z, p.w, p.near])
    packed = tfroxel.params_to(p, "cpu")
    got = tfroxel.depth_params(packed)
    assert got.data_ptr() == packed.z.data_ptr()
    assert torch.equal(got, want)
    assert torch.equal(tfroxel.depth_params(p), want)
