"""The port's multi-rank rendering on torch.distributed, on the CPU:
parallel/shard_render.make_shardmap_render and parallel/sharding.py.

One gloo world of 2 ranks per module, spawned by torch.multiprocessing (a
FileStore in a temporary directory; the join waits at most 120 s). Each
rank runs tests/torch_shardmap_worker.py, which imports no JAX, and saves
its results; the module fixture computes the references in this process
while the ranks run, then reads the ranks' files.

  * make_shardmap_render, three frames of a moving camera on the fused
    frame from the plain layout (frame 0 through _halo_rows, then
    _refresh_halo): each rank's image band and cropped state against
    make_multislab_render(n=2)'s shard, bit for bit (the JAX package's
    contract, tests/test_shard_render.py); and a frame from fn.init_state
    (the steady layout) against the plain layout's frame 0, bit for bit;
  * make_sharded_render over two frames (tests/test_parallel.py's CFG:
    map mode, the XLA scatter) against the unsharded frames, image and
    state: rtol 1e-4 / atol 1e-5 (tests/test_parallel.py:44-47);
  * accumulate_zsharded against the port's accumulate_scan and against
    JAX's (XLA, eager) on the same seeded volume: rtol 2e-5 / atol 2e-6
    (tests/test_parallel.py:128);
  * light_sharded_scatter against the one-process XLA scatter
    (pipeline.write_scatter_xla) with every light: rtol 2e-5 / atol 2e-6
    (tests/test_parallel.py:185);
  * checkpoint's DCP pair (save_state_orbax / load_state_orbax): each rank
    restores its own rows of a seeded state bit for bit, and this process,
    without a group, loads the ranks' checkpoint into the whole state bit
    for bit (every rank's rows were kept, not rank 0's alone)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from volumetricrenderer_tpu.ops.scatter_scan import \
    accumulate_scan as j_accumulate_scan

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import pipeline
from volumetricrenderer_tpu_torch.checkpoint import load_state_orbax
from volumetricrenderer_tpu_torch.ops.scatter_scan import accumulate_scan
from volumetricrenderer_tpu_torch.parallel.shard_render import (
    crop_sharded_state, make_multislab_render)

import torch_shardmap_worker as worker

N = worker.WORLD


def _references():
    """What the ranks' results are held against, from one process."""
    r = vt.VolumetricRenderer(worker.SHARDMAP, device="cpu")
    fn = make_multislab_render(r, N)
    carry = fn.init_carry(1)
    slabs = []
    for i, s in enumerate(worker.scenes(worker.SHARDMAP, 3)):
        sc, vd = r.render_scene_inputs(s)
        bands, carry = fn(carry, s, 0.1 * i, list(sc.chunk(N)),
                          list(vd.chunk(N)))
        slabs.append((bands, [worker.histories(crop_sharded_state(
            st, 1, fn.halo)) for st in carry[0]]))
    r = vt.VolumetricRenderer(worker.SHARDED, device="cpu")
    state, whole = r.init_state(1), []
    for i, s in enumerate(worker.scenes(worker.SHARDED, 2)):
        img, _, state = r.render_frame(state, s, 0.1 * i)
        whole.append((img, worker.histories(state)))
    scat, ext, steps = worker.scan_inputs()
    j_scan = j_accumulate_scan(jnp.asarray(scat.permute(1, 2, 3, 0).numpy()),
                               jnp.asarray(ext.numpy()),
                               jnp.asarray(steps.numpy()))
    return dict(slabs=slabs, halo=fn.halo, whole=whole,
                scan=accumulate_scan(scat, ext, steps),
                j_scan=torch.as_tensor(np.asarray(j_scan)).permute(3, 0, 1,
                                                                   2),
                lights=pipeline.write_scatter_xla(*worker.light_inputs()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shardmap")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=worker.rank_main,
                         args=(rank, str(tmp / "store"), str(tmp)))
             for rank in range(N)]
    for p in procs:
        p.start()
    try:
        refs = _references()
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * N
    ranks = [torch.load(tmp / f"rank{k}.pt", weights_only=True)
             for k in range(N)]
    refs["dcp"] = str(tmp / "dcp")
    return refs, ranks


def _equal(got: dict, want: dict, what: str):
    assert got.keys() == want.keys(), what
    for f, t in want.items():
        assert torch.equal(got[f], t), f"{what}: {f}"


@pytest.mark.parametrize("rank", range(N))
@pytest.mark.parametrize("frame", range(3))
def test_shardmap_matches_multislab(world, frame, rank):
    """Bit for bit: the band and the cropped state of rank `rank` after
    frame `frame` are make_multislab_render's shard `rank`'s."""
    refs, ranks = world
    assert ranks[rank]["backend"] == "gloo"
    assert ranks[rank]["shardmap"]["halo"] == refs["halo"] == 6
    bands, states = refs["slabs"][frame]
    got = ranks[rank]["shardmap"]
    assert got["bands"][frame].shape == (16, 48, 4)
    assert torch.equal(got["bands"][frame], bands[rank])
    _equal(got["states"][frame], states[rank], f"frame {frame}")


@pytest.mark.parametrize("rank", range(N))
def test_steady_init_matches_plain_init(world, rank):
    """fn.init_state (the halo-extended layout, refreshed by _refresh_halo)
    renders frame 0 bit for bit as the plain layout does (_halo_rows)."""
    _, ranks = world
    got = ranks[rank]["shardmap"]
    img, state = got["steady"]
    assert torch.equal(img, got["bands"][0])
    _equal(state, got["states"][0], "frame 0")


@pytest.mark.parametrize("frame", range(2))
def test_sharded_render_matches_unsharded(world, frame):
    """make_sharded_render's bands and rows put together against the
    unsharded frame, image and state: rtol 1e-4 / atol 1e-5
    (tests/test_parallel.py). From frame 1 the jitter moves y, and the
    slab path's own bands differ from the whole grid on the two image rows
    whose composite reads a froxel row past the grid (rows 0 and 31 here:
    the slab's computed halo rows there); make_sharded_render composites
    those from the edge row, as the whole grid does."""
    refs, ranks = world
    img, state = refs["whole"][frame]
    got = [rk["sharded"][frame] for rk in ranks]
    torch.testing.assert_close(torch.cat([g[0] for g in got]), img,
                               rtol=1e-4, atol=1e-5)
    assert {k for g in got for k in g[1]} == state.keys()
    for f, want in state.items():
        torch.testing.assert_close(torch.cat([g[1][f] for g in got], 2),
                                   want, rtol=1e-4, atol=1e-5, msg=f)


@pytest.mark.parametrize("ref", ["port", "jax"])
def test_zsharded_scan_matches_one_device(world, ref):
    """accumulate_zsharded's Z blocks put together against accumulate_scan
    of the whole volume (the port's, and JAX's XLA scan): rtol 2e-5 / atol
    2e-6 (tests/test_parallel.py)."""
    refs, ranks = world
    want = refs["scan" if ref == "port" else "j_scan"]
    got = torch.cat([rk["zscan"] for rk in ranks], dim=1)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)


def test_light_sharded_scatter_matches_one_process(world):
    """Every rank's light_sharded_scatter against the XLA scatter of all 16
    lights in one process: rtol 2e-5 / atol 2e-6 (tests/test_parallel.py)."""
    refs, ranks = world
    assert float(refs["lights"][:3].abs().max()) > 0.0
    for rk in ranks:
        torch.testing.assert_close(rk["lights"], refs["lights"], rtol=2e-5,
                                   atol=2e-6)


@pytest.mark.parametrize("rank", range(N))
def test_dcp_checkpoint_restores_each_ranks_rows(world, rank):
    """save_state_orbax then load_state_orbax on 2 gloo ranks: rank `rank`
    gets back its own rows of every history (H block `rank`), the view
    matrix and the frame count, bit for bit."""
    _, ranks = world
    want = worker.seeded_state()
    got = ranks[rank]["checkpoint"]
    hl = worker.SHARDED.volume_height // N
    rows = worker.histories(want)
    assert got["histories"].keys() == rows.keys()
    for f, t in rows.items():
        assert torch.equal(got["histories"][f],
                           t[:, :, rank * hl:(rank + 1) * hl]), f
    assert torch.equal(got["view"], want.prev_world_to_view)
    assert got["frame_count"] == want.frame_count


def test_dcp_checkpoint_of_ranks_loads_whole(world):
    """The 2 ranks' checkpoint loaded in one process without a group into
    the whole state's structure: every history bit for bit (DTensor shards
    kept each rank's rows, which same-key plain tensors would not)."""
    refs, _ = world
    want = worker.seeded_state()
    like = vt.FrameState.create(worker.SHARDED.grid_dhw, 1, device="cpu",
                                with_material=True, with_scatter=True)
    got = load_state_orbax(refs["dcp"], like)
    _equal(worker.histories(got), worker.histories(want), "whole state")
    assert got.frame_count == want.frame_count
    assert torch.equal(got.prev_world_to_view, want.prev_world_to_view)
