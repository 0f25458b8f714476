"""H-sharded rendering: the single-device slab emulation.

Port of `volumetricrenderer_tpu/parallel/shard_render.py`
`make_multislab_render` and what it rests on (`Slab`, `_edge_slices`,
`_write_halo`, `crop_sharded_state`). Froxel rays are independent in x and
y, and every pass is at most a small stencil in y: the windowed
reprojection reads +-reproj_window rows, the jittered integrate +-1, the
composite's y tent +-1 cell row. So each of n shards renders an OVERLAPPED
slab of H/n + 2 halo froxel rows, starting at global row y0 = i H/n - halo,
and composites only its own band of IH/n image rows. Froxel y stays global
inside every pass and kernel (the frame tables carry y0 and the low grid's
y phase), rows past the grid's edges clamp to the edge row, so the image
does not depend on n.

The histories stay halo-extended across frames (persistent halos): each
frame overwrites the halo rows on both sides of each history with the
neighbours' freshly computed interior edge rows (`_edge_slices` of the
neighbour, `_write_halo` here), the shards at the global edges repeating
their own edge row. `crop_sharded_state` recovers the plain global layout.

Two functions run the same per-shard step (render_frame with the shard's
slab and its refreshed halos):

  make_multislab_render  the n shards one after the other on one device,
                         the neighbours' edge rows passed explicitly
  make_shardmap_render   one shard per rank of a torch.distributed group
                         (parallel/sharding.Mesh), the edge rows exchanged
                         between neighbour ranks (`_refresh_halo`, and
                         `_halo_rows` for a state in the plain layout) by
                         send/recv, where the JAX function ppermutes

so the two agree bit for bit. The JAX package's padded plane layout is a
TPU layout: the port's histories are [C, D, H, W], so the halo axis is 2
for every history, and a shard's steady state is the slab renderer's own
init_state (JAX `_steady_slab_state`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from volumetricrenderer_tpu_torch import convert
from volumetricrenderer_tpu_torch.parallel.sharding import Mesh
from volumetricrenderer_tpu_torch.renderer import VolumetricRenderer
from volumetricrenderer_tpu_torch.state import FrameState

# the histories that carry halo rows, each [C, D, H, W] (halo axis 2)
HALO_FIELDS = ("prev_shadow", "prev_material_a", "prev_scatter",
               "prev_accumulation")
HALO_AXIS = 2


class Slab(NamedTuple):
    """One shard's slab, handed to VolumetricRenderer.render_frame."""
    y0: float                           # global froxel row of local row 0
    halo: int                           # overcomputed rows per side
    grid_global: Tuple[int, int, int]   # (W, H, D) of the whole grid
    image_height_global: int            # IH of the whole image


def _crop_history(x: torch.Tensor, n: int, halo: int, axis: int,
                  h_global: Optional[int] = None,
                  grid_dhw=None) -> torch.Tensor:
    """One history of a stacked persistent-halo sharded state (n shards of
    h_loc + 2 halo rows each along `axis`) cropped to the global [.., H, ..]
    layout. A tensor of h_global rows, or one whose rows do not split into
    n extended slabs, passes through. A JAX zgather padded plane needs
    grid_dhw (the global (D, H, W)) and comes back as a plain [D, H, W]
    plane (convert.crop_padded_slabs)."""
    axis = axis % x.dim()
    if convert.is_zg_padded(x):
        if grid_dhw is None:
            raise ValueError(
                f"acc plane is in the zgather padded layout {tuple(x.shape)}:"
                " crop_sharded_state needs grid_dhw (and h_global) to crop "
                "it")
        return convert.crop_padded_slabs(x, n, halo, grid_dhw)
    rows = x.shape[axis]
    if h_global is not None and rows == h_global:
        return x
    if rows % n != 0:
        return x
    h_ext = rows // n
    h_loc = h_ext - 2 * halo
    if h_loc <= 0 or rows == n * h_loc:
        return x
    shape = list(x.shape)
    xs = x.reshape(shape[:axis] + [n, h_ext] + shape[axis + 1:])
    xs = xs.narrow(axis + 1, halo, h_loc)
    return xs.reshape(shape[:axis] + [n * h_loc] + shape[axis + 1:])


def crop_sharded_state(state: FrameState, n: int, halo: int,
                       h_global: Optional[int] = None,
                       grid_dhw=None) -> FrameState:
    """Global-layout view of a persistent-halo sharded state: each shard's
    rows of the stacked [.., n (h_loc + 2 halo), ..] histories cropped to
    its interior and put back together as [.., H, ..] (for inspection, or
    to go on rendering the whole grid). Pass h_global (`fn.h_global`) to
    make the pass-through of an already plain state exact. The
    accumulation may also be a tuple of per-channel planes along axis 1,
    JAX zgather padded planes among them (these need grid_dhw)."""
    crop = lambda x, axis=HALO_AXIS: None if x is None else _crop_history(
        x, n, halo, axis, h_global, grid_dhw)
    acc = state.prev_accumulation
    acc = tuple(crop(a, 1) for a in acc) if isinstance(acc, (tuple, list)) \
        else crop(acc)
    return dataclasses.replace(
        state, prev_shadow=crop(state.prev_shadow),
        prev_material_a=crop(state.prev_material_a),
        prev_scatter=crop(state.prev_scatter), prev_accumulation=acc)


def _edge_slices(x: torch.Tensor, p: int, axis: int, h_ext: int):
    """(first, last, clamp_first, clamp_last) p-row edge packets of a
    halo-extended history of h_ext rows along `axis`: its first and last p
    interior rows, and its first and last interior row repeated p times
    (what a shard at the global edge writes into its own halo). Views of
    x: the step never writes into a history it was given."""
    axis = axis % x.dim()
    size = x.shape[axis]
    if size != h_ext:
        raise ValueError(f"history of {size} rows along axis {axis}, slab "
                         f"of {h_ext}")
    rep = lambda row: row.expand(*x.shape[:axis], p, *x.shape[axis + 1:])
    return (x.narrow(axis, p, p), x.narrow(axis, size - 2 * p, p),
            rep(x.narrow(axis, p, 1)), rep(x.narrow(axis, size - p - 1, 1)))


def _write_halo(x: torch.Tensor, top: torch.Tensor, bot: torch.Tensor,
                p: int, axis: int, h_ext: int) -> torch.Tensor:
    """x with its p halo rows per side along `axis` replaced by the packets
    top and bot: a new tensor (JAX writes the same rows in place into the
    donated buffer)."""
    axis = axis % x.dim()
    if x.shape[axis] != h_ext:
        raise ValueError(f"history of {x.shape[axis]} rows, slab of {h_ext}")
    return torch.cat([top, x.narrow(axis, p, h_ext - 2 * p), bot], dim=axis)


def _edges(state: FrameState, p: int, h_ext: int):
    """The four edge packets of every halo history of one shard's state:
    ({field: first}, {field: last}, {field: clamp first},
    {field: clamp last}), None where the history is off."""
    packs = ({}, {}, {}, {})
    for f in HALO_FIELDS:
        x = getattr(state, f)
        parts = (None,) * 4 if x is None \
            else _edge_slices(x, p, HALO_AXIS, h_ext)
        for pack, part in zip(packs, parts):
            pack[f] = part
    return packs


def _slabs(renderer: VolumetricRenderer, n: int, halo: Optional[int]):
    """(rows per shard h_loc, halo p, the renderer of one shard's
    halo-extended slab and image band) for n shards, checked as the JAX
    package checks them."""
    cfg = renderer.config
    h_g, ih_g = cfg.volume_height, cfg.image_height
    if h_g % n or ih_g % n:
        raise ValueError(f"grid height {h_g} and image height {ih_g} must "
                         f"divide into {n} slabs")
    h_loc = h_g // n
    p = halo if halo is not None else min(cfg.reproj_window + 2, h_loc)
    if not 1 <= p <= h_loc:
        raise ValueError(f"halo {p} must be in [1, {h_loc}] (the composite "
                         "tent reads row -1)")
    if cfg.reproj_impl not in ("windowed", "pallas"):
        raise NotImplementedError(
            f"reproj_impl={cfg.reproj_impl!r} in a slab: only the windowed "
            "reprojections have the bounded row support the halo covers")
    cfg_loc = dataclasses.replace(cfg, volume_height=h_loc + 2 * p,
                                  image_height=ih_g // n)
    return h_loc, p, VolumetricRenderer(cfg_loc, device=renderer.device)


def make_multislab_render(renderer: VolumetricRenderer, n: int,
                          halo: Optional[int] = None, fixed_inputs=None):
    """Single-device emulation of the n-shard slab pipeline: the per-shard
    renderer, halo data flow and persistent-halo state of the JAX package's
    make_shardmap_render, the halo exchange replaced by neighbour edge rows
    passed explicitly and the n shards run one after the other.

    Returns fn with fn(carry, scene, time_x, sc_bands, vd_bands) ->
    (image_bands, new_carry), the bands being the IH/n-row G-buffer bands
    (lists of [IH/n, IW, 3] and [IH/n, IW]) and the image bands
    [IH/n, IW, 4]; fn.init_carry(n_dir) builds the first carry,
    fn.halo, fn.n_shards and fn.h_global describe the slabs, and
    fn.renderer is the renderer of the slab's shape that every shard's
    step calls.
    fixed_inputs=(sc_bands, vd_bands) binds each shard's G-buffer band
    (fn then takes (carry, scene, time_x)), as the JAX package binds them
    as compile-time constants.

    The default halo is min(reproj_window + 2, H/n): the composed row
    stencil of one frame is the warp's +-reproj_window, the integrate's +-1
    and the composite tent's +-1, so the seams are exact for every motion
    the warp window supports. The renderer's device is the shards'."""
    cfg = renderer.config
    h_g, ih_g = cfg.volume_height, cfg.image_height
    h_loc, p, renderer_loc = _slabs(renderer, n, halo)
    h_ext = h_loc + 2 * p

    def step(state, top, bot, y0, scene, time_x, sc_band, vd_band):
        # the halos from the neighbours' packets (last frame's interiors)
        halos = {f: None if getattr(state, f) is None else _write_halo(
            getattr(state, f), top[f], bot[f], p, HALO_AXIS, h_ext)
            for f in HALO_FIELDS}
        st = dataclasses.replace(state, **halos)
        slab = Slab(y0=y0, halo=p, grid_global=cfg.grid,
                    image_height_global=ih_g)
        image, _, new_state = renderer_loc.render_frame(
            st, scene, time_x, scene_color=sc_band, view_depth=vd_band,
            slab=slab)
        return image, new_state, _edges(new_state, p, h_ext)

    if fixed_inputs is not None:
        sc_fix, vd_fix = fixed_inputs
        steps = [functools.partial(step, sc_band=sc_fix[i],
                                   vd_band=vd_fix[i]) for i in range(n)]
    else:
        steps = [step] * n

    def init_carry(n_dir: int):
        states = [renderer_loc.init_state(n_dir) for _ in range(n)]
        return states, [_edges(s, p, h_ext) for s in states]

    def fn(carry, scene, time_x, sc_bands=None, vd_bands=None):
        states, edges = carry
        new_states, new_edges, bands = [], [], []
        for i in range(n):
            # top halo <- shard i-1's last interior rows, bottom halo <-
            # shard i+1's first; the global edges repeat their own rows
            top = edges[i - 1][1] if i > 0 else edges[i][2]
            bot = edges[i + 1][0] if i < n - 1 else edges[i][3]
            y0 = float(np.float32(i * h_loc - p))
            args = (states[i], top, bot, y0, scene, time_x)
            if fixed_inputs is None:
                args += (sc_bands[i], vd_bands[i])
            img, st, ed = steps[i](*args)
            bands.append(img)
            new_states.append(st)
            new_edges.append(ed)
        return bands, (new_states, new_edges)

    fn.halo = p
    fn.n_shards = n
    fn.renderer = renderer_loc
    fn.h_global = h_g
    fn.init_carry = init_carry
    return fn


def _plain_edges(x: torch.Tensor, p: int, axis: int):
    """(first, last, clamp_first, clamp_last) p-row packets of a history in
    the plain layout (this shard's own rows, no halo): what _halo_rows
    sends and what a shard at the global edge repeats."""
    size = x.shape[axis]
    rep = lambda row: row.expand(*x.shape[:axis], p, *x.shape[axis + 1:])
    return (x.narrow(axis, 0, p), x.narrow(axis, size - p, p),
            rep(x.narrow(axis, 0, 1)), rep(x.narrow(axis, size - 1, 1)))


def _exchange(mesh: Mesh, first, last):
    """The neighbour exchange of one frame: this rank's `last` packets go
    to rank + 1 and its `first` packets to rank - 1, while the top packets
    come from rank - 1 and the bottom packets from rank + 1 (the JAX
    function's two ppermutes), every history's packets in one message per
    direction. first and last: lists of equally shaped tensors on every
    rank. Returns (top, bottom), None at a global edge. Under gloo a CUDA
    payload goes through host memory (Mesh.to_wire / from_wire)."""
    r, n = mesh.rank, mesh.size
    shapes = [t.shape for t in first]
    pack = lambda ts: mesh.to_wire(torch.cat([t.reshape(-1) for t in ts]))
    ops, top, bot = [], None, None
    if r > 0:
        up = pack(first)
        top = torch.empty_like(up)
        ops += [dist.P2POp(dist.isend, up, mesh.peer(r - 1), mesh.group),
                dist.P2POp(dist.irecv, top, mesh.peer(r - 1), mesh.group)]
    if r < n - 1:
        down = pack(last)
        bot = torch.empty_like(down)
        ops += [dist.P2POp(dist.isend, down, mesh.peer(r + 1), mesh.group),
                dist.P2POp(dist.irecv, bot, mesh.peer(r + 1), mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    sizes = [int(np.prod(sh)) for sh in shapes]
    unpack = lambda buf: None if buf is None else [
        t.view(sh) for t, sh in zip(mesh.from_wire(buf).split(sizes), shapes)]
    return unpack(top), unpack(bot)


def _neighbour_rows(xs, mesh: Mesh, edges):
    """(top, bottom) halo packets of the histories xs: the neighbours'
    edge rows, or this shard's own edge row repeated at a global edge.
    edges(x) -> (first, last, clamp_first, clamp_last) of one history."""
    parts = [edges(x) for x in xs]
    top, bot = _exchange(mesh, [e[0] for e in parts], [e[1] for e in parts])
    top = top if top is not None else [e[2] for e in parts]
    bot = bot if bot is not None else [e[3] for e in parts]
    return top, bot


def _halo_rows(xs, p: int, mesh: Mesh, axis: int):
    """The histories xs (this shard's rows in the plain layout) extended
    along `axis` by p rows from each neighbour shard; the shards at the
    global edges repeat their edge row (the clamp sampler's semantics).
    One exchange for all of xs."""
    top, bot = _neighbour_rows(xs, mesh, lambda x: _plain_edges(x, p, axis))
    return [torch.cat([t, x, b], dim=axis) for x, t, b in zip(xs, top, bot)]


def _refresh_halo(xs, p: int, mesh: Mesh, axis: int, h_ext: int):
    """The histories xs, already halo-extended (the persistent-halo
    state), with their p halo rows per side overwritten by the neighbours'
    freshly computed interior edge rows: the packets of _edge_slices, sent
    by _exchange and written by _write_halo, the same indices as
    make_multislab_render's, so the two agree bit for bit. One exchange
    for all of xs."""
    top, bot = _neighbour_rows(xs, mesh,
                               lambda x: _edge_slices(x, p, axis, h_ext))
    return [_write_halo(x, t, b, p, axis, h_ext)
            for x, t, b in zip(xs, top, bot)]


def make_shardmap_render(renderer: VolumetricRenderer, mesh: Mesh,
                         halo: Optional[int] = None, fixed_inputs=None):
    """One slab per rank of the mesh's process group (parallel/sharding.
    make_mesh): this rank renders shard mesh.rank of the mesh.size-shard
    slab pipeline with the renderer's config, on the renderer's device,
    and exchanges its histories' edge rows with its neighbour ranks over
    the mesh's group once a frame -- make_multislab_render's step with the
    explicit packets replaced by send/recv, so that on every rank the image
    band and the cropped state equal make_multislab_render's shard
    mesh.rank bit for bit (the JAX package's contract,
    tests/test_shard_render.py).

    Returns fn(state, scene, time_x, scene_color, view_depth) ->
    (image band [IH/n, IW, 4], new state): scene_color [IH/n, IW, 3] and
    view_depth [IH/n, IW] are this rank's G-buffer band; fixed_inputs =
    (scene_color, view_depth) binds them (fn then takes (state, scene,
    time_x)). state is this rank's state, either
      - in the plain layout (its H/n rows of a global state,
        sharding.shard_state): extended once by _halo_rows, or
      - in the steady, halo-extended layout of fn.init_state(n_dir) or of
        the state fn returned: its halo rows refreshed by _refresh_halo.
    The new state stays halo-extended (crop_sharded_state(state, 1,
    fn.halo) gives this rank's rows). Every rank must call fn the same
    number of times: each call exchanges with the neighbours.

    The exchange takes the mesh's group and backend as given: NCCL sends
    the device's tensors; under gloo the edge rows of a CUDA state go
    through host memory (`.cpu()` before the send, back to the device after
    the receive), since gloo carries host tensors, while the frame's work
    stays on the renderer's device. fn.halo, fn.n_shards and fn.h_global
    describe the slabs, fn.slab and fn.renderer (of the slab's shape) this
    rank's shard."""
    cfg = renderer.config
    n, i = mesh.size, mesh.rank
    if mesh.device.type != renderer.device.type:
        raise ValueError(f"the mesh's shard lives on {mesh.device}, the "
                         f"renderer runs on {renderer.device}")
    h_loc, p, renderer_loc = _slabs(renderer, n, halo)
    h_ext = h_loc + 2 * p
    slab = Slab(y0=float(np.float32(i * h_loc - p)), halo=p,
                grid_global=cfg.grid, image_height_global=cfg.image_height)

    def fn(state, scene, time_x, scene_color=None, view_depth=None):
        if fixed_inputs is not None:
            scene_color, view_depth = fixed_inputs
        fields = [f for f in HALO_FIELDS if getattr(state, f) is not None]
        xs = [getattr(state, f) for f in fields]
        rows = xs[0].shape[HALO_AXIS]
        if rows == h_ext:
            xs = _refresh_halo(xs, p, mesh, HALO_AXIS, h_ext)
        elif rows == h_loc:
            xs = _halo_rows(xs, p, mesh, HALO_AXIS)
        else:
            raise ValueError(f"a state of {rows} rows: this shard takes "
                             f"{h_loc} (plain) or {h_ext} (halo-extended)")
        st = dataclasses.replace(state, **dict(zip(fields, xs)))
        image, _, new_state = renderer_loc.render_frame(
            st, scene, time_x, scene_color=scene_color,
            view_depth=view_depth, slab=slab)
        return image, new_state

    fn.halo = p
    fn.n_shards = n
    fn.h_global = cfg.volume_height
    fn.slab = slab
    fn.renderer = renderer_loc
    fn.init_state = renderer_loc.init_state
    return fn
