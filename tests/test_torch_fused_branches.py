"""The fused frame's per-light and inline-visibility branches, the 16x16-cell
and co-sited composites, and the renderer's host copy of a scene edited in
place.

- K2's twin with one shadow ray per light (raycast_shadow_subsample=1) and
  with the low-rate visibility of K9's twin (scatter_bake="vis", ss=4)
  against the JAX megakernel `frame_volume_fused` in interpret mode, random
  histories and a moved previous camera;
- the port's render_frame at FULL_CONFIG + scatter_bake="vis", ss=1
  (bench.py's exact_ms frame) against JAX's render_frame under jax.jit over
  two frames, the camera moving between them;
- the port's fused frames against its staged ones (the same kernels' device
  code, one launch apart), bit for bit;
- K4's twin against `composite_zgather_planes` at 16x16 and 8x16 pixel
  cells (its `_kernel_multisub` form), and the co-sited composite against
  JAX `pipeline.composite` at composite_upsample=2;
- every second pixel of the co-sited composite against the exact one;
- a scene edited in place between two frames (the host copy is made again).

Tolerances: the volume phase and the frames as tests/torch_tolerance.py
(rtol 1e-5 / atol 1e-6 per element, except for at most 5e-3 of the
elements, which may also sit beyond 1e-3 relative: shadow rays within ulps
of a primitive edge may flip), the frames also a mean absolute image error
of at most 1e-5 of the image maximum; the composites rtol 1e-6 / atol 1e-6
(the same float32 trilinear: the log() of the froxel z mapping may differ
by an ulp, and the TPU kernel folds the z-lerp into the tap weights, another
rounding order); the port against itself bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas.frame_fused import \
    frame_volume_fused as j_frame_volume_fused
from volumetricrenderer_tpu.ops.pallas.zg_composite import \
    composite_zgather_planes
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops import zg_composite as t_zg
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

GRID = (24, 16, 12)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
ALPHA = np.float32(0.7)
TIME_X = 0.3
K = 4                   # FULL_CONFIG's reproj_window
SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
EXACT = dict(scatter_bake="vis", raycast_shadow_subsample=1)
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]


# --------------------------------------------------------------------------
# The volume phase: K2 with rays, K9 then K2 with baked visibility
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def volume_inputs():
    js = j_bench(aspect=1.5, num_local_lights=4, noise_mode="procedural")
    ts = scene_from_numpy(js, "cpu")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        jnp.asarray([-0.1, 1.8, -15.5]), jnp.asarray([0.05, -0.02, 1.0]),
        jnp.asarray([0.0, 1.0, 0.0])))
    rng = np.random.default_rng(7)
    w, h, d = GRID
    prev_sh = rng.uniform(0, 1, (1, d, h, w)).astype(np.float32)
    prev_acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    return js, ts, jp, tp, jprev, prev_sh, prev_acc


def run_volume(inputs, ss, inline):
    """(JAX, port) volume phase: (shadow [1, D, H, W], acc [4, D, H, W])."""
    js, ts, jp, tp, jprev, prev_sh, prev_acc = inputs
    kw = dict(vis_ss=ss, vis_radiance=False, bake_noise=True,
              inline_vis_bake=inline)
    j_sh, j_acc = j_frame_volume_fused(
        jp, js.camera.view_to_world(), jprev, jnp.asarray(JIT),
        jnp.float32(ALPHA), js.dir_lights, js.point_lights, js.spot_lights,
        js.geometry, js.media, TIME_X, js.camera.position,
        jnp.asarray(prev_sh), tuple(jnp.asarray(p) for p in prev_acc), GRID,
        K, interpret=True, **kw)
    t_sh, t_acc = t_ff.frame_volume_fused(
        tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)), JIT,
        ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, TIME_X, ts.camera.position, torch.as_tensor(prev_sh),
        torch.as_tensor(prev_acc), GRID, K, **kw)
    return (np.asarray(j_sh), np.stack([np.asarray(a) for a in j_acc])), \
        (t_sh.numpy(), t_acc.numpy())


@pytest.fixture(scope="module")
def volume_rays(volume_inputs):
    """The per-light branch: no inline bake (raycast_shadow_subsample=1)."""
    return run_volume(volume_inputs, 1, False)


@pytest.fixture(scope="module")
def volume_baked(volume_inputs):
    """The inline visibility bake at ss=4 (scatter_bake="vis")."""
    return run_volume(volume_inputs, 4, True)


@pytest.mark.parametrize("branch", ["rays", "baked"])
def test_volume_phase_branch_matches_megakernel(request, branch):
    (j_sh, j_acc), (t_sh, t_acc) = request.getfixturevalue(
        f"volume_{branch}")
    assert_boundary_close(t_sh, j_sh, f"shadow, {branch}")
    for c in range(4):
        assert_boundary_close(t_acc[c], j_acc[c], f"acc c={c}, {branch}")
    assert np.abs(t_acc[:3]).max() > 0.0


def test_volume_phase_routes_on_the_tables(volume_inputs, monkeypatch):
    """volume_phase bakes K9's volume for the visibility tables, nothing at
    ss=1, and the radiance only where no light schedule was packed; each
    wrapper returns its twin's result on the CPU."""
    js, ts, jp, tp, jprev, prev_sh, prev_acc = volume_inputs
    calls = []
    monkeypatch.setattr(t_ff, "bake_radiance",
                        lambda t: calls.append("radiance"))
    real_vis = t_ff.bake_visibility
    monkeypatch.setattr(t_ff, "bake_visibility",
                        lambda t: calls.append("vis") or real_vis(t))

    def tables(ss, schedule):
        return t_ff.frame_tables(
            tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)),
            JIT, ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights,
            ts.geometry, ts.media, TIME_X, ts.camera.position, GRID, K, ss,
            bake_noise=False, light_schedule=schedule)

    sh, acc = torch.as_tensor(prev_sh), torch.as_tensor(prev_acc)
    t_rays, t_baked = tables(1, None), tables(4, True)
    assert (t_rays.local_source, t_baked.local_source,
            tables(4, None).local_source) == ("ray", "baked", "radiance")
    t_ff.volume_phase(t_rays, sh, acc)
    assert calls == []
    t_ff.volume_phase(t_baked, sh, acc)
    assert calls == ["vis"]
    vis = t_vis.bake_visibility_plain(t_baked)
    for t, v in ((t_rays, None), (t_baked, vis)):
        got = t_ff.shadow_scatter(t, sh, vis=v)
        want = t_ff.shadow_scatter_plain(t, sh, vis=v)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        t_ff.shadow_scatter(t_baked, sh, vis=vis[:, :1])


# --------------------------------------------------------------------------
# Frames
# --------------------------------------------------------------------------

def small_scenes():
    base = j_bench(aspect=128 / 120, num_local_lights=4,
                   noise_mode="procedural")
    return [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=128 / 120)) for p, f in CAMERAS]


@pytest.fixture(scope="module")
def exact_frames():
    """Two frames of FULL_CONFIG + scatter_bake="vis", ss=1 (fused) in JAX
    and in the port, on JAX's G-buffer of each camera."""
    scenes = small_scenes()
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL, **EXACT))
    gbuffers = [tuple(np.array(a) for a in
                      jax.jit(jr.render_scene_inputs)(sc)) for sc in scenes]
    step = jax.jit(lambda s, sc, t, c, d: jr.render_frame(
        s, sc, t, scene_color=c, view_depth=d)[::2])
    st = jr.init_state(1)
    j_imgs = []
    for i, (sc, (c, d)) in enumerate(zip(scenes, gbuffers)):
        img, st = step(st, sc, jnp.float32(0.1 * i), c, d)
        j_imgs.append(np.asarray(img))
    j_state = (np.asarray(packed_accumulation(st.prev_accumulation,
                                              jr.config.grid_dhw)),
               np.asarray(st.prev_shadow))
    tr = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **SMALL, **EXACT), device="cpu")
    assert tr.fuses_frame()
    ts = tr.init_state(1)
    t_imgs = []
    for i, (sc, (c, d)) in enumerate(zip(scenes, gbuffers)):
        img, _, ts = tr.render_frame(ts, scene_from_numpy(sc, "cpu"),
                                     np.float32(0.1 * i), torch.as_tensor(c),
                                     torch.as_tensor(d))
        t_imgs.append(img.numpy())
    t_state = (t_packed(ts.prev_accumulation).numpy(),
               ts.prev_shadow.numpy())
    return j_imgs, j_state, t_imgs, t_state


@pytest.mark.parametrize("i", [0, 1])
def test_fused_exact_image_matches_jax(exact_frames, i):
    j_imgs, _, t_imgs, _ = exact_frames
    a, b = t_imgs[i], j_imgs[i]
    assert a.shape == b.shape == (120, 128, 4)
    assert_boundary_close(a, b, f"image {i}")
    assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()


def test_fused_exact_state_matches_jax(exact_frames):
    _, (j_acc, j_sh), _, (t_acc, t_sh) = exact_frames
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")


def render(kw, scene, frames=2, small=SMALL):
    r = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **small, **kw), device="cpu")
    st = r.init_state(1)
    for i in range(frames):
        img, _, st = r.render_frame(st, scene, 0.1 * i)
    return r, img, st


@pytest.mark.parametrize("kw", [EXACT, dict(scatter_bake="vis")],
                         ids=["exact", "vis_bake"])
def test_fused_branch_equals_staged_frame(kw):
    """The fused per-light (ss=1) and inline-visibility (ss=4) frames run
    the staged frame's functions in another grouping: the same image and
    histories bit for bit."""
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    rf, img_f, st_f = render(kw, scene)
    rs, img_s, st_s = render(dict(kw, frame_fused=False), scene)
    assert rf.fuses_frame() and not rs.fuses_frame()
    assert torch.equal(img_f, img_s)
    assert torch.equal(st_f.prev_shadow, st_s.prev_shadow)
    assert torch.equal(st_f.prev_accumulation, st_s.prev_accumulation)


# --------------------------------------------------------------------------
# K4: 16x16 and 8x16 cells, the co-sited composite
# --------------------------------------------------------------------------

CGRID = (16, 15, 8)


@pytest.fixture(scope="module")
def composite_inputs():
    w, h, d = CGRID
    kw = dict(position=(0.0, 1.0, 0.0), forward=(0.0, 0.0, 1.0),
              aspect=256 / 240, near=0.3)
    jc, tc = JCamera.create(**kw), vt.Camera.create(**kw, device="cpu")
    jp = jfroxel.make_froxel_params(jc.fov_y, jc.aspect, jc.near, 40.0, 2.0,
                                    CGRID)
    tp = tfroxel.make_froxel_params(tc.fov_y, tc.aspect, tc.near, 40.0, 2.0,
                                    CGRID)
    rng = np.random.default_rng(13)
    acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    scene = rng.uniform(0, 1, (240, 256, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 45.0, (240, 256)).astype(np.float32)
    depth[::7, ::5] = 0.01          # before the near plane (log clamp)
    depth[3::11, 2::9] = 500.0      # past the volume's far end
    return jp, tp, acc, scene, depth


@pytest.mark.parametrize("py,px", [(16, 16), (8, 16)])
def test_k4_matches_multisub_cells(composite_inputs, py, px):
    jp, tp, acc, _, depth = composite_inputs
    w, h, _ = CGRID
    depth = depth[:h * py, :w * px]
    fz = jfroxel.depth_to_froxel_z(jp, jnp.asarray(depth)) - 0.5
    want = composite_zgather_planes(tuple(jnp.asarray(p) for p in acc), fz,
                                    CGRID, interpret=True)
    got = t_zg.composite_planes(torch.as_tensor(acc), torch.as_tensor(depth),
                                tp, CGRID)
    assert got.shape == (4, h * py, w * px)
    for c in range(4):
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]),
                                   rtol=1e-6, atol=1e-6)


def test_cosited_composite_matches_jax(composite_inputs):
    """JAX pipeline.composite at composite_upsample=2 (eagerly: each op
    alone, as the port runs them) against the port's co-sited composite."""
    jp, tp, acc, scene, depth = composite_inputs
    w, h, d = CGRID
    cfg = dataclasses.replace(J_FULL, volume_width=w, volume_height=h,
                              volume_depth=d, image_width=256,
                              image_height=240, composite_upsample=2)
    want = jpipeline.composite(cfg, jp, jnp.asarray(acc.transpose(1, 2, 3, 0)),
                               jnp.asarray(scene), jnp.asarray(depth))
    tcfg = dataclasses.replace(vt.FULL_CONFIG, **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name in ("volume_width", "volume_height", "volume_depth",
                      "image_width", "image_height", "composite_upsample")})
    assert vt.config.cosited_eligible(tcfg)
    got = t_zg.composite_cosited(torch.as_tensor(acc), torch.as_tensor(scene),
                                 torch.as_tensor(depth), tp, CGRID, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_cosited_every_second_pixel_is_exact(composite_inputs):
    """The co-sited composite's every second pixel of each axis is the
    exact composite (16x16-pixel cells) there, bit for bit: the same depth,
    the same in-cell weights, and the upsample's phase 0 adds 0."""
    _, tp, acc, scene, depth = composite_inputs
    args = (torch.as_tensor(acc), torch.as_tensor(scene),
            torch.as_tensor(depth), tp, CGRID)
    cos, exact = t_zg.composite_cosited(*args, 2), t_zg.composite(*args)
    assert torch.equal(cos[::2, ::2], exact[::2, ::2])
    assert not torch.equal(cos, exact)


def test_uhd_frame_every_second_pixel_is_exact():
    """UHD_CONFIG's frame against UHD at composite_upsample=1 (16x16-pixel
    cells) over two frames: the same volume phase and histories, and every
    second pixel of the image bit for bit."""
    small = dict(SMALL, image_width=256, image_height=240)
    scene = vt.benchmark_scene(aspect=256 / 240, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    r, uhd, st = render(dict(composite_upsample=2), scene, small=small)
    _, exact, st_x = render(dict(composite_upsample=1), scene, small=small)
    assert vt.config.cosited_eligible(r.config)
    assert uhd.shape == exact.shape == (240, 256, 4)
    assert torch.equal(uhd[::2, ::2], exact[::2, ::2])
    assert torch.equal(st.prev_accumulation, st_x.prev_accumulation)


def test_cosited_weights_are_the_exact_cells_at_every_us_th_pixel():
    """cell_weights(p, p, us) row i equals cell_weights(us*p, us*p) at
    in-cell pixel us*i (JAX `_cell_weights_at` at co-sited offsets)."""
    from volumetricrenderer_tpu.ops.pallas.composite import _cell_weights_at
    for p, us in ((8, 2), (4, 4)):
        lo = t_zg.cell_weights(p, p, us).reshape(9, p, p)
        full = t_zg.cell_weights(us * p, us * p).reshape(9, us * p, us * p)
        assert np.array_equal(lo, full[:, ::us, ::us])
        f = (us * np.arange(p) + 0.5) / (us * p) - 0.5
        assert np.array_equal(lo.reshape(9, -1), _cell_weights_at(f, f))


# --------------------------------------------------------------------------
# The host copy of a scene edited in place
# --------------------------------------------------------------------------

def clone_tree(obj):
    """A dataclass tree with every tensor cloned."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: clone_tree(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(clone_tree(o) for o in obj)
    return obj


def test_scene_edited_in_place_reaches_the_tables(monkeypatch):
    """On the CPU scene.to("cpu") returns the scene's own tensors; cloning
    them, as a copy from the card does, makes the renderer's host copy a
    snapshot. After camera.position is edited in place, the next frame must
    equal a fresh renderer's frame of the edited scene from the same
    state."""
    real_to = vt.Scene.to
    monkeypatch.setattr(vt.Scene, "to", lambda self, device: clone_tree(self)
                        if torch.device(device).type == "cpu"
                        else real_to(self, device))
    cfg = dataclasses.replace(vt.FULL_CONFIG, **SMALL)
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    r = vt.VolumetricRenderer(cfg, device="cpu")
    host = r.host_scene(scene)
    assert host.camera.position is not scene.camera.position
    assert r.host_scene(scene) is host          # unchanged: kept
    _, _, st = r.render_frame(r.init_state(1), scene, 0.0)
    scene.camera.position.add_(torch.tensor([0.5, 0.2, 1.0]))
    img, _, st2 = r.render_frame(st, scene, 0.1)
    fresh = vt.VolumetricRenderer(cfg, device="cpu")
    want, _, want_st = fresh.render_frame(st, scene, 0.1)
    assert torch.equal(img, want)
    assert torch.equal(st2.prev_accumulation, want_st.prev_accumulation)
    assert torch.equal(r.host_scene(scene).camera.position,
                       scene.camera.position)
