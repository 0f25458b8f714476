"""The reference demo scene in the port: the procedural heightfield (terrain)
and fractional box opacity in every ray cast, `demo_scene`, and the
composites of any pixel/froxel ratio, against the JAX package.

- `demo_scene`'s fields, bit for bit;
- the ray casting of ops/raycast at demo_scene's own terrain (12 steps, 2
  octaves): heightfield_height, intersect (depth, albedo, normal) and
  occluded, solid and fractional, with and without the terrain, against
  JAX's XLA functions on 4000 random rays, their fori_loops run op by op
  (under jit XLA's CPU backend contracts multiply-adds, and the march's
  sample tests are knife edges);
- the in-kernel helpers' twins, `any_hit` (solid and fractional, with and
  without the terrain) and `heightfield_occluded`, against JAX's
  ops/pallas/occlude.any_hit and ops/pallas/material.heightfield_occluded,
  called eagerly on plain arrays;
- the fused frame on demo_scene with a cheap terrain march (4 steps, 1
  octave, as tests/test_heightfield.py cuts it for interpret mode) and
  heightfield_local_shadows, against JAX render_frame (the megakernel in
  interpret mode) over 2 frames at a 16x11x12 grid and 128x90 pixels,
  where JAX composites with composite_rowmm; the fused volume phase with
  heightfield_local_shadows on and off, and on a fractional-box scene
  built as tests/test_box_opacity.py builds it, against JAX
  frame_volume_fused in interpret mode;
- the composite at every route of JAX pipeline.composite that K4 now
  serves: rowmm, anyres, "xla" and tentmm, JAX called eagerly (under jit
  XLA contracts the scene blend's multiply-add);
- the plain shadow volume (dir_shadow_impl="xla") and the shadow-map bake
  see the terrain.

Tolerances: the ray casts and helpers bit for bit (the same float32
operations in the same order); the frames and volume phases as
tests/torch_tolerance.py (rtol 1e-5 / atol 1e-6 per element, except for at
most 5e-3 of the elements, which may also sit beyond 1e-3 relative: shadow
rays within ulps of an edge or of the terrain may flip), the images also a
mean absolute error of at most 1e-5 of the image maximum; the composites
rtol 1e-6 / atol 1e-6 (the same float32 trilinear in another rounding
order: JAX's selection matmuls, and the "xla" gather's float32 pixel
coordinates where K4 takes float64 ones)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import Geometry as JGeometry
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu import pipeline as jpipeline
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo
from volumetricrenderer_tpu.ops import raycast as j_raycast
from volumetricrenderer_tpu.ops.pallas import material as j_material
from volumetricrenderer_tpu.ops.pallas import occlude as j_occlude
from volumetricrenderer_tpu.ops.pallas.frame_fused import \
    frame_volume_fused as j_frame_volume_fused
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch import pipeline as tpipeline
from volumetricrenderer_tpu_torch import shadow as tshadow
from volumetricrenderer_tpu_torch.config import composite_route
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_dir_shadow
from volumetricrenderer_tpu_torch.ops import frame_fused as t_ff
from volumetricrenderer_tpu_torch.ops import material as t_material
from volumetricrenderer_tpu_torch.ops import occlude as t_occlude
from volumetricrenderer_tpu_torch.ops import raycast as t_raycast
from volumetricrenderer_tpu_torch.ops import zg_composite as t_zg
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

N_RAYS = 4000
# a 16x11 grid at 128x90 pixels: 90/11 is no integer, so JAX composites
# with composite_rowmm, as at the demo grid (720/88)
SMALL = dict(volume_width=16, volume_height=11, volume_depth=12,
             image_width=128, image_height=90)
GRID = (24, 16, 12)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)
ALPHA = np.float32(0.7)
K = 4
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0))]


def eager_fori(lo, hi, body, init):
    """jax.lax.fori_loop run op by op, as the port runs it."""
    c = init
    for i in range(lo, hi):
        c = body(jnp.int32(i), c)
    return c


def cheap_terrain(scene, **hf):
    """demo_scene with a march of 4 steps of 1 octave (interpret mode runs
    each step as Python-level ops) and any other heightfield fields."""
    return dataclasses.replace(scene, geometry=dataclasses.replace(
        scene.geometry, hf_steps=4, hf_octaves=1,
        **{k: jnp.float32(v) for k, v in hf.items()}))


def fractional(scene, opacity=0.5):
    """The scene with its first three boxes at `opacity`."""
    g = scene.geometry
    op = np.asarray(g.box_opacity).copy()
    op[:3] = opacity
    return dataclasses.replace(scene, geometry=dataclasses.replace(
        g, box_opacity=jnp.asarray(op), box_fractional=True))


@pytest.fixture(scope="module")
def demo():
    js = j_demo(aspect=128 / 90)
    return js, scene_from_numpy(js, "cpu")


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(0)
    o = np.stack([rng.uniform(-30, 30, N_RAYS), rng.uniform(-1, 4, N_RAYS),
                  rng.uniform(-20, 40, N_RAYS)], -1).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    max_d = rng.uniform(0.1, 60.0, N_RAYS).astype(np.float32)
    return o, d, max_d


# --------------------------------------------------------------------------
# demo_scene, Geometry.create
# --------------------------------------------------------------------------

def _walk(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _walk(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_demo_scene_matches_jax(demo):
    """demo_scene field by field, also with_noise (the fog's texture) and
    mesh_env (the tree TriMesh and its 20 shadow proxy boxes)."""
    js, _ = demo
    _walk(vt.demo_scene(aspect=128 / 90, device="cpu"),
          scene_from_numpy(js, "cpu"))
    tex = np.random.default_rng(3).random((4, 8, 16), dtype=np.float32)
    _walk(vt.demo_scene(aspect=128 / 90, with_noise=True,
                        noise_tex=torch.as_tensor(tex), device="cpu"),
          scene_from_numpy(j_demo(aspect=128 / 90, with_noise=True,
                                  noise_tex=tex), "cpu"))
    mesh = vt.demo_scene(aspect=128 / 90, device="cpu", mesh_env=True)
    _walk(mesh, scene_from_numpy(j_demo(aspect=128 / 90, mesh_env=True),
                                 "cpu"))
    assert mesh.geometry.n_proxy_boxes == 20 and mesh.mesh.num_tris == 276


def test_geometry_create_matches_jax():
    """4-tuple boxes, the heightfield dict with its statics and
    n_proxy_boxes, as JAX Geometry.create takes them."""
    kw = dict(planes=[((0.0, 2.0, 0.0), 0.5, (0.2, 0.2, 0.2))],
              spheres=[((1.0, 2.0, 3.0), 1.5, (0.5, 0.4, 0.3))],
              boxes=[((-1.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.4, 0.4, 0.4)),
                     ((2.0, 0.0, 0.0), (3.0, 2.0, 1.0), (0.3, 0.3, 0.3),
                      0.25)],
              heightfield=dict(amp=1.5, base=0.1, tiling=(0.02, 0.04),
                               offset=(0.5, -0.5), steps=6, octaves=3,
                               far=150.0),
              n_proxy_boxes=1)
    t = vt.Geometry.create(**kw, device="cpu")
    _walk(t, scene_from_numpy(dataclasses.replace(
        j_demo(), geometry=JGeometry.create(**kw)), "cpu").geometry)
    assert t.box_fractional and t.hf_enabled and t.hf_steps == 6
    assert not vt.Geometry.create(device="cpu").box_fractional


# --------------------------------------------------------------------------
# ops/raycast: the terrain and fractional arms
# --------------------------------------------------------------------------

def test_heightfield_height_matches_jax(demo, rays):
    js, ts = demo
    o = rays[0]
    want = np.asarray(j_raycast.heightfield_height(
        js.geometry, jnp.asarray(o[:, 0]), jnp.asarray(o[:, 2])))
    got = t_raycast.heightfield_height(ts.geometry, torch.as_tensor(o[:, 0]),
                                       torch.as_tensor(o[:, 2])).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.min() >= -0.3 and want.max() <= 1.7 and want.std() > 0.05


def test_intersect_matches_jax(demo, rays, monkeypatch):
    """Depth, albedo and normal of the nearest hit, the terrain's 48-step
    march, 8 bisections and finite-difference normal included."""
    js, ts = demo
    o, d, _ = rays
    monkeypatch.setattr(jax.lax, "fori_loop", eager_fori)
    want = [np.asarray(v) for v in j_raycast.intersect(
        js.geometry, jnp.asarray(o), jnp.asarray(d))]
    got = [v.numpy() for v in t_raycast.intersect(
        ts.geometry, torch.as_tensor(o), torch.as_tensor(d))]
    for g, w, what in zip(got, want, ("t", "albedo", "normal")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    terrain = np.all(want[1] == np.float32([0.24, 0.28, 0.18]), axis=-1)
    assert 0.05 < terrain.mean() < 0.9


@pytest.mark.parametrize("frac", [False, True], ids=["solid", "fractional"])
@pytest.mark.parametrize("terrain", [True, False],
                         ids=["terrain", "no_terrain"])
def test_occluded_matches_jax(demo, rays, monkeypatch, frac, terrain):
    js, ts = demo
    if frac:
        js = fractional(js)
        ts = scene_from_numpy(js, "cpu")
    o, d, max_d = rays
    monkeypatch.setattr(jax.lax, "fori_loop", eager_fori)
    want = np.asarray(j_raycast.occluded(
        js.geometry, jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_d),
        include_heightfield=terrain))
    got = t_raycast.occluded(ts.geometry, torch.as_tensor(o),
                             torch.as_tensor(d), torch.as_tensor(max_d),
                             include_heightfield=terrain).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < (want > 0).mean() < 0.9
    if frac:
        assert ((want > 0) & (want < 1)).any()


# --------------------------------------------------------------------------
# The in-kernel helpers' twins
# --------------------------------------------------------------------------

def _tables(scene):
    g = scene.geometry
    planes = np.concatenate([np.asarray(g.plane_normal),
                             np.asarray(g.plane_d)[:, None]], -1)
    spheres = np.concatenate([np.asarray(g.sphere_center),
                              np.asarray(g.sphere_radius)[:, None]], -1)
    boxes = np.array(j_occlude.pack_boxes(g))
    hf = np.array(j_material.pack_heightfield(g))
    static = (g.hf_octaves, g.hf_period, g.hf_seed, g.hf_steps, g.hf_far)
    counts = dict(n_planes=len(planes), n_spheres=len(spheres),
                  n_boxes=len(boxes))
    return planes, spheres, boxes, hf, static, counts


def _planes(rays):
    """[40, 100] origin, direction and max_t planes of the random rays."""
    o, d, max_d = rays
    r = lambda a: a.reshape(40, 100)
    return ([r(o[:, c]) for c in range(3)], [r(d[:, c]) for c in range(3)],
            r(max_d))


@pytest.mark.parametrize("frac", [False, True], ids=["solid", "fractional"])
@pytest.mark.parametrize("terrain", [True, False],
                         ids=["terrain", "no_terrain"])
def test_any_hit_matches_jax(demo, rays, frac, terrain):
    js = fractional(demo[0]) if frac else demo[0]
    planes, spheres, boxes, hf, static, counts = _tables(js)
    (wx, wy, wz), (dx, dy, dz), max_t = _planes(rays)
    hs = static if terrain else None
    j = lambda a: jnp.asarray(a)
    want = np.asarray(j_occlude.any_hit(
        j(planes), j(spheres), j(boxes), j(hf), j(wx), j(wy), j(wz), j(dx),
        j(dy), j(dz), j(max_t), hf_static=hs, fractional=frac, **counts))
    t = torch.as_tensor
    got = t_occlude.any_hit(
        t(planes), t(spheres), t(boxes), t(wx), t(wy), t(wz), t(dx), t(dy),
        t(dz), t(max_t), hf=t(hf), hf_static=hs, fractional=frac,
        **counts).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sun", [False, True], ids=["per_ray", "sun"])
def test_heightfield_occluded_matches_jax(demo, rays, sun):
    """The terrain march alone: per-ray directions and lengths, or one
    direction for all (a sun: scalar direction, max_t 1e4 past the far
    clamp)."""
    _, _, _, hf, static, _ = _tables(demo[0])
    (wx, wy, wz), (dx, dy, dz), max_t = _planes(rays)
    if sun:
        dx, dy, dz = (np.float32(v) for v in (0.4, 0.6, -0.2))
        max_t = 1e4
    j = lambda a: jnp.asarray(a)
    want = np.asarray(j_material.heightfield_occluded(
        j(hf), static, j(wx), j(wy), j(wz), j(dx), j(dy), j(dz),
        max_t if sun else j(max_t)))
    t = torch.as_tensor
    got = t_material.heightfield_occluded(
        t(hf), static, t(wx), t(wy), t(wz), t(dx), t(dy), t(dz),
        max_t if sun else t(max_t)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


# --------------------------------------------------------------------------
# Frames: the fused frame on the terrain, the volume phase's branches
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terrain_frames():
    """JAX's and the port's two fused frames (FULL_CONFIG's knobs,
    heightfield_local_shadows) on the cheap-terrain demo scene with a
    higher terrain (amp 4), the camera moving between them."""
    base = cheap_terrain(j_demo(aspect=128 / 90), hf_amp=4.0)
    scenes = [dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, position=jnp.asarray(p, jnp.float32),
        forward=jnp.asarray(f, jnp.float32) / np.linalg.norm(f)))
        for p, f in CAMERAS]
    kw = dict(SMALL, heightfield_local_shadows=True)
    jr = JRenderer(dataclasses.replace(J_FULL, **kw))
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
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **kw),
                               device="cpu")
    ts = tr.init_state(1)
    t_imgs = []
    for i, (sc, (c, d)) in enumerate(zip(scenes, gbuffers)):
        img, _, ts = tr.render_frame(ts, scene_from_numpy(sc, "cpu"),
                                     np.float32(0.1 * i), torch.as_tensor(c),
                                     torch.as_tensor(d))
        t_imgs.append(img.numpy())
    t_state = (t_packed(ts.prev_accumulation).numpy(),
               ts.prev_shadow.numpy())
    return tr, j_imgs, j_state, t_imgs, t_state


@pytest.mark.parametrize("i", [0, 1])
def test_terrain_frame_matches_jax(terrain_frames, i):
    tr, j_imgs, _, t_imgs, _ = terrain_frames
    assert tr.fuses_frame() and composite_route(tr.config) == "pixels"
    a, b = t_imgs[i], j_imgs[i]
    assert a.shape == b.shape == (90, 128, 4)
    assert_boundary_close(a, b, f"image {i}")
    assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()


def test_terrain_state_matches_jax(terrain_frames):
    _, _, (j_acc, j_sh), _, (t_acc, t_sh) = terrain_frames
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")


def _box_opacity_scene(frac: bool):
    """tests/test_box_opacity.py's scene: three boxes, two of them at
    opacity 0.6 and 0.9 when frac, a sun and two local lights."""
    from volumetricrenderer_tpu import (Camera, DirectionalLights, Medium,
                                        PointLights, Scene, SpotLights)
    op = 0.6 if frac else 1.0
    geom = JGeometry.create(
        planes=[((0.1, 1.0, 0.05), -0.2, (0.2, 0.2, 0.2))],
        spheres=[((0.5, 2.0, 3.0), 1.1, (0.5, 0.5, 0.5))],
        boxes=[((-3.0, 0.0, 1.0), (-1.0, 2.5, 3.0), (0.4, 0.4, 0.4), op),
               ((-2.0, 1.0, 0.0), (0.5, 3.5, 2.0), (0.4, 0.4, 0.4),
                0.9 if frac else 1.0),
               ((1.0, 0.0, 4.0), (2.0, 1.0, 5.0), (0.4, 0.4, 0.4))])
    return Scene.create(
        camera=Camera.create(position=(0.0, 1.5, -6.0),
                             forward=(0.0, 0.0, 1.0), aspect=1.5),
        dir_lights=DirectionalLights.create(
            direction=[(0.3, -1.0, 0.2)], color=[(1.0, 0.95, 0.9)],
            intensity=[2.0], has_shadow=[True]),
        point_lights=PointLights.create(
            position=[(-1.0, 4.0, 2.0)], color=[(1.0, 0.6, 0.3)],
            intensity=[5.0], range=[12.0], has_shadow=[True]),
        spot_lights=SpotLights.create(
            position=[(1.5, 5.0, 1.0)], direction=[(-0.2, -1.0, 0.3)],
            color=[(0.3, 0.6, 1.0)], intensity=[6.0], range=[14.0],
            spot_angle_deg=[70.0], has_shadow=[True]),
        media=(Medium.create(phase_g=0.3, noise_mode="procedural",
                             noise_tiling=(0.05, 0.05, 0.05)),),
        geometry=geom)


@pytest.fixture(scope="module")
def volume_scenes():
    terrain = cheap_terrain(j_demo(aspect=1.5), hf_amp=4.0)
    return {"terrain": terrain, "fractional": _box_opacity_scene(True),
            "fractional_terrain": fractional(terrain)}


def run_volume(js, ss, local):
    """(JAX, port) fused volume phase, radiance bake at ss: (shadow
    [1, D, H, W], accumulation [4, D, H, W]); random histories, a moved
    previous camera."""
    ts = scene_from_numpy(js, "cpu")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        cam.position + jnp.asarray([0.3, -0.1, 0.3]),
        jnp.asarray([0.05, -0.02, 1.0]), jnp.asarray([0.0, 1.0, 0.0])))
    rng = np.random.default_rng(7)
    w, h, d = GRID
    prev_sh = rng.uniform(0, 1, (1, d, h, w)).astype(np.float32)
    prev_acc = rng.uniform(0, 1, (4, d, h, w)).astype(np.float32)
    kw = dict(vis_ss=ss, vis_radiance=True, bake_noise=True,
              inline_vis_bake=True, heightfield_shadows=local)
    j_sh, j_acc = j_frame_volume_fused(
        jp, cam.view_to_world(), jprev, jnp.asarray(JIT), jnp.float32(ALPHA),
        js.dir_lights, js.point_lights, js.spot_lights, js.geometry,
        js.media, 0.3, cam.position, jnp.asarray(prev_sh),
        tuple(jnp.asarray(p) for p in prev_acc), GRID, K, interpret=True,
        **kw)
    t_sh, t_acc = t_ff.frame_volume_fused(
        tp, ts.camera.view_to_world(), torch.as_tensor(np.array(jprev)), JIT,
        ALPHA, ts.dir_lights, ts.point_lights, ts.spot_lights, ts.geometry,
        ts.media, 0.3, ts.camera.position, torch.as_tensor(prev_sh),
        torch.as_tensor(prev_acc), GRID, K, **kw)
    return (np.asarray(j_sh), np.stack([np.asarray(a) for a in j_acc])), \
        (t_sh.numpy(), t_acc.numpy())


@pytest.mark.parametrize("scene,local", [("terrain", False),
                                         ("terrain", True),
                                         ("fractional", False),
                                         ("fractional_terrain", True)])
def test_volume_phase_matches_megakernel(volume_scenes, scene, local):
    """K1's, K2's and K3's twins against JAX frame_volume_fused: the sun's
    rays always march the terrain, the local lights' only with
    heightfield_shadows; fractional boxes shadow by their opacity."""
    (j_sh, j_acc), (t_sh, t_acc) = run_volume(volume_scenes[scene], 2,
                                              local)
    assert_boundary_close(t_sh, j_sh, f"shadow, {scene}")
    for c in range(4):
        assert_boundary_close(t_acc[c], j_acc[c], f"acc c={c}, {scene}")
    assert np.abs(t_acc[:3]).max() > 0.0


def test_terrain_and_opacity_change_the_volume(volume_scenes):
    """The arms are live: the local terrain changes the radiance bake, the
    terrain the sun's shadow, and the fractional boxes let light through
    where solid ones do not."""
    js = volume_scenes["terrain"]
    ts = scene_from_numpy(js, "cpu")
    cam = ts.camera
    tp = tfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)

    def tables(scene, local):
        return t_ff.frame_tables(
            tp, scene.camera.view_to_world(), torch.eye(4), JIT, 0.5,
            scene.dir_lights, scene.point_lights, scene.spot_lights,
            scene.geometry, scene.media, 0.3, scene.camera.position, GRID, K,
            2, True, light_schedule=False, heightfield_local=local)

    off, on = tables(ts, False), tables(ts, True)
    assert (t_ff.bake_radiance_plain(on)
            != t_ff.bake_radiance_plain(off)).any()
    no_hf = dataclasses.replace(off, hf_static=None)
    assert (t_dir_shadow.dir_shadow_plain(off)
            != t_dir_shadow.dir_shadow_plain(no_hf)).any()
    solid = scene_from_numpy(_box_opacity_scene(False), "cpu")
    frac = scene_from_numpy(_box_opacity_scene(True), "cpu")
    sh = [t_dir_shadow.dir_shadow_plain(tables(s, False))
          for s in (solid, frac)]
    partly = (sh[1] > 0.0) & (sh[1] < 1.0)
    assert partly.any() and (sh[1] >= sh[0]).all() and (sh[1] > sh[0]).any()


# --------------------------------------------------------------------------
# The composites of any pixel/froxel ratio
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl,size,route", [
    ("zgather", (90, 128), "pixels"),     # ineligible, 90/11: rowmm
    ("rowmm", (88, 128), "pixels"),       # rowmm at integer ratios too
    ("zgather", (90, 120), "pixels"),     # 120/16: anyres
    ("xla", (90, 128), "pixels"),         # the per-pixel gather
    ("tentmm", (88, 128), "cells")],      # integer ratios: the cells
    ids=["rowmm", "rowmm_integer", "anyres", "xla", "tentmm"])
def test_composite_matches_jax(demo, impl, size, route):
    """composite_frame against JAX pipeline.composite on random
    accumulation, scene colour and depths past both ends of the volume."""
    ih, iw = size
    kw = dict(SMALL, composite_impl=impl, image_height=ih, image_width=iw)
    cfg = dataclasses.replace(J_FULL, **kw)
    tcfg = dataclasses.replace(vt.FULL_CONFIG, **kw)
    assert composite_route(tcfg) == route
    w, h, d = cfg.grid
    rng = np.random.default_rng(5)
    acc = rng.uniform(0, 1, (d, h, w, 4)).astype(np.float32)
    scene = rng.uniform(0, 1, (ih, iw, 3)).astype(np.float32)
    depth = rng.uniform(0.05, 140.0, (ih, iw)).astype(np.float32)
    js, ts = demo
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near,
                                    cfg.volume_distance,
                                    cfg.depth_distribution, cfg.grid)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, cfg.volume_distance,
                                    cfg.depth_distribution, cfg.grid)
    want = np.asarray(jpipeline.composite(
        cfg, jp, jnp.asarray(acc), jnp.asarray(scene), jnp.asarray(depth)))
    got = t_zg.composite_frame(tcfg, torch.as_tensor(acc).permute(
        3, 0, 1, 2).contiguous(), torch.as_tensor(scene),
        torch.as_tensor(depth), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_pixel_form_equals_the_cells_at_integer_ratios(demo):
    """At 8x8-pixel cells the per-pixel form computes the cell form's
    trilinear: the same taps, weights within an ulp (float32 products of
    float64 one-axis weights, where the cells hold float64 products)."""
    w, h, d = 16, 11, 12
    rng = np.random.default_rng(9)
    acc = torch.as_tensor(rng.uniform(0, 1, (4, d, h, w)).astype(np.float32))
    scene = torch.as_tensor(rng.uniform(0, 1, (88, 128, 3)).astype(
        np.float32))
    depth = torch.as_tensor(rng.uniform(0.05, 140.0, (88, 128)).astype(
        np.float32))
    cam = demo[1].camera
    tp = tfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 100.0,
                                    0.5, (w, h, d))
    a = t_zg.composite_pixels(acc, scene, depth, tp, (w, h, d))
    b = t_zg.composite(acc, scene, depth, tp, (w, h, d))
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    k0, wt = t_zg.pixel_taps(90, 11)
    assert k0[0] == -1 and k0[-1] == 10 and np.all(wt.sum(0) == 1.0)


# --------------------------------------------------------------------------
# The plain passes that cast rays see the terrain
# --------------------------------------------------------------------------

def test_plain_passes_see_the_terrain(demo):
    """The "xla" shadow volume (raycast.occluded) equals K7's twin on the
    terrain, and the sun's shadow-map bake (raycast.intersect) changes with
    it, as in JAX, where the G-buffer and the map bakes always see the
    heightfield."""
    ts = demo[1]
    ts = dataclasses.replace(ts, geometry=dataclasses.replace(
        ts.geometry, hf_steps=4, hf_octaves=1))
    cfg = dataclasses.replace(vt.FULL_CONFIG, **SMALL,
                              frame_fused=False, dir_shadow_impl="xla")
    r = vt.VolumetricRenderer(cfg, device="cpu")
    state = r.init_state(1)
    tables, params, w2v = r.frame_tables(state, ts, 0.0)
    geo, scene_dev = r.frame_geometry(state, ts, tables, params, w2v)
    plain = tpipeline.write_shadow_volume_dir(
        cfg, tables, geo, scene_dev.dir_lights, scene_dev.geometry)
    assert_boundary_close(plain.numpy(),
                          t_dir_shadow.dir_shadow_plain(tables).numpy(),
                          "xla shadow volume")
    flat = dataclasses.replace(ts.geometry, hf_enabled=False)
    cam = ts.camera
    bakes = [tshadow.bake_dir_shadows(
        g, ts.dir_lights.direction, ts.dir_lights.shadow_strength,
        cam.position, cam.forward, cam.fov_y, cam.aspect, cam.near, 100.0,
        cfg.cascade_splits, 32) for g in (ts.geometry, flat)]
    assert not torch.equal(bakes[0].atlas, bakes[1].atlas)
