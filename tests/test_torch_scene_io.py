"""Scene files, SceneBuilder, the debug helpers and the demo entry of the
port against the JAX package.

- io/scene_io: a file the JAX package saves (the mesh scene with its
  TriMesh, benchmark_scene, demo_scene with a noise texture; with a post
  profile) loads in the port equal, field by field and bit for bit, to
  convert.scene_from_numpy of the same scene; a file the port saves loads
  in JAX equal field by field; the authored dialect gives equal scenes in
  both; unknown scene and post keys and light lists that disagree on a
  required key raise as tests/test_scene_io.py holds JAX's;
- models/builder.SceneBuilder: the same registrations and removals give
  equal scenes;
- utils/debug: volume_slice, debug_composite and channel_stats equal JAX's,
  and save_png writes the same bytes;
- render_debug_slice against JAX's on tests/test_animation_debug.py's scene
  (16x12x8 froxels at 32x24, raycast shadows), both renderers reading JAX's
  G-buffer: tests/torch_tolerance.py's class;
- the demo entry (python -m volumetricrenderer_tpu_torch.demo): without
  CUDA it exits 2 unless given --device cpu; --dump-scene writes the file
  save_scene writes, which JAX's load_scene reads.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import Camera as JCamera
from volumetricrenderer_tpu import DirectionalLights as JDirectionalLights
from volumetricrenderer_tpu import Geometry as JGeometry
from volumetricrenderer_tpu import Medium as JMedium
from volumetricrenderer_tpu import RenderConfig as JRenderConfig
from volumetricrenderer_tpu import Scene as JScene
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu.io import scene_io as j_io
from volumetricrenderer_tpu.models.builder import SceneBuilder as JBuilder
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo
from volumetricrenderer_tpu.post import PostConfig as JPostConfig
from volumetricrenderer_tpu.utils import debug as j_debug

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch import demo as t_demo
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.io import scene_io as t_io
from volumetricrenderer_tpu_torch.models.builder import SceneBuilder
from volumetricrenderer_tpu_torch.post import PostConfig
from volumetricrenderer_tpu_torch.utils import debug as t_debug

from torch_tolerance import assert_boundary_close

POST = dict(exposure=1.2, bloom_strength=0.3, fxaa=True, dithering=True,
            lens_distortion=12.0, grade_lift=(0.02, 0.0, -0.01),
            auto_exposure=True,
            grade_luts=((0.0, 0.25, 0.6, 1.0), (0.0, 0.5, 1.0)))


def _walk(a, b, path=""):
    """Port object a against port object b, field by field, bit for bit."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _walk(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _walk(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _walk_jax(t, j, path=""):
    """Port object t against JAX object j, field by field, bit for bit."""
    if isinstance(t, torch.Tensor):
        a, b = t.numpy(), np.asarray(j)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(t):
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)], path
        for f in dataclasses.fields(t):
            _walk_jax(getattr(t, f.name), getattr(j, f.name),
                      f"{path}.{f.name}")
    elif isinstance(t, tuple):
        assert len(t) == len(j), path
        for i, (x, y) in enumerate(zip(t, j)):
            _walk_jax(x, y, f"{path}[{i}]")
    else:
        assert t == j and (t is None) == (j is None), (path, t, j)


def _scenes():
    tex = np.random.default_rng(3).random((4, 8, 16), dtype=np.float32)
    return {"demo_mesh": lambda: j_demo(mesh_env=True),
            "benchmark": lambda: j_bench(num_local_lights=4,
                                         noise_mode="procedural"),
            "demo_noise": lambda: j_demo(with_noise=True, noise_tex=tex)}


# --------------------------------------------------------------------------
# io/scene_io
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(_scenes()))
def test_jax_file_loads_in_port(name, tmp_path):
    js = _scenes()[name]()
    path = str(tmp_path / "scene.json")
    j_io.save_scene(path, js, post_cfg=JPostConfig(**POST))
    scene, post = t_io.load_scene(path, with_post=True, device="cpu")
    _walk(scene, scene_from_numpy(js, "cpu"))
    assert post == PostConfig(**POST)
    _walk(t_io.load_scene(path, device="cpu"), scene)
    if name == "demo_mesh":
        assert scene.mesh.tris.dtype == torch.int32
        assert scene.geometry.n_proxy_boxes == 20


@pytest.mark.parametrize("name", list(_scenes()))
def test_port_file_loads_in_jax(name, tmp_path):
    js = _scenes()[name]()
    ts = scene_from_numpy(js, "cpu")
    path = str(tmp_path / "scene.json")
    t_io.save_scene(path, ts, post_cfg=PostConfig(**POST))
    loaded, post = j_io.load_scene(path, with_post=True)
    _walk_jax(ts, loaded)
    _walk_jax(ts, js)
    assert post == JPostConfig(**POST)
    # the same document, key for key
    assert json.dumps(t_io.scene_to_dict(ts)) == json.dumps(
        j_io.scene_to_dict(js))


AUTHORED = {
    "minimal": {
        "camera": {"position": (0, 2, -10), "forward": (0, 0, 1),
                   "fov_y_deg": 60.0, "aspect": 16 / 9},
        "dir_lights": [{"direction": (0.3, -0.7, 0.5),
                        "color": (1.0, 0.9, 0.8), "intensity": 2.0}],
        "spot_lights": [{"position": (0, 5, 0), "direction": (0, -1, 0),
                         "color": (1, 0, 0), "intensity": 6.0,
                         "range": 30.0, "spot_angle_deg": 60.0}],
        "media": [{"absorption": 0.19, "phase_g": 0.3}],
        "geometry": {"planes": [((0, 1, 0), 0.0, (0.2, 0.25, 0.2))],
                     "spheres": [((0, 1, 5), 1.0, (0.5, 0.5, 0.5))],
                     "boxes": [((-1, 0, 2), (1, 2, 3), (0.4, 0.4, 0.4),
                                0.5)],
                     "n_proxy_boxes": 1},
        "ambient": (0.05, 0.05, 0.06),
    },
    "optional_keys": {
        "camera": {"position": (0, 2, -10), "forward": (0, 0, 1),
                   "aspect": 16 / 9},
        "dir_lights": [
            {"direction": (0.3, -0.7, 0.5), "color": (1, 1, 1),
             "intensity": 2.0, "has_shadow": False},
            {"direction": (0, -1, 0), "color": (1, 1, 1),
             "intensity": 1.0}],
        "point_lights": [
            {"position": (0, 5, 0), "color": (1, 0, 0), "intensity": 7.0,
             "range": 50.0, "has_shadow": True, "shadow_strength": 0.5},
            {"position": (3, 5, 0), "color": (0, 1, 0), "intensity": 7.0,
             "range": 50.0}],
        "media": [{"absorption": 0.19, "phase_g": 0.3,
                   "volume_type": "box", "box_min": (-5, 0, -5),
                   "box_max": (5, 3, 5)}],
        "mesh": {"verts": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                 "tris": [[0, 1, 2]], "albedo": [[0.5, 0.4, 0.3]]},
    },
}


@pytest.mark.parametrize("name", list(AUTHORED))
def test_authored_dialect_matches_jax(name):
    d = json.loads(json.dumps(AUTHORED[name]))
    ts, js = t_io.scene_from_dict(d, device="cpu"), j_io.scene_from_dict(d)
    _walk_jax(ts, js)
    # re-serialized in the exact dialect, it loads back bit for bit
    _walk(t_io.scene_from_dict(t_io.scene_to_dict(ts), device="cpu"), ts)


def test_scene_io_errors_match_jax():
    with pytest.raises(ValueError, match="unknown scene keys"):
        t_io.scene_from_dict({"camera": {}, "tpyo": 1}, device="cpu")
    with pytest.raises(ValueError, match="unknown post keys"):
        t_io.post_from_dict({"explosure": 2.0})
    bad = {"camera": AUTHORED["minimal"]["camera"],
           "point_lights": [{"position": (0, 5, 0), "color": (1, 0, 0),
                             "intensity": 7.0, "range": 50.0},
                            {"position": (3, 5, 0), "color": (0, 1, 0),
                             "intensity": 7.0}]}
    for load in (lambda: t_io.scene_from_dict(bad, device="cpu"),
                 lambda: j_io.scene_from_dict(bad)):
        with pytest.raises(ValueError, match="required key 'range'"):
            load()
    assert t_io.post_to_dict(PostConfig(**POST)) == j_io.post_to_dict(
        JPostConfig(**POST))


# --------------------------------------------------------------------------
# SceneBuilder
# --------------------------------------------------------------------------

def _register(b, medium):
    """One sequence of registrations and removals, on either package's
    builder; `medium` builds a Medium from create() arguments."""
    sun = b.add_directional_light((0.3, -0.7, 0.5), (1, 1, 1), 2.0)
    b.add_directional_light((0.0, -1.0, 0.2), (1, 0.9, 0.8), 1.0,
                            has_shadow=False, shadow_strength=0.5)
    p1 = b.add_point_light((0, 3, 0), (1, 0, 0), 5.0, 20.0)
    b.add_point_light((2, 3, 0), (0, 1, 0), 5.0, 20.0, has_shadow=True)
    b.add_spot_light((0, 5, 0), (0, -1, 0), (1, 1, 0), 6.0, 30.0, 60.0,
                     inner_angle_percent=0.3)
    m1 = b.add_medium(medium(absorption=0.3))
    b.add_medium(medium(phase_g=0.5, volume_type="box",
                        box_min=(-1, 0, -1), box_max=(1, 2, 1)))
    b.add_plane((0, 1, 0), 0.0)
    s1 = b.add_sphere((0, 1, 5), 1.0, (0.6, 0.5, 0.4))
    b.add_sphere((3, 1, 5), 0.5)
    b.add_box((0, 0, 0), (1, 1, 1))
    b.remove_light(p1)
    b.remove_light(sun)
    b.remove_medium(m1)
    b.remove_geometry(s1)
    return b.build()


def test_scene_builder_matches_jax():
    cam = dict(position=(0, 2, -10), forward=(0, 0.1, 1), aspect=32 / 24)
    js = _register(JBuilder(JCamera.create(**cam), ambient=(0.1, 0.1, 0.1)),
                   JMedium.create)
    ts = _register(SceneBuilder(vt.Camera.create(**cam, device="cpu"),
                                ambient=(0.1, 0.1, 0.1)),
                   lambda **kw: vt.Medium.create(**kw, device="cpu"))
    _walk_jax(ts, js)
    assert ts.dir_lights.count == 1 and ts.point_lights.count == 1
    empty_t = SceneBuilder(vt.Camera.create(**cam, device="cpu")).build()
    _walk_jax(empty_t, JBuilder(JCamera.create(**cam)).build())


# --------------------------------------------------------------------------
# utils/debug and render_debug_slice
# --------------------------------------------------------------------------

def test_debug_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    vol = rng.random((8, 6, 10, 4), dtype=np.float32)
    color = rng.random((24, 40, 3), dtype=np.float32)
    for z in (0, 3, 7):
        sl_t = t_debug.volume_slice(torch.as_tensor(vol), z)
        sl_j = j_debug.volume_slice(jnp.asarray(vol), z)
        np.testing.assert_array_equal(sl_t.numpy(), np.asarray(sl_j))
        for shape in ((24, 40), (13, 17)):
            c = color[:shape[0], :shape[1]]
            np.testing.assert_array_equal(
                t_debug.debug_composite(torch.as_tensor(c), sl_t).numpy(),
                np.asarray(j_debug.debug_composite(jnp.asarray(c), sl_j)))
    vol[1, 2, 3, 0] = np.nan
    for v in (vol, vol[:, :, :, 1:]):     # with and without a NaN (json:
        # NaN == NaN there)
        assert json.dumps(t_debug.channel_stats(
            {"acc": torch.as_tensor(v)})) == json.dumps(
                j_debug.channel_stats({"acc": jnp.asarray(v)}))
    img = rng.random((9, 14, 3), dtype=np.float32) * 1.2 - 0.1
    t_debug.save_png(str(tmp_path / "t.png"), torch.as_tensor(img))
    j_debug.save_png(str(tmp_path / "j.png"), jnp.asarray(img))
    assert (tmp_path / "t.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


DEBUG_CFG = dict(volume_width=16, volume_height=12, volume_depth=8,
                 image_width=32, image_height=24, shadow_map_size=32,
                 shadow_mode="raycast")


def _debug_scene():
    return JScene.create(
        camera=JCamera.create(position=(0, 2, -10), forward=(0, 0, 1),
                              aspect=32 / 24),
        dir_lights=JDirectionalLights.create(
            direction=[(0.3, -0.7, 0.5)], color=[(1, 1, 1)],
            intensity=[2.0], has_shadow=[False]),
        media=(JMedium.create(),),
        geometry=JGeometry.create(
            planes=[((0, 1, 0), 0.0, (0.2, 0.2, 0.2))]))


@pytest.mark.parametrize("volume", ["accumulation", "shadow"])
def test_render_debug_slice_matches_jax(volume, monkeypatch):
    js = _debug_scene()
    jr = JRenderer(JRenderConfig(**DEBUG_CFG))
    c, d = (np.array(a) for a in jax.jit(jr.render_scene_inputs)(js))
    # both renderers read JAX's G-buffer (ROADMAP C3)
    monkeypatch.setattr(jr, "render_scene_inputs",
                        lambda scene: (jnp.asarray(c), jnp.asarray(d)))
    want = np.asarray(jax.jit(lambda s, sc: jr.render_debug_slice(
        s, sc, 4, volume))(jr.init_state(1), js))
    tr = vt.VolumetricRenderer(vt.RenderConfig(**DEBUG_CFG), device="cpu")
    monkeypatch.setattr(tr, "render_scene_inputs", lambda scene: (
        torch.as_tensor(c), torch.as_tensor(d)))
    got = tr.render_debug_slice(tr.init_state(1), scene_from_numpy(js, "cpu"),
                                4, volume).numpy()
    assert got.shape == want.shape == (24, 32, 3)
    assert_boundary_close(got, want, f"debug slice of {volume}")


# --------------------------------------------------------------------------
# The demo entry
# --------------------------------------------------------------------------

def test_demo_without_cuda_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_demo.main(["--frames", "1", "--out", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


def test_demo_dump_scene(tmp_path):
    path = tmp_path / "mesh.json"
    assert t_demo.main(["--mesh-env", "--device", "cpu", "--dump-scene",
                        str(path)]) == 0
    ts = vt.demo_scene(aspect=1280 / 720, mesh_env=True, device="cpu")
    _walk(t_io.load_scene(str(path), device="cpu"), ts)
    _walk_jax(ts, j_io.load_scene(str(path)))
    small = t_demo.demo_config(t_demo.parse_args(["--small", "--production"]))
    assert (small.volume_width, small.image_width, small.shadow_mode,
            small.composite_impl) == (80, 480, "raycast", "zgather")
    assert vt.VolumetricRenderer(small, device="cpu").fuses_frame(ts)


def test_demo_orbit():
    s = vt.demo_scene(device="cpu")
    assert torch.equal(t_demo.orbit(s, 0).camera.position,
                       s.camera.position)
    p = t_demo.orbit(s, 10).camera.position
    np.testing.assert_allclose(
        p.numpy(), [-0.4 + 4.0 * math.sin(0.4), 1.9,
                    -15.8 + 2.0 * (1 - math.cos(0.4))], rtol=1e-6)
