"""Mesh environments in the port against the JAX package: the tree mesh,
its ingestion (FBX, voxelization, the native core), the rasterized
G-buffer and a frame on demo_scene(mesh_env=True).

- TriMesh, concat_meshes, transform_mesh and procedural_tree: bit for bit;
  tree_assets and transform_boxes: exactly equal;
- voxelize_triangles and mesh_to_boxes on procedural_tree: the port's numpy
  version = the port's native core (native/ingest.cpp) = JAX's numpy
  version, exactly (box opacities as float32, as tests/test_native_ingest.py
  holds JAX's pair); a failed native build raises;
- the FBX parser on a small binary FBX written here (one array deflated
  with zlib, a quad fanned into triangles): equal to JAX's load_fbx_meshes;
- rasterize_mesh against JAX's run op by op under jax.disable_jit(), bit
  for bit, on tests/test_raster.py's small cases (a facing triangle, the
  nearer of two triangles, both windings, triangles behind the camera, a
  seeded fuzz of 8 triangles), the camera at the origin looking +z. Both
  read one tan(fov/2): XLA's CPU tan and torch's differ in the last ulp on
  ~5% of arguments, 60 degrees among them (ROADMAP C3), so JAX's jnp.tan
  is patched to torch's for these cases;
- on the mesh scene, against JAX's jitted raster at 160x90 with the camera
  TREE_CAMERA, which puts the trees on at least 10% of the pixels: depth
  within 1e-6 relative where both cover, at most 1e-3 of the pixels
  flipped at a triangle edge (XLA contracts multiply-adds under jit); the
  port's image is the same bit for bit at chunk 8 and at its card chunk;
- render_scene_inputs on demo_scene(mesh_env=True) at TREE_CAMERA, 64x36,
  at ROADMAP C3's class (depth 1e-4 relative, colour 2e-3, 1e-5 on at
  least 98% of the pixels);
- two frames of the plain-XLA raycast route (DEMO_CONFIG with
  shadow_mode="raycast", 16x12x8 froxels at 64x36) on the mesh scene with
  tests/test_torch_terrain.py's cheap terrain, both renderers fed JAX's
  G-buffer: images and histories at tests/torch_tolerance.py's class; the
  proxies' fractional shadow reaches the fog.
"""

import dataclasses
import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import DEMO_CONFIG as J_DEMO
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu.io import fbx as j_fbx
from volumetricrenderer_tpu.models import mesh as j_mesh
from volumetricrenderer_tpu.models import tree_assets as j_trees
from volumetricrenderer_tpu.models import voxelize as j_vox
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import demo_scene as j_demo
from volumetricrenderer_tpu.ops import raster as j_raster
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.convert import (mesh_from_numpy,
                                                  scene_from_numpy)
from volumetricrenderer_tpu_torch.io import fbx as t_fbx
from volumetricrenderer_tpu_torch.io import native as t_native
from volumetricrenderer_tpu_torch.models import mesh as t_mesh
from volumetricrenderer_tpu_torch.models import tree_assets as t_trees
from volumetricrenderer_tpu_torch.models import voxelize as t_vox
from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.ops import raster as t_raster
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

# a camera 4.5 m in front of the tree at (7, 9): the trees cover ~11% of
# the pixels (at demo_scene's own camera, 14 of 2304 pixels at 64x36)
TREE_CAMERA = ((6.0, 2.0, 4.5), (0.1, 0.05, 1.0))


def _np(a):
    return np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def _mesh_equal(t, j):
    for name, dt in (("verts", np.float32), ("tris", np.int32),
                     ("albedo", np.float32)):
        a, b = _np(getattr(t, name)), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype == dt, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _camera(jc) -> Camera:
    return Camera(**{f.name: torch.as_tensor(np.array(getattr(jc, f.name)))
                     for f in dataclasses.fields(jc)})


def _tree_scene(jscene, w, h):
    pos, fwd = TREE_CAMERA
    return dataclasses.replace(jscene, camera=JCamera.create(
        position=pos, forward=fwd, aspect=w / h, near=0.3, far=100.0))


# --------------------------------------------------------------------------
# TriMesh, trees, proxies
# --------------------------------------------------------------------------

def test_trimesh_and_procedural_tree_match_jax():
    for h in (6.0, 7.0):
        _mesh_equal(t_mesh.procedural_tree(height=h, device="cpu"),
                    j_mesh.procedural_tree(height=h))
    kw = dict(verts=[(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)],
              tris=[(0, 1, 2), (0, 2, 3)], albedo=(0.5, 0.4, 0.3))
    tm, jm = t_mesh.TriMesh.create(**kw, device="cpu"), j_mesh.TriMesh.create(
        **kw)
    _mesh_equal(tm, jm)
    assert tm.num_tris == jm.num_tris == 2
    # demo_tree without the reference checkout is the procedural tree
    for i in (0, 1):
        _mesh_equal(t_mesh.demo_tree(i, ref_root="missing", device="cpu"),
                    j_mesh.demo_tree(i, ref_root="missing"))


def test_transform_and_concat_match_jax():
    insts_t, insts_j = [], []
    for i, (x, z) in enumerate([(-9.0, 18.0), (7.0, 9.0), (-14.0, 25.0),
                                (3.5, -2.25)]):
        kw = dict(scale=0.55 if i % 2 else 0.5, translate=(x, 0.1 * i, z),
                  yaw=i * math.pi / 2 + (0.3 if i == 3 else 0.0))
        insts_t.append(t_mesh.transform_mesh(
            t_mesh.procedural_tree(6.0 + i % 2, device="cpu"), **kw))
        insts_j.append(j_mesh.transform_mesh(
            j_mesh.procedural_tree(6.0 + i % 2), **kw))
        _mesh_equal(insts_t[-1], insts_j[-1])
    _mesh_equal(t_mesh.concat_meshes(insts_t), j_mesh.concat_meshes(insts_j))


def test_tree_assets_and_transform_boxes_match_jax():
    assert t_trees.TREE_0 == j_trees.TREE_0
    assert t_trees.TREE_1 == j_trees.TREE_1
    for src, kw in ((t_trees.TREE_0, dict(scale=0.5, translate=(-9, 0, 18))),
                    (t_trees.TREE_1, dict(scale=0.55, translate=(7, 0, 9),
                                          yaw=math.pi / 2)),
                    (t_trees.TREE_0, dict(scale=0.5, translate=(-14, 0, 25),
                                          yaw=math.pi)),
                    (t_trees.TREE_1, dict(scale=1.3, yaw=0.4))):
        got, want = (t_vox.transform_boxes(src, **kw),
                     j_vox.transform_boxes(src, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[0], w[0])
            np.testing.assert_array_equal(g[1], w[1])
            assert g[2:] == w[2:]


# --------------------------------------------------------------------------
# Voxelization, the native core, FBX
# --------------------------------------------------------------------------

def _tree_soup():
    tree = j_mesh.procedural_tree(height=6.0)
    return np.asarray(tree.verts, np.float32), np.asarray(tree.tris,
                                                          np.int32)


def test_voxelize_numpy_native_and_jax_agree():
    verts, tris = _tree_soup()
    want = j_vox.voxelize_triangles(verts, tris, res=20)
    for impl in ("numpy", "native"):
        got = t_native.voxelize_triangles(verts, tris, res=20, impl=impl)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype, impl
            np.testing.assert_array_equal(g, w, err_msg=impl)
    np.testing.assert_array_equal(t_vox.voxelize_triangles(verts, tris,
                                                           20)[0], want[0])


def test_mesh_to_boxes_numpy_native_and_jax_agree():
    verts, tris = _tree_soup()
    want = j_vox.mesh_to_boxes(verts, tris, res=20, max_boxes=8)
    assert len(want) > 0
    for impl in ("numpy", "native"):
        got = t_native.mesh_to_boxes(verts, tris, res=20, max_boxes=8,
                                     impl=impl)
        assert len(got) == len(want), impl
        # the numpy version's corners are float64, the native core's
        # float32 (tests/test_native_ingest.py)
        cast = (lambda a: a) if impl == "numpy" \
            else (lambda a: np.asarray(a, np.float32))
        for (g0, g1, go), (w0, w1, wo) in zip(got, want):
            for g, w in ((g0, w0), (g1, w1)):
                assert g.dtype == cast(w).dtype
                np.testing.assert_array_equal(g, cast(w), err_msg=impl)
            assert go == float(cast(wo)), (impl, go, wo)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails raises with its message; nothing falls back to
    numpy unless impl="numpy" asks for it."""
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "CXX_FLAGS",
                        t_native.CXX_FLAGS + ("-DVR_NO_SUCH", "-include",
                                              "no_such_header.h"))
    verts, tris = _tree_soup()
    with pytest.raises(RuntimeError, match="no_such_header"):
        t_native.mesh_to_boxes(verts, tris)
    monkeypatch.setattr(t_native, "CXX", str(tmp_path / "no-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        t_native.voxelize_triangles(verts, tris)
    assert list(tmp_path.iterdir()) == []
    assert len(t_native.mesh_to_boxes(verts, tris, impl="numpy")) > 0
    with pytest.raises(ValueError):
        t_native.mesh_to_boxes(verts, tris, impl="fast")


def _fbx_node(start, name, props, children=()):
    """One binary FBX node record (version 7400: 32-bit offsets) starting
    at file offset `start`, with its children and their null record."""
    pb = b""
    for code, value in props:
        if code in "dil":
            arr = np.asarray(value, {"d": "<f8", "i": "<i4", "l": "<i8"}[
                code])
            raw, enc = arr.tobytes(), 0
            if code == "i":                      # deflate the index arrays
                raw, enc = zlib.compress(raw), 1
            pb += code.encode() + struct.pack("<III", arr.size, enc,
                                              len(raw)) + raw
        elif code == "S":
            pb += b"S" + struct.pack("<I", len(value)) + value.encode()
        else:                                    # "L"
            pb += b"L" + struct.pack("<q", value)
    pos = start + 13 + len(name) + len(pb)
    body = b""
    for c in children:
        cb = _fbx_node(pos, *c)
        body += cb
        pos += len(cb)
    if children:
        body += b"\x00" * 13
        pos += 13
    return (struct.pack("<III", pos, len(props), len(pb))
            + bytes([len(name)]) + name.encode() + pb + body)


def test_fbx_parser_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    v1 = rng.normal(size=(5, 3))
    v2 = rng.normal(size=(4, 3)) * 3.0
    geos = [("Geometry", [("L", 11), ("S", "tree\x00\x01Geometry"),
                          ("S", "Mesh")],
             [("Vertices", [("d", v1.ravel())]),
              # a quad (fanned into 2 triangles), then a triangle
              ("PolygonVertexIndex", [("i", [0, 1, 2, ~3, 2, 3, ~4])])]),
            ("Geometry", [("L", 12)],
             [("Vertices", [("d", v2.ravel())]),
              ("PolygonVertexIndex", [("i", [0, 1, ~2, 1, 2, ~3])])]),
            ("Geometry", [("L", 13)], [("Vertices", [("d", [0.0] * 3)])])]
    buf = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    for top in (("FBXHeaderExtension", [], [("FBXVersion", [("L", 7400)])]),
                ("Objects", [], geos)):
        buf += _fbx_node(len(buf), *top)
    buf += b"\x00" * 13
    path = tmp_path / "trees.fbx"
    path.write_bytes(buf)
    got, want = t_fbx.load_fbx_meshes(str(path)), j_fbx.load_fbx_meshes(
        str(path))
    assert len(got) == len(want) == 2
    assert want[0][1].shape == (3, 3)
    for (gv, gt), (wv, wt) in zip(got, want):
        for a, b in ((gv, wv), (gt, wt)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    (mv, mt), (jv, jt) = t_fbx.merge_meshes(got), j_fbx.merge_meshes(want)
    np.testing.assert_array_equal(mt, jt)
    np.testing.assert_array_equal(t_fbx.normalize_mesh(mv, 6.0),
                                  j_fbx.normalize_mesh(jv, 6.0))
    (tmp_path / "text.fbx").write_bytes(b"; FBX 7.4.0 project file")
    with pytest.raises(ValueError, match="not a binary FBX"):
        t_fbx.parse_fbx(str(tmp_path / "text.fbx"))


# --------------------------------------------------------------------------
# The rasterizer
# --------------------------------------------------------------------------

W, H = 40, 32


def _raster_cases():
    rng = np.random.default_rng(11)
    n = 8
    verts = np.stack([(rng.random(n * 3, dtype=np.float32) - 0.5) * 10.0,
                      (rng.random(n * 3, dtype=np.float32) - 0.5) * 8.0,
                      rng.random(n * 3, dtype=np.float32) * 10.0 - 1.0], -1)
    return {
        "facing": ([(-4.0, -4.0, 5.0), (4.0, -4.0, 5.0), (0.0, 5.0, 5.0)],
                   [(0, 1, 2)], [(1.0, 0.5, 0.25)]),
        "nearer_wins": ([(-5.0, -5.0, 6.0), (5.0, -5.0, 6.0), (0.0, 6.0, 6.0),
                         (-5.0, -5.0, 3.0), (5.0, -5.0, 3.0),
                         (0.0, 6.0, 3.0)],
                        [(0, 1, 2), (3, 4, 5)],
                        [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]),
        "windings": ([(-4.0, -4.0, 5.0), (4.0, -4.0, 5.0), (0.0, 5.0, 5.0),
                      (-6.0, -1.0, 7.0), (6.0, -3.0, 4.0), (1.0, 6.0, 6.0)],
                     [(2, 1, 0), (3, 4, 5)],
                     [(0.2, 0.3, 0.4), (0.9, 0.1, 0.5)]),
        "behind": ([(-4.0, -4.0, -2.0), (4.0, -4.0, 5.0), (0.0, 5.0, 5.0),
                    (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)],
                   [(0, 1, 2), (3, 4, 5)], [(1.0, 1.0, 1.0)] * 2),
        "fuzz": (verts, np.arange(n * 3, dtype=np.int32).reshape(n, 3),
                 rng.random((n, 3), dtype=np.float32)),
    }


@pytest.mark.parametrize("case", list(_raster_cases()))
def test_rasterize_matches_jax_op_by_op(case, monkeypatch):
    verts, tris, alb = _raster_cases()[case]
    jm = j_mesh.TriMesh.create(verts, tris, alb)
    jc = JCamera.create(position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, 1.0),
                        aspect=W / H)
    monkeypatch.setattr(jnp, "tan", lambda x: jnp.asarray(
        torch.tan(torch.as_tensor(np.array(x))).numpy()))
    with jax.disable_jit():
        want = [np.asarray(a) for a in j_raster.rasterize_mesh(jm, jc, W, H)]
    got = [a.numpy() for a in t_raster.rasterize_mesh(
        mesh_from_numpy(jm, "cpu"), _camera(jc), W, H)]
    for name, g, w in zip(("albedo", "normal", "depth"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    hit = want[2] < j_raster.BIG
    assert hit.any() == (case != "behind")


@pytest.fixture(scope="module")
def mesh_scene():
    return j_demo(aspect=16 / 9, mesh_env=True)


def test_rasterize_mesh_scene_matches_jax_jit(mesh_scene):
    """The 276 triangles of the mesh scene at 160x90 against JAX's jitted
    raster; and the port's image at chunk 8 and at its card chunk, bit for
    bit."""
    w, h = 160, 90
    js = _tree_scene(mesh_scene, w, h)
    want = [np.asarray(a) for a in jax.jit(
        lambda s: j_raster.rasterize_mesh(s.mesh, s.camera, w, h))(js)]
    ts = scene_from_numpy(js, "cpu")
    got = [a.numpy() for a in t_raster.rasterize_mesh(ts.mesh, ts.camera, w,
                                                      h, 8)]
    big = [a.numpy() for a in t_raster.rasterize_mesh(
        ts.mesh, ts.camera, w, h, t_raster.CUDA_CHUNK)]
    for a, b in zip(got, big):
        np.testing.assert_array_equal(a, b)
    g_hit, w_hit = got[2] < t_raster.BIG, want[2] < j_raster.BIG
    assert ts.mesh.num_tris == 276 and w_hit.mean() >= 0.1
    both = g_hit & w_hit
    assert (g_hit != w_hit).mean() <= 1e-3
    rel = np.abs(got[2] - want[2])[both] / want[2][both]
    assert rel.max() <= 1e-6, rel.max()
    # the winning triangle (its albedo and unit face normal; jit moves the
    # normal by ulps) differs only where two triangles meet
    same = (got[0] == want[0]).all(-1) \
        & (np.abs(got[1] - want[1]) <= 1e-6).all(-1)
    assert (~same & both).mean() <= 1e-3


# --------------------------------------------------------------------------
# The G-buffer and two frames
# --------------------------------------------------------------------------

SLICE = dict(volume_width=16, volume_height=12, volume_depth=8,
             image_width=64, image_height=36, shadow_mode="raycast")


@pytest.fixture(scope="module")
def jax_gbuffer(mesh_scene):
    """JAX's jitted G-buffer of the mesh scene at TREE_CAMERA, 64x36."""
    js = _tree_scene(mesh_scene, 64, 36)
    jr = JRenderer(dataclasses.replace(J_DEMO, **SLICE))
    c, d = jax.jit(jr.render_scene_inputs)(js)
    return js, np.array(c), np.array(d)


def test_gbuffer_matches_jax_on_mesh_scene(jax_gbuffer):
    js, jc, jd = jax_gbuffer
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.DEMO_CONFIG, **SLICE),
                               device="cpu")
    ts = scene_from_numpy(js, "cpu")
    tc, td = (a.numpy() for a in tr.render_scene_inputs(ts))
    m_depth = t_raster.rasterize_mesh(ts.mesh, ts.camera, 64, 36)[2].numpy()
    assert (m_depth <= td).mean() >= 0.1     # the trees are in the picture
    rel = np.abs(td - jd) / np.abs(jd)
    assert rel.max() <= 1e-4, rel.max()
    err = np.abs(tc - jc)
    assert err.max() <= 2e-3, err.max()
    assert (err <= 1e-5).mean() >= 0.98, (err <= 1e-5).mean()


def test_demo_scene_mesh_proxies():
    s = vt.demo_scene(mesh_env=True, device="cpu")
    g = s.geometry
    assert g.n_proxy_boxes == 20 and g.box_min.shape[0] == 23
    assert g.box_fractional and bool((g.box_opacity[3:] < 1.0).all())
    assert s.mesh.num_tris == 276


@pytest.fixture(scope="module")
def mesh_frames(jax_gbuffer):
    """Two frames of JAX's and the port's plain-XLA raycast route on the
    cheap-terrain mesh scene, both fed JAX's G-buffer."""
    js, c, d = jax_gbuffer
    js = dataclasses.replace(js, geometry=dataclasses.replace(
        js.geometry, hf_steps=4, hf_octaves=1))
    jr = JRenderer(dataclasses.replace(J_DEMO, **SLICE))
    step = jax.jit(lambda s, sc, t: jr.render_frame(
        s, sc, t, scene_color=c, view_depth=d))
    st = jr.init_state(1)
    j_out = []
    for i in range(2):
        img, aux, st = step(st, js, jnp.float32(0.1 * i))
        j_out.append((np.asarray(img), np.asarray(aux["shadow"])))
    j_state = (np.asarray(packed_accumulation(st.prev_accumulation,
                                              jr.config.grid_dhw)),
               np.asarray(st.prev_shadow))
    tr = vt.VolumetricRenderer(dataclasses.replace(vt.DEMO_CONFIG, **SLICE),
                               device="cpu")
    ts_scene = scene_from_numpy(js, "cpu")
    ts = tr.init_state(1)
    t_out = []
    for i in range(2):
        img, aux, ts = tr.render_frame(ts, ts_scene, np.float32(0.1 * i),
                                       torch.as_tensor(c),
                                       torch.as_tensor(d))
        t_out.append((img.numpy(), aux["shadow"].numpy()))
    t_state = (t_packed(ts.prev_accumulation).numpy(),
               ts.prev_shadow.numpy())
    return tr, ts_scene, j_out, j_state, t_out, t_state


@pytest.mark.parametrize("i", [0, 1])
def test_mesh_frame_matches_jax(mesh_frames, i):
    tr, _, j_out, _, t_out, _ = mesh_frames
    assert not tr.fuses_frame() and not tr.scatter_kernel(mesh_frames[1])
    assert_boundary_close(t_out[i][0], j_out[i][0], f"image {i}")
    assert_boundary_close(t_out[i][1], j_out[i][1], f"shadow {i}")


def test_mesh_state_matches_jax_and_proxies_shadow(mesh_frames):
    _, _, j_out, (j_acc, j_sh), t_out, (t_acc, t_sh) = mesh_frames
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")
    # frame 1 has no history: a shadow strictly between 0 and 1 is a ray
    # through a proxy box of opacity below 1
    sh = t_out[0][1]
    assert ((sh > 0.0) & (sh < 1.0)).any()
