"""The port's VolumetricRenderer (device="cpu": the plain-torch twins of
kernels K1-K4) against the JAX renderer's render_frame under jax.jit, over
three frames with the camera moving between them: the production knobs of
FULL_CONFIG at a 16x15x16 grid and 128x120 pixels (8x8 pixel cells),
raycast_shadow_subsample=4, on benchmark_scene(4 local lights, procedural
noise). Both sides take the same G-buffer, computed once per camera by the
JAX renderer, as the bench computes it once up front: the port's G-buffer is
held to JAX's in test_torch_foundations.test_gbuffer_matches_jax, whose
grazing sphere and ground hits amplify last-ulp differences past this
file's tolerance.

Tolerance, for the images and both state tensors: rtol 1e-5 / atol 1e-6
per element, except for at most 5e-3 of the elements, which may also sit
beyond 1e-3 relative (the any-hit boundary class: shadow rays within ulps of
a primitive edge may flip); and a mean absolute image error of at most 1e-5
of the image maximum."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import FULL_CONFIG as J_FULL
from volumetricrenderer_tpu import VolumetricRenderer as JRenderer
from volumetricrenderer_tpu.models.camera import Camera as JCamera
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.state import packed_accumulation

import volumetricrenderer_tpu_torch as vt
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.parallel.shard_render import Slab
from volumetricrenderer_tpu_torch.state import \
    packed_accumulation as t_packed

from torch_tolerance import assert_boundary_close

SMALL = dict(volume_width=16, volume_height=15, volume_depth=16,
             image_width=128, image_height=120)
CAMERAS = [((-0.4, 1.9, -15.8), (0.0, 0.0, 1.0)),
           ((-0.1, 2.0, -15.2), (0.04, -0.01, 1.0)),
           ((0.3, 2.1, -14.7), (0.08, -0.03, 1.0))]


@pytest.fixture(scope="module")
def frames():
    base = j_bench(aspect=128 / 120, num_local_lights=4,
                   noise_mode="procedural")
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=128 / 120)) for p, f in CAMERAS]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL))
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

    tr = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
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
    return j_imgs, j_state, t_imgs, t_state, ts


@pytest.mark.parametrize("i", [0, 1, 2])
def test_image_matches_jax(frames, i):
    j_imgs, _, t_imgs, _, _ = frames
    a, b = t_imgs[i], j_imgs[i]
    assert a.shape == b.shape == (120, 128, 4)
    assert_boundary_close(a, b, f"image {i}")
    assert np.abs(a - b).mean() <= 1e-5 * np.abs(b).max()


def test_state_matches_jax(frames):
    _, (j_acc, j_sh), _, (t_acc, t_sh), ts = frames
    assert_boundary_close(t_acc, j_acc, "accumulation history")
    assert_boundary_close(t_sh, j_sh, "shadow history")
    assert ts.frame_count == 3


def test_render_frame_computes_the_gbuffer_when_not_given():
    """Without a G-buffer, render_frame takes render_scene_inputs' one:
    the same image bit for bit."""
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                              device="cpu")
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    img, aux, _ = r.render_frame(r.init_state(1), scene, 0.0)
    color, depth = r.render_scene_inputs(scene)
    torch.testing.assert_close(aux["scene_color"], color, rtol=0, atol=0)
    torch.testing.assert_close(aux["view_depth"], depth, rtol=0, atol=0)
    img2, _, _ = r.render_frame(r.init_state(1), scene, 0.0, color, depth)
    torch.testing.assert_close(img, img2, rtol=0, atol=0)


def test_renderer_packs_from_one_host_copy_of_the_scene():
    """frame_tables packs from a CPU copy of the scene made once per scene,
    and leaves the view matrix for the next frame on the CPU."""
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                              device="cpu")
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    host = r.host_scene(scene)
    assert r.host_scene(scene) is host
    assert host.camera.position.device.type == "cpu"
    other = vt.benchmark_scene(aspect=128 / 120, num_local_lights=2,
                               noise_mode="procedural", device="cpu")
    assert r.host_scene(other) is not host
    _, _, w2v = r.frame_tables(r.init_state(1), scene, 0.0)
    assert w2v.device.type == "cpu"


def _unported_scene(kind):
    """benchmark_scene, or with one part the port refused before it took
    any number of suns and noise media (five suns, five fBm media baked at
    the low rate) or in an H-sharded slab before the slab forms were ported
    (a texture-noise medium, no media, no sun)."""
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    if kind == "no_sun":
        return dataclasses.replace(scene, dir_lights=dataclasses.replace(
            scene.dir_lights, **{f.name: getattr(scene.dir_lights, f.name)[:0]
                                 for f in dataclasses.fields(
                                     scene.dir_lights)}))
    if kind == "texture_noise":
        fog = scene.media[0]
        return dataclasses.replace(scene, media=(dataclasses.replace(
            fog, noise_mode="texture",
            noise_tex=torch.zeros((4, 4, 4))),) + scene.media[1:])
    if kind == "no_media":
        return dataclasses.replace(scene, media=())
    if kind == "five_noise_media":
        return dataclasses.replace(scene, media=(scene.media[0],) * 5)
    if kind == "five_suns":
        dl = scene.dir_lights
        return dataclasses.replace(scene, dir_lights=dataclasses.replace(
            dl, **{f.name: torch.cat([getattr(dl, f.name)] * 5)
                   for f in dataclasses.fields(dl)}))
    return scene


@pytest.mark.parametrize("kw", [dict(slab=True, scene="five_suns"),
                                dict(slab=True, reproj_impl="gather",
                                     shadow_mode="map_dir"),
                                dict(slab=True, reproj_impl="gather"),
                                dict(scene="five_suns"),
                                dict(shadow_mode="cascaded"),
                                dict(slab=True, scene="five_noise_media"),
                                dict(scatter_impl="xla", slab=True,
                                     reproj_impl="gather"),
                                dict(slab=True, shadow_mode="cascaded"),
                                dict(frame_fused=False, slab=True,
                                     scene="five_suns"),
                                dict(scene="five_noise_media")])
def test_unported_configs_raise(kw):
    """What the port still refuses, on FULL_CONFIG, on the whole grid and
    in an H-sharded slab: a config value it does not know, and in a slab
    the gather reprojection (the JAX package refuses it there too). The
    cases of five suns or five fBm media baked at the low rate, refused
    until the kernels took any number of them, render now, on the whole
    grid and in a slab of the whole grid (which is the whole grid's frame
    bit for bit), with as many shadow channels (tests/test_torch_many_suns.py
    holds such frames against JAX). Mesh scenes and proxy boxes render
    since the mesh environment was ported (test_mesh_configs_render); the
    shadow-map modes, the XLA scatter, texture media and scenes without a
    sun or without media render in slabs since the slab forms were ported
    (tests/test_torch_slab.py)."""
    kw = dict(kw)
    kind = kw.pop("scene", None)
    scene = _unported_scene(kind)
    slab = Slab(0.0, 0, (16, 15, 16), 120) if kw.pop("slab", False) \
        else None
    r = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **{**SMALL, **kw}),
        device="cpu")
    nd = scene.dir_lights.count
    if kind not in ("five_suns", "five_noise_media"):
        with pytest.raises(NotImplementedError):
            r.render_frame(r.init_state(nd), scene, 0.0, slab=slab)
        return
    sc, vd = r.render_scene_inputs(scene)
    img, aux, st = r.render_frame(r.init_state(nd), scene, 0.0, sc, vd,
                                  slab=slab)
    assert st.prev_shadow.shape == (nd, 16, 15, 16)
    assert bool(torch.isfinite(img).all())
    if slab is not None:
        whole, _, _ = r.render_frame(r.init_state(nd), scene, 0.0, sc, vd)
        assert torch.equal(img, whole)


def _mesh_scene(kind):
    """benchmark_scene with a procedural tree 6.8 m in front of the camera
    ("mesh"), or with its last box flagged a shadow-only proxy
    ("proxy_boxes")."""
    from volumetricrenderer_tpu_torch.models.mesh import (procedural_tree,
                                                          transform_mesh)
    scene = vt.benchmark_scene(aspect=128 / 120, num_local_lights=4,
                               noise_mode="procedural", device="cpu")
    if kind == "mesh":
        return dataclasses.replace(scene, mesh=transform_mesh(
            procedural_tree(device="cpu"), translate=(-0.4, 0.0, -9.0)))
    return dataclasses.replace(scene, geometry=dataclasses.replace(
        scene.geometry, n_proxy_boxes=1))


@pytest.mark.parametrize("kw", [dict(scene="mesh"),
                                dict(scene="proxy_boxes"),
                                dict(demo=True, scene="mesh"),
                                dict(frame_fused=False, scene="mesh")])
def test_mesh_configs_render(kw):
    """The configurations test_unported_configs_raise refused until the
    mesh environment was ported: a scene with a tree mesh renders on
    FULL_CONFIG, DEMO_CONFIG and the staged frame, the tree nearer in the
    G-buffer than what stands behind it; a scene whose proxy boxes have no
    mesh renders as if they were plain boxes (primary rays skip them only
    under a mesh, as in the JAX package). tests/test_torch_mesh.py holds
    the mesh scene against JAX."""
    kw = dict(kw)
    kind = kw.pop("scene")
    scene = _mesh_scene(kind)
    if kw.pop("demo", False):
        cfg = dataclasses.replace(vt.DEMO_CONFIG, shadow_map_size=32, **SMALL)
    else:
        cfg = dataclasses.replace(vt.FULL_CONFIG, **{**SMALL, **kw})
    r = vt.VolumetricRenderer(cfg, device="cpu")
    img, aux, _ = r.render_frame(r.init_state(1), scene, 0.0)
    assert bool(torch.isfinite(img).all())
    bare = dataclasses.replace(scene, mesh=None,
                               geometry=dataclasses.replace(
                                   scene.geometry, n_proxy_boxes=0))
    if kind == "mesh":
        _, depth_bare = r.render_scene_inputs(bare)
        assert bool((aux["view_depth"] < depth_bare - 0.5).any())
    else:
        assert torch.equal(img, r.render_frame(r.init_state(1), bare,
                                               0.0)[0])


@pytest.mark.parametrize("kw", [dict(frame_fused=False, scatter_bake="vis"),
                                dict(material_impl="xla"),
                                dict(reproj_impl="windowed"),
                                dict(frame_fused=False,
                                     temporal_blend_scatter=True),
                                dict(frame_fused=False,
                                     accumulate_impl="xla")],
                         ids=lambda kw: ",".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_staged_configs_match_jax(kw):
    """Configurations that leave the fused frame for a staged route (the
    visibility bake, material volumes, the plain reprojection, the scatter
    blend, the plain scan): two frames with a moving camera against the JAX
    render_frame, same tolerance as the frames above."""
    base = j_bench(aspect=128 / 120, num_local_lights=4,
                   noise_mode="procedural")
    scenes = [dataclasses.replace(base, camera=JCamera.create(
        position=p, forward=f, aspect=128 / 120)) for p, f in CAMERAS[:2]]
    jr = JRenderer(dataclasses.replace(J_FULL, **SMALL, **kw))
    tr = vt.VolumetricRenderer(
        dataclasses.replace(vt.FULL_CONFIG, **SMALL, **kw), device="cpu")
    assert not tr.fuses_frame()
    gbuffer = jax.jit(jr.render_scene_inputs)
    step = jax.jit(lambda s, sc, t, c, d: jr.render_frame(
        s, sc, t, scene_color=c, view_depth=d)[::2])
    st, ts = jr.init_state(1), tr.init_state(1)
    for i, sc in enumerate(scenes):
        c, d = (np.array(a) for a in gbuffer(sc))
        j_img, st = step(st, sc, jnp.float32(0.1 * i), c, d)
        t_img, _, ts = tr.render_frame(ts, scene_from_numpy(sc, "cpu"),
                                       np.float32(0.1 * i),
                                       torch.as_tensor(c), torch.as_tensor(d))
        assert_boundary_close(t_img.numpy(), j_img, f"{kw} image {i}")
        assert np.abs(t_img.numpy() - np.asarray(j_img)).mean() \
            <= 1e-5 * np.abs(np.asarray(j_img)).max()
    assert_boundary_close(
        t_packed(ts.prev_accumulation).numpy(),
        packed_accumulation(st.prev_accumulation, jr.config.grid_dhw),
        f"{kw} accumulation history")
    assert_boundary_close(ts.prev_shadow.numpy(), st.prev_shadow,
                          f"{kw} shadow history")


def test_texture_noise_scene_raises():
    """A texture-noise scene renders on the whole grid (its frames are held
    against JAX in tests/test_torch_texture.py) and in H-sharded slabs, as
    in the JAX package: the fused frame's noise channels baked at each
    slab's low grid with its y phase. The bands against the whole grid's
    frame at the JAX package's class for the radiance bake in slabs
    (tests/test_shard_render.py: relative to the image maximum, mean under
    5e-4 and 0.02 everywhere): the bake's y tent clamps where a slab's
    phased low grid has no sample beyond a row, at the global edges and
    here (15 rows in 3 slabs at ss=4) also in the third slab's top halo,
    which the composite reads at the seam. The name is the refusal's that
    this replaced."""
    from volumetricrenderer_tpu_torch.parallel.shard_render import \
        make_multislab_render
    r = vt.VolumetricRenderer(dataclasses.replace(vt.FULL_CONFIG, **SMALL),
                              device="cpu")
    js = j_bench(aspect=128 / 120, num_local_lights=4,
                 noise_tex=np.ones((4, 4, 4), np.float32))
    scene = scene_from_numpy(js, "cpu")
    assert r.fuses_frame(scene)
    sc, vd = r.render_scene_inputs(scene)
    img, _, _ = r.render_frame(r.init_state(1), scene, 0.0, sc, vd)
    assert bool(torch.isfinite(img).all())
    fn = make_multislab_render(r, 3)
    bands, _ = fn(fn.init_carry(1), scene, 0.0, list(sc.chunk(3)),
                  list(vd.chunk(3)))
    rel = ((torch.cat(bands) - img).abs() / img.abs().max()).numpy()
    assert rel.mean() < 5e-4 and rel.max() < 0.02