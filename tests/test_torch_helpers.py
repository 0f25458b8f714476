"""The port's device-helper twins against the JAX package's in-kernel
helpers, which index their tables as ref[i, j] and so also run on plain
arrays outside a kernel. Inputs: the benchmark scene (procedural noise), a
moved camera, and numpy-seeded planes.

Tolerance: rtol 1e-5 / atol 1e-6 -- the same float32 formulas on both
sides; exp/log/rsqrt and FMA-contraction ulps differ. Any-hit booleans may
differ only for rays within ~1e-5 of an epsilon: at most 1e-3 of the
samples. make_xy_blend (pltpu.roll) runs only inside a kernel and is covered
by test_torch_frame_fused.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from volumetricrenderer_tpu import froxel as jfroxel
from volumetricrenderer_tpu.models.scene import benchmark_scene as j_bench
from volumetricrenderer_tpu.ops.pallas import dir_shadow as j_dir_shadow
from volumetricrenderer_tpu.ops.pallas import material as j_material
from volumetricrenderer_tpu.ops.pallas import occlude as j_occlude
from volumetricrenderer_tpu.ops.pallas import scatter as j_scatter
from volumetricrenderer_tpu.ops.pallas import temporal as j_temporal
from volumetricrenderer_tpu.ops.pallas import visibility as j_vis
from volumetricrenderer_tpu.ops.phase import PI as J_PI
from volumetricrenderer_tpu.ops.warp import windowed_warp_sample_3d

from volumetricrenderer_tpu_torch import froxel as tfroxel
from volumetricrenderer_tpu_torch.convert import scene_from_numpy
from volumetricrenderer_tpu_torch.ops import dir_shadow as t_dir_shadow
from volumetricrenderer_tpu_torch.ops import material as t_material
from volumetricrenderer_tpu_torch.ops import occlude as t_occlude
from volumetricrenderer_tpu_torch.ops import scatter as t_scatter
from volumetricrenderer_tpu_torch.ops import temporal as t_temporal
from volumetricrenderer_tpu_torch.ops import visibility as t_vis
from volumetricrenderer_tpu_torch.ops.phase import PI as T_PI

RTOL, ATOL = 1e-5, 1e-6
GRID = (24, 16, 12)
JIT = np.asarray([0.25, -0.3, 0.4], np.float32)


def close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def t_(a):
    return torch.as_tensor(np.array(np.asarray(a)))


@pytest.fixture(scope="module")
def setup():
    """JAX and port tables for one frame of the benchmark scene."""
    js = j_bench(aspect=1.5, num_local_lights=6, noise_mode="procedural")
    ts = scene_from_numpy(js, "cpu")
    cam = js.camera
    jp = jfroxel.make_froxel_params(cam.fov_y, cam.aspect, cam.near, 60.0,
                                    2.0, GRID)
    tp = tfroxel.make_froxel_params(ts.camera.fov_y, ts.camera.aspect,
                                    ts.camera.near, 60.0, 2.0, GRID)
    jv2w = cam.view_to_world()
    jprev = jfroxel.invert_rigid(jfroxel.look_at_matrix(
        jnp.asarray([-0.1, 1.8, -15.5]), jnp.asarray([0.05, -0.02, 1.0]),
        jnp.asarray([0.0, 1.0, 0.0])))
    g = js.geometry
    j = dict(
        spar=j_scatter.pack_params(jp, jv2w, cam.position, jnp.asarray(JIT)),
        sbpar=j_temporal.pack_blend_params(jp, jv2w, jprev, jnp.asarray(JIT),
                                           jnp.float32(0.7), 1e-4),
        abpar=j_temporal.pack_blend_params(jp, jv2w, jprev,
                                           jnp.zeros(3, jnp.float32),
                                           jnp.float32(0.7), 0.0),
        lights=j_scatter.pack_lights(js.point_lights, js.spot_lights),
        slights=j_dir_shadow.pack_dir_lights(js.dir_lights),
        dirs=j_scatter.pack_dir_lights(js.dir_lights),
        planes=jnp.concatenate([g.plane_normal, g.plane_d[:, None]], -1),
        spheres=jnp.concatenate([g.sphere_center, g.sphere_radius[:, None]],
                                -1),
        boxes=j_occlude.pack_boxes(g), hf=j_material.pack_heightfield(g))
    j["med"], statics = j_material.pack_media(js.media, 0.3)
    t = {k: t_(v) for k, v in j.items()}
    counts = dict(n_planes=j["planes"].shape[0],
                  n_spheres=j["spheres"].shape[0],
                  n_boxes=j["boxes"].shape[0])
    return j, t, statics, counts, (jp, jv2w, jprev), (tp, ts)


def test_any_hit(setup):
    j, t, _, counts, _, _ = setup
    rng = np.random.default_rng(0)
    n = 4096
    o = rng.uniform([-20, 0, -10], [20, 8, 40], (n, 3)).astype(np.float32)
    dvec = rng.normal(size=(n, 3))
    dvec = (dvec / np.linalg.norm(dvec, axis=1, keepdims=True)).astype(
        np.float32)
    max_t = rng.uniform(0.5, 40.0, (n,)).astype(np.float32)
    jo = j_occlude.any_hit(j["planes"], j["spheres"], j["boxes"], j["hf"],
                           *(jnp.asarray(o[:, i]) for i in range(3)),
                           *(jnp.asarray(dvec[:, i]) for i in range(3)),
                           jnp.asarray(max_t), hf_static=None, **counts)
    to = t_occlude.any_hit(t["planes"], t["spheres"], t["boxes"],
                           *(torch.as_tensor(o[:, i]) for i in range(3)),
                           *(torch.as_tensor(dvec[:, i]) for i in range(3)),
                           torch.as_tensor(max_t), **counts)
    jo = np.asarray(jo)
    assert 0.05 < jo.mean() < 0.95          # both outcomes are exercised
    assert (to.numpy() != jo).mean() <= 1e-3


@pytest.mark.parametrize("zi", [0, 5, 11])
def test_dir_shadow_slice(setup, zi):
    j, t, _, counts, _, _ = setup
    jout = j_dir_shadow.dir_shadow_slice(
        j["spar"], j["slights"], j["planes"], j["spheres"], j["boxes"],
        j["hf"], jnp.int32(zi), grid_whd=GRID, n_lights=1, max_dist=1e4,
        h_glob=GRID[1], **counts)
    tout = t_dir_shadow.dir_shadow_slice(
        t["spar"], t["slights"], t["planes"], t["spheres"], t["boxes"], zi,
        grid_whd=GRID, n_lights=1, max_dist=1e4, h_glob=GRID[1], **counts)
    diff = np.abs(tout[0].numpy() - np.asarray(jout[0]))
    assert (diff > ATOL + RTOL).mean() <= 1e-3


def test_perlin_hash_bit_exact_and_fbm():
    rng = np.random.default_rng(2)
    ix, iy, iz = (rng.integers(-2 ** 20, 2 ** 20, (257,)).astype(np.int32)
                  for _ in range(3))
    for period in (4, 8, 6, None):       # None: raw negative lattices
        wrap = (lambda a: a) if period is None else \
            (lambda a: a & (period - 1)) if period & (period - 1) == 0 \
            else (lambda a: np.mod(a, period))
        for seed in (7, 8, 123456):
            jh = j_material._hash3(*(jnp.asarray(wrap(a)) for a in
                                     (ix, iy, iz)), seed)
            th = t_material._hash3(*(torch.as_tensor(wrap(a).astype(np.int64))
                                     for a in (ix, iy, iz)), seed)
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    u = rng.uniform(-3.0, 3.0, (3, 16, 24)).astype(np.float32)
    for octaves, period, seed in ((3, 4, 7), (2, 6, 11)):
        close(t_material.perlin_planes(*(torch.as_tensor(a) for a in u),
                                       octaves, period, seed),
              j_material.perlin_planes(*(jnp.asarray(a) for a in u),
                                       octaves, period, seed),
              msg=f"fbm oct={octaves} period={period}")


@pytest.mark.parametrize("ss", [2, 4])
def test_bake_planes_and_radiance(setup, ss):
    """bake_world_planes, radiance_view_dirs, phase_g_plane,
    noise_factor_planes, light_factor and bake_radiance_plane at the low
    samples of one low slice."""
    j, t, statics, counts, _, _ = setup
    zi = 1
    jw = j_vis.bake_world_planes(j["spar"], jnp.int32(zi), GRID, ss, GRID[1])
    tw = t_vis.bake_world_planes(t["spar"], zi, GRID, ss, GRID[1])
    for a, b in zip(tw, jw):
        close(a, b, msg="bake_world_planes")
    jv = j_vis.radiance_view_dirs(j["spar"], *jw)
    tv = t_vis.radiance_view_dirs(t["spar"], *tw)
    for a, b in zip(tv, jv):
        close(a, b, msg="radiance_view_dirs")
    jg = j_material.phase_g_plane(j["med"], statics, *jw)
    tg = t_material.phase_g_plane(t["med"], statics, *tw)
    close(tg, jg, msg="phase_g_plane")
    for a, b in zip(t_material.noise_factor_planes(t["med"], statics, *tw),
                    j_material.noise_factor_planes(j["med"], statics, *jw)):
        close(a, b, msg="noise_factor_planes")
    jg2, tg2 = jg * jg, tg * tg
    jnum, tnum = (1.0 - jg2) / (4.0 * J_PI), (1.0 - tg2) / (4.0 * T_PI)
    for li in range(j["lights"].shape[0]):
        jf = j_scatter.light_factor(lambda i: j["lights"][li, i], *jw, *jv,
                                    jg, jg2, jnum)
        tf = t_scatter.light_factor(lambda i: t["lights"][li, i], *tw, *tv,
                                    tg, tg2, tnum)
        for k, (a, b) in enumerate(zip(tf[:5], jf[:5])):
            close(a, b, msg=f"light_factor li={li} out={k}")
        jr = j_vis.bake_radiance_plane(
            j["lights"], li, *jw, *jv, jg, jg2, jnum, j["planes"],
            j["spheres"], j["boxes"], j["hf"], hf_static=None, **counts)
        tr = t_vis.bake_radiance_plane(
            t["lights"], li, *tw, *tv, tg, tg2, tnum, t["planes"],
            t["spheres"], t["boxes"], **counts)
        for a, b in zip(tr, jr):
            diff = np.abs(a.numpy() - np.asarray(b))
            bad = diff > ATOL + RTOL * np.abs(np.asarray(b))
            assert bad.mean() <= 1e-3, (li, bad.mean())


def test_material_planes(setup):
    j, t, statics, _, _, _ = setup
    rng = np.random.default_rng(3)
    pts = rng.uniform([-30, -1, -20], [30, 10, 40], (16, 24, 3)).astype(
        np.float32).transpose(2, 0, 1).copy()
    noise = rng.uniform(0, 1, (16, 24)).astype(np.float32)
    for npl in (None, [noise]):
        jm = j_material.material_planes(
            j["med"], statics, *(jnp.asarray(a) for a in pts),
            noise_planes=None if npl is None else [jnp.asarray(noise)])
        tm = t_material.material_planes(
            t["med"], statics, *(torch.as_tensor(a) for a in pts),
            noise_planes=None if npl is None else [torch.as_tensor(noise)])
        for k, (a, b) in enumerate(zip(tm, jm)):
            close(a, b, msg=f"material_planes out={k} noise={npl is None}")


@pytest.mark.parametrize("k", [1, 4, 52, 159])
@pytest.mark.parametrize("blend", ["shadow", "acc"])
def test_reproj_offsets_and_warp(setup, k, blend):
    """_reproj_offsets per slice, and the port's separable warp of a random
    history against the JAX windowed warp at the same targets; k = 52 and
    159 (the region_global forms' edges, past this grid's every axis) at
    windows wider than the grid."""
    j, t, _, _, _, _ = setup
    jb, tb = (j["sbpar"], t["sbpar"]) if blend == "shadow" \
        else (j["abpar"], t["abpar"])
    jit = blend == "shadow"
    w, h, d = GRID
    zs = torch.arange(d)[:, None, None]
    tox, toy, toz, tsu = t_temporal.reproj_offsets(tb, zs, GRID, h, k, jit)
    offs = []
    for z in range(d):
        jo = j_temporal._reproj_offsets(jb, jnp.int32(z), GRID, h, k, jit)
        for a, b in zip((tox[z], toy[z], toz[z], tsu[z]), jo):
            close(a, b, rtol=RTOL, atol=1e-5, msg=f"offsets z={z}")
        offs.append(jo[:3])
    jox, joy, joz = (jnp.stack([o[i] for o in offs]) for i in range(3))
    base = [jnp.asarray(np.broadcast_to(a, (d, h, w)).astype(np.float32))
            for a in np.meshgrid(np.arange(d), np.arange(h), np.arange(w),
                                 indexing="ij")]
    prev = np.random.default_rng(4).uniform(0, 1, (2, d, h, w)).astype(
        np.float32)
    for c in range(2):
        jw = windowed_warp_sample_3d(jnp.asarray(prev[c]), base[2] + jox,
                                     base[1] + joy, base[0] + joz, k=k)
        tw = t_temporal.warp(torch.as_tensor(prev), t_(jox), t_(joy),
                             t_(joz), k)[c]
        close(tw, jw, rtol=RTOL, atol=1e-5, msg=f"warp c={c}")


@pytest.mark.parametrize("ss", [2, 4])
def test_scatter_slice_radiance(setup, ss):
    """scatter_slice in radiance mode (material fused, the low volume read
    through the 4-ref HBM-block form) against the port's scatter_slice fed
    by upsample_low."""
    j, t, statics, counts, _, _ = setup
    w, h, d = GRID
    wl, hl, dl = t_vis.low_res_dims(GRID, ss)
    rng = np.random.default_rng(5)
    vol = rng.uniform(0, 1, (4, dl, hl, wl)).astype(np.float32)
    shadow = rng.uniform(0, 1, (h, w)).astype(np.float32)
    ay = j_vis.upsample_mats_y(h, hl, ss, 0.0)
    axt = jnp.asarray(j_vis.upsample_mats(w, wl, ss).T)
    tx = tuple(torch.as_tensor(a) for a in t_vis.tent_taps(w, wl, ss))
    ty = tuple(torch.as_tensor(a) for a in t_vis.tent_taps(h, hl, ss))
    dummy = jnp.zeros((1, 1, 1), jnp.int32)
    for zi in (0, 3, d - 1):
        ka = min(max((2 * zi - (ss - 1)) // (2 * ss), 0), dl - 1)
        kb = min(ka + 1, dl - 1)
        jout = j_scatter.scatter_slice(
            j["spar"], j["lights"], j["dirs"], dummy, dummy, j["planes"],
            j["spheres"], j["boxes"], j["hf"], ("fused", j["med"]),
            (jnp.asarray(vol[:, ka:ka + 1]), jnp.asarray(vol[:, kb:kb + 1]),
             ay, axt), jnp.int32(zi), [jnp.asarray(shadow)], grid_whd=GRID,
            n_dir=1, jitter_dir=False, h_glob=h, media_static=statics,
            hf_static=None, vis_lowres=(ss, dl), radiance=True, n_noise=1,
            **counts)
        up = t_vis.upsample_low(torch.as_tensor(vol), zi, ss, tx, ty)
        tout = t_scatter.scatter_slice(
            t["spar"], t["dirs"], t["med"], statics, zi,
            [torch.as_tensor(shadow)], up[:3], [up[3]], grid_whd=GRID,
            n_dir=1, h_glob=h)
        for c, (a, b) in enumerate(zip(tout, jout)):
            close(a, b, msg=f"scatter_slice z={zi} out={c}")
