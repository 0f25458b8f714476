"""Render the demo scene (the reference's VolumetricRenderer.unity) to PNGs
on the port, as the repository's demo.py does on the JAX package.

    python -m volumetricrenderer_tpu_torch.demo [--frames N] [--out DIR]
        [--small] [--noise] [--debug-slice Z] [--showcase] [--production]
        [--mesh-env] [--scene FILE.json] [--dump-scene FILE.json]
        [--device cuda|cpu]

Each frame renders the froxel frame and the post stack: render_frame,
camera_velocity, auto_exposure_step and apply_post. The scene's G-buffer
(with --mesh-env the rasterized tree meshes) and its shadow maps are baked
once for a still camera and every frame under --showcase, whose camera
orbits (the depth and velocity effects need a moving view) and which runs
the full post chain. It prints each PNG's path, the frame's milliseconds
(host clock, the device synchronized) and the display image's checksum.
--production takes FULL_CONFIG's production kernels at the demo grid.
--scene renders a scene file (io/scene_io.py) and its post profile;
--dump-scene writes the built-in scene as one and exits.

It runs on the GPU; without CUDA it exits with status 2 unless given
--device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "volumetricrenderer_tpu_torch.demo")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="out")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--noise", action="store_true")
    ap.add_argument("--debug-slice", type=int, default=-1)
    ap.add_argument("--showcase", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="FULL_CONFIG's production impl set (fused frame, "
                         "radiance and noise bake, zgather composite) at "
                         "the demo grid")
    ap.add_argument("--mesh-env", action="store_true",
                    help="the reference's tree meshes, rasterized, with "
                         "their voxelized shadow proxies")
    ap.add_argument("--scene", default=None, metavar="FILE.json",
                    help="render a scene file (io/scene_io.py) instead of "
                         "the built-in demo scene")
    ap.add_argument("--dump-scene", default=None, metavar="FILE.json",
                    help="write the built-in scene as JSON and exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def demo_config(args):
    """DEMO_CONFIG with the --small and --production changes."""
    from volumetricrenderer_tpu_torch import DEMO_CONFIG
    cfg = DEMO_CONFIG
    if args.small:
        cfg = dataclasses.replace(cfg, volume_width=80, volume_height=44,
                                  volume_depth=32, image_width=480,
                                  image_height=270, shadow_map_size=128)
    if args.production:
        cfg = dataclasses.replace(
            cfg, shadow_mode="raycast", reproj_impl="pallas",
            scatter_impl="pallas", dir_shadow_impl="pallas",
            accumulate_impl="pallas", material_impl="fused",
            composite_impl="zgather", composite_precision="high",
            raycast_shadow_subsample=2, scatter_bake="radiance",
            bake_procedural_noise=True)
    return cfg


def post_config(showcase: bool):
    from volumetricrenderer_tpu_torch.post import PostConfig
    if showcase:
        # the full chain: auto exposure (the adapted luma carried across
        # frames), lens distortion, multi-scale AO, SSR, SMAA, dithering
        return PostConfig(exposure=1.1, bloom_strength=0.25,
                          bloom_threshold=0.8, vignette=0.25,
                          chromatic_aberration=1.0, grain=0.02,
                          saturation=1.1, contrast=1.05,
                          dof_focus_distance=20.0, dof_aperture=11.0,
                          dof_max_coc=3.0, motion_blur=0.4,
                          auto_exposure=True, ae_key=0.6, ae_min_ev=-2.0,
                          ae_max_ev=2.0, smaa=True, dithering=True,
                          lens_distortion=8.0, ao_intensity=0.5,
                          ao_multiscale=True, ssr_intensity=0.5)
    return PostConfig(exposure=1.0, vignette=0.15)


def orbit(scene, i: int):
    """--showcase's camera: frame i orbits the start position."""
    ang = 0.04 * i
    cam = scene.camera
    pos = torch.tensor([-0.4 + 4.0 * math.sin(ang), 1.9,
                        -15.8 + 2.0 * (1 - math.cos(ang))],
                       dtype=torch.float32, device=cam.position.device)
    return dataclasses.replace(scene,
                               camera=dataclasses.replace(cam, position=pos))


def main(argv=None) -> int:
    args = parse_args(argv)
    from volumetricrenderer_tpu_torch import VolumetricRenderer, demo_scene
    from volumetricrenderer_tpu_torch.io.scene_io import (load_scene,
                                                          save_scene)
    from volumetricrenderer_tpu_torch.ops.noise import perlin_texture_3d
    from volumetricrenderer_tpu_torch.post import (apply_post,
                                                   auto_exposure_step,
                                                   camera_velocity)
    from volumetricrenderer_tpu_torch.utils.cache import \
        enable_persistent_cache
    from volumetricrenderer_tpu_torch.utils.debug import (save_png,
                                                          volume_slice)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("demo: no CUDA device (pass --device cpu to run the "
              "plain-torch versions on the CPU)", file=sys.stderr)
        return 2
    # the kernels' build directory (utils/cache.py; VOLR_TORCH_CACHE)
    enable_persistent_cache()
    cfg = demo_config(args)
    dev = args.device
    scene_post = None
    if args.scene:
        scene, scene_post = load_scene(args.scene, with_post=True,
                                       device=dev)
    else:
        noise = perlin_texture_3d(32).to(dev) if args.noise else None
        scene = demo_scene(aspect=cfg.image_width / cfg.image_height,
                           with_noise=args.noise, noise_tex=noise,
                           mesh_env=args.mesh_env, device=dev)
    if args.dump_scene:
        save_scene(args.dump_scene, scene)
        print(f"wrote {args.dump_scene}")
        return 0
    post = scene_post if scene_post is not None \
        else post_config(args.showcase)
    renderer = VolumetricRenderer(cfg, device=dev)
    state = renderer.init_state(scene.dir_lights.count)

    gbuffer, shadow_data = (None, None), None
    if not args.showcase:
        t0 = time.perf_counter()
        with torch.no_grad():
            gbuffer = renderer.render_scene_inputs(scene)
            shadow_data = renderer.bake_shadow_data(scene)
        if renderer.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"G-buffer and shadow maps, baked once: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)

    def frame(state, scene, t, adapted_luma):
        image, aux, new_state = renderer.render_frame(
            state, scene, t, *gbuffer, shadow_data)
        vd = aux["view_depth"]
        cam = scene.camera
        vel = camera_velocity(vd, cam.fov_y, cam.aspect, cam.view_to_world(),
                              state.prev_world_to_view)
        scale = None
        if post.auto_exposure:
            planes = [image[..., c] for c in range(3)]
            scale, adapted_luma = auto_exposure_step(planes, adapted_luma,
                                                     post)
        out = apply_post(image, post, view_depth=vd, velocity=vel,
                         exposure_scale=scale,
                         dither_frame=state.frame_count)
        return out, aux["accumulation"], new_state, adapted_luma

    os.makedirs(args.out, exist_ok=True)
    # the auto-exposure eye-adaptation state
    adapted_luma = torch.ones((), device=renderer.device)
    for i in range(args.frames):
        t0 = time.perf_counter()
        sc = orbit(scene, i) if args.showcase else scene
        with torch.no_grad():
            rgb, acc, state, adapted_luma = frame(state, sc, i / 20.0,
                                                  adapted_luma)
        if renderer.device.type == "cuda":
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        path = os.path.join(args.out, f"frame_{i:03d}.png")
        save_png(path, rgb)
        print(f"{path}  {dt:.1f} ms  checksum "
              f"{float(rgb.sum(dtype=torch.float32))!r}", flush=True)
        if args.debug_slice >= 0:
            sl = volume_slice(acc.permute(1, 2, 3, 0), args.debug_slice)
            save_png(os.path.join(args.out, f"slice_{i:03d}.png"),
                     torch.clamp(sl[..., :3] * 3.0, 0.0, 1.0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
