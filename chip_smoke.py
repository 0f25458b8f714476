"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's frames at full width (240x135x128 froxels, 1920x1080 and,
for the uhd paths, 3840x2160, on benchmark_scene with 16 local lights and
procedural noise, and with a 32^3 noise texture, without its sun or without
media; and on the reference demo scene, demo_scene, with its procedural
terrain, at 1920x1080 and at the demo grid, 160x88x64 froxels at 1280x720)
through VolumetricRenderer, the entry point a user calls, and:

  1. prints the device and `nvidia-smi` name + power limit; exits non-zero
     without CUDA;
  2. builds every CUDA kernel from csrc/ (nvcc, all sources in parallel)
     and prints the registers per thread, shared memory per block and
     local (spill) bytes of the kernels of cuda.ATTR_KERNELS (K1-K14)
     (cudaFuncGetAttributes);
  3. computes the G-buffer once per image size;
  4. renders each path as a deterministic sequence from a fresh state
     (time_x = 0.1 i) with the launch counters set to 0 just before and read
     just after, and checks that exactly the path's kernels were launched,
     as often per frame as PATHS says (once, where not stated):
       fused             FULL_CONFIG, 4 frames: K1 K2 K3 K4
       staged            frame_fused=False, 4 frames: K5 K1 K6 K3 K4
       exact             also scatter_bake="vis", raycast_shadow_subsample=1,
                         2 frames: K5 K6 (per-light rays) K3 K4
       no_shadow_blend   staged with temporal_blend_shadow=False, 1 frame:
                         K7 K1 K6 K3 K4
       no_acc_blend      staged with temporal_blend_accumulation=False,
                         1 frame: K5 K1 K6 K8 K4
       history           staged with scatter_bake="vis" and the material and
                         scatter blends on, 4 frames: K11 (material blend)
                         K5 K9 K6 (baked visibility, material volumes) K11
                         (scatter blend) K10 (accumulation blend) K4; two
                         K11 launches per frame, and the accumulation is the
                         plain scan, as in the JAX package
       vis_bake          staged with scatter_bake="vis", 2 frames: K5 K9 K6
                         (baked visibility, fused material) K3 K4
       xla_shadow        history with dir_shadow_impl="xla", 1 frame: the
                         plain shadow volume, then K10 (shadow blend) and
                         the rest of history: two K10 and two K11 launches
       map_dir           shadow_mode="map_dir", 4 frames: K12 (cascaded PCF
                         on the low-rate grid, one launch per sun), the plain
                         upsample, K10 (shadow blend) K1 K6 K3 K4
       map_dir_full_rate also dir_shadow_subsample=1, 1 frame: K12 at full
                         rate, then as map_dir
       map               shadow_mode="map", 2 frames: K12 K10, the plain
                         radiance bake from the cube and spot maps, K6 K3
                         K4; no K1
       map_gather        map with dir_shadow_impl="xla", 1 frame: the plain
                         gather sampler on the unaligned bake, K10 K6 K3 K4
       pallas_composite  composite_impl="pallas", 1 frame: the fused frame,
                         its composite (the JAX package's composite_pallas)
                         on K4
       fused_exact       FULL_CONFIG with scatter_bake="vis",
                         raycast_shadow_subsample=1 (bench.py's exact_ms),
                         fused, 2 frames: K2 (per-light rays) K3 K4
       fused_vis         FULL_CONFIG with scatter_bake="vis" (ss=4), fused,
                         2 frames: K9 K2 (baked visibility) K3 K4
       uhd_exact         UHD_CONFIG with composite_upsample=1 (bench.py's
                         ms_4k_exact), 3840x2160 on its own G-buffer,
                         2 frames: K1 K2 K3 K4 (16x16-pixel cells)
       uhd               UHD_CONFIG (ms_4k), 4 frames: K1 K2 K3, K4 at
                         1920x1080 on co-sited pixels (planes, no scene),
                         the plain upsample and scene blend
       xla_scatter       FULL_CONFIG with scatter_impl="xla", 2 frames: K5,
                         the plain XLA scatter over plain material
                         volumes, the plain scan, K10 (accumulation blend)
                         K4
     on benchmark_scene with the fog sampling perlin_texture_3d() (32^3),
     without its sun, and without media:
       tex               FULL_CONFIG (bench.py's texture frame), 4 frames:
                         the noise channels of the fog's texture and the
                         other noise media in plain torch at the low grid,
                         K1 (radiance alone) K2 (reading them) K3 K4
       tex_staged        frame_fused=False, 2 frames: the plain material
                         volumes with the full-rate texture sample, K5 K1
                         K6 (radiance x planes) K3 K4
       tex_lowres        tex_staged with texture_noise_subsample=4, 1
                         frame: the texture sampled at the low grid and
                         tent-upsampled, then as tex_staged
       sunless           FULL_CONFIG without the sun (the staged route), 2
                         frames: a shadow volume of ones blended on K10, K1
                         K6 (radiance x fused, no sun term) K3 K4; no K5 or
                         K7
       no_media          FULL_CONFIG without media, 2 frames: zero material
                         volumes, K5 K9 K6 (baked x planes) K3 K4
     on demo_scene (every sun ray marches the terrain) and "fractional"
     (demo_scene with its first three boxes at shadow opacity 0.5, built
     with Geometry.create's 4-tuples):
       demo_full         FULL_CONFIG, 4 frames: K1 K2 K3 K4
       demo_production   demo.py --production at the demo grid (160x88x64,
                         1280x720, ss=2), 4 frames: K1 K2 K3 and K4's
                         per-pixel form (720/88 is no integer: JAX's
                         composite_rowmm)
       demo_hf_local     FULL + heightfield_local_shadows, 2 frames: K1
                         (local rays march the terrain) K2 K3 K4
       demo_exact_hf     exact + heightfield_local_shadows, 2 frames: K5 K6
                         (per-light rays over the terrain) K3 K4
       demo_vis_hf       fused_vis + heightfield_local_shadows, 2 frames:
                         K9 K2 K3 K4
       demo_no_shadow_blend  staged, temporal_blend_shadow=False, 1 frame:
                         K7 K1 K6 K3 K4
       demo_map_dir      map_dir, the sun atlas baked once over the terrain,
                         2 frames: K12 K10 K1 K6 K3 K4
       fractional        FULL_CONFIG, 2 frames: K1 K2 K3 K4, shadow rays
                         carrying occlusion amounts
       fractional_no_shadow_blend  staged, temporal_blend_shadow=False,
                         1 frame: K7 K1 K6 K3 K4
       anyres_xla        demo_production with composite_impl="xla", 1
                         frame: K4's per-pixel form, = demo_production's
                         frame 1 bit for bit
       demo_xla          DEMO_CONFIG as it stands (demo.py's frame:
                         160x88x64 at 1280x720, shadow maps, the gather sun
                         sampler, the "windowed" reprojection, the XLA
                         scatter and scan), its maps baked once, 2 frames:
                         plain torch but K4's per-pixel form
       demo_noise        demo_xla on demo_scene(with_noise=True) with
                         perlin_texture_3d(32) (demo.py --noise), 2 frames:
                         the texture sampled in the plain material volumes,
                         K4's per-pixel form
     and then the post stack on the fused frame (POST_PATHS), each frame's
     display image checked finite, in [0, 1] and not flat:
       post_bench        render_frame_post with bench.py's PostConfig
                         (exposure, bloom, vignette), 4 frames: K1-K4, no
                         K13
       post_showcase     demo.py's showcase frame loop, 4 frames, the camera
                         orbiting and the G-buffer rendered per frame: SSR,
                         multi-scale AO, SMAA, auto exposure with the adapted
                         luma carried across frames, lens distortion, DoF,
                         motion blur from camera_velocity, CA, grain,
                         grading, dither: K1-K4 and K13 (the SSR march)
       post_rest         2 frames of what the showcase leaves off: FXAA,
                         grade_luts, single-scale AO, taa_step threading its
                         history: K1-K4
     The shadow maps of the map paths are baked once per path, before the
     counters are reset, and passed to every frame (timed apart). Prints
     each float32 image checksum, checks that each image is finite and not
     flat, and holds the staged 4-frame image against the fused one, the
     pallas_composite image against the fused frame 1, fused_exact's and
     fused_vis's images and histories against exact's and vis_bake's bit for
     bit, and every second pixel of uhd's frame 2 against uhd_exact's; then
     edits the scene's camera position in place between two frames of a
     fresh fused renderer and holds the second frame against a fresh
     renderer's frame of the edited scene, bit for bit;
  5. holds each kernel against its plain-torch twin on the inputs of a real
     frame, with the tolerances stated in CHECKS (K12 at low and at full
     rate on map_dir's frame 4, and on its tables with a second sun, each
     sun of that one launch = the one-sun launch bit for bit; K13 on the SSR inputs of post_showcase's
     last frame, and its launch geometry; the plain XLA scatter of
     xla_scatter's, demo_xla's and demo_noise's last frames on the card
     against the same function on the CPU (tests/torch_tolerance.py's
     any-hit tolerance); on tex's frame 4 K1 (its radiance channels, the
     noise channels passed through bit for bit) and K2 reading the noise
     channels, the chain reproducing the path's image bit for bit, and the
     noise channels on the card against the same bake on the CPU; K6
     radiance x planes over the texture's material volumes on tex_staged's
     frame 2, K6 with no sun on sunless's frame 2, K9 and K6 baked x planes
     over zero material volumes on no_media's frame 2;
     K2 with rays and with baked visibility on fused_exact's and
     fused_vis's frame 2; K4 at 16x16-pixel cells and in its co-sited
     planes form on uhd_exact's frame 2; the terrain and fractional arms:
     K2 and K7 on demo_full's frame 4, K1 on demo_hf_local's, K5 and K6
     with rays on demo_exact_hf's and K9 on demo_vis_hf's frame 2, K1 and
     K2 on the fractional path's frame 2; at the demo grid K1, K2, K3 and
     K4's per-pixel form on demo_production's frame 4, which together
     reproduce the path's image bit for bit), checks that the terrain
     changes more of K7's elements, and the local terrain more of K1's,
     K6's and K9's, than each hold lets past (ARM_FRACTION tightens K1's
     and K6's), and shows that K7 then K10 gives K5's volume, K8 then
     K10 gives K3's and K5 then K6 give K2's history and scatter planes (with
     the radiance bake, rays and the baked visibility), bit for bit, and
     that K2's, K5's, K6's, K7's, K10's and K11's blocks, K2's, K5's, K10's
     and K11's shared memory, K8's tile, chunk, threads and shared memory,
     K12's tile and shared memory at 1-4 cascades, and K1's and K9's
     launch (blocks, samples and light groups a block, passes of lights,
     shared memory) and K13's tile, shared memory and unrolled taps are
     what the wrappers reckon; holds K1 and K9 on a
     scene with 40 local lights (two passes of K1's lights; ten of K9's a
     light group); logs each hold's largest
     difference and where it lies, each kernel's largest hold and, for K6,
     the twin's terms at that froxel (ROADMAP C8);
  6. times warm frames of the fused, staged, exact, history, vis_bake,
     map_dir, map, fused_exact, fused_vis, uhd_exact, uhd, demo, XLA
     scatter (and that scatter alone), texture, sunless and media-less
     paths (and the texture's plain noise bake and material volumes) and,
     with a fixed camera and G-buffer, frame +
     post and the post chain alone of post_bench and post_showcase (CUDA
     events and host wall, profiler windows), the shadow-map bake,
     each kernel (CUDA events around launches queued behind a device-side
     spin, so that the host's launch rate stays out), each twin, and
     torch.nn.functional.grid_sample as a yardstick for the composite (at
     1080p, at 4K, at the co-sited low-res pixels and at 720p on the demo
     grid); the bounds of the terrain modes count the terrain samples this
     run's rays take;
  7. the training path (inverse.py) at the demo grid's full width, each
     phase with the launch counters set to 0 just before and read just
     after:
       train_fog         DEMO_CONFIG (160x88x64 at 1280x720: map mode, its
                         maps baked once and passed in, the XLA scatter,
                         K4's per-pixel form) on demo_scene, 4 Adam steps
                         (lr 5e-2) of FogParams toward absorption 0.6
       train_lights      DEMO_CONFIG with shadow_mode="raycast" at 1280x704
                         (K4's 8x8 cells form) on the fractional scene, 4
                         steps of LightParams
       train_opacity     the same, 4 steps of OpacityParams
     each step launching K4 once and K14 (composite_grad) once and nothing
     else; each path's gradients finite and one non-zero, its last loss
     below its first, its first step's gradients held against the same step
     with K4 and K14 swapped for their twins, its forward, backward and Adam
     ms (CUDA events), the forward without grad, a profiler window of 2
     steps and the peak device memory printed; then
       k14               K14 against composite_grad_plain on seeded random
                         inputs: the per-pixel form at 1280x720 and the cells
                         form at 1280x704 on 160x88x64, and the cells form at
                         1920x1080 on 240x135x128, timed beside the twin, the
                         bound and grid_sample's backward
       train_sharded     make_sharded_train_step on a one-rank NCCL group
                         over 2 views (K4 and K14 twice each) = one
                         process's step over their mean loss
       checkpoint        demo_xla's state after its 2 frames saved and loaded
                         (checkpoint.py) renders the next frame bit for bit
       grad_refusals     FULL_CONFIG's frame with its fog requiring grad
                         raises NotImplementedError naming
                         frame_volume_fused, and launches nothing;
     K14 launches on no forward path (4., whose counts cover every kernel);
  8. prints the `kernels` JSON line, then the result line.

Every failure raises: the script exits 0 only if every phase passed.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

# bytes/s of HBM and fp32 (non-tensor-core) FLOP/s of an H100 SXM at its
# full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel -> (allowed |kernel - twin| per element: atol + rtol*|twin|, the
# largest fraction of elements allowed past it, why)
BOUNDARY = "shadow rays at primitive boundaries may flip"
SUMS = ("128-slice front-to-back sums of exp/log terms differ by a few ulp "
        "per slice")
CHECKS = {
    "bake_radiance": (1e-6, 1e-5, 1e-3,
                      "any-hit booleans may flip for rays within ulps of an "
                      "epsilon"),
    "shadow_scatter": (1e-6, 1e-5, 5e-3, BOUNDARY),
    "integrate_blend": (1e-6, 1e-4, 0.0, SUMS),
    "composite": (1e-6, 1e-5, 0.0, "log() ulps in the froxel z mapping"),
    "shadow_blend": (1e-6, 1e-5, 5e-3, BOUNDARY),
    "scatter": (1e-6, 1e-5, 5e-3, BOUNDARY),
    "dir_shadow": (1e-6, 1e-5, 5e-3, BOUNDARY),
    "integrate": (1e-6, 1e-4, 0.0, SUMS),
    "bake_visibility": (1e-6, 1e-5, 1e-3,
                        "any-hit booleans may flip for rays within ulps of "
                        "an epsilon"),
    "temporal_blend": (1e-6, 1e-5, 5e-3,
                       "a reprojection offset within ulps of a cell boundary "
                       "picks the neighbouring pair of taps, or flips the "
                       "success test"),
    "windowed_warp": (1e-6, 1e-5, 0.0,
                      "the same 8 taps and weights in the same order"),
    "pcf_shadow": (1e-6, 1e-5, 1e-3,
                   "a depth compare or a texel floor within ulps of its edge "
                   "may flip"),
    "ssr_march": (1e-6, 1e-5, 0.0, "the same taps in the same order"),
    "composite_grad": (1e-5, 1e-5, 0.0,
                       "atomics add a froxel's terms, from every pixel that "
                       "reads it, in an order that changes from run to run"),
}

# kernel -> file:line of the TPU kernel(s) it stands for
PALLAS = "volumetricrenderer_tpu/ops/pallas/"
REPLACES = {
    "bake_radiance": f"{PALLAS}frame_fused.py:124; {PALLAS}visibility.py:267",
    "shadow_scatter": f"{PALLAS}frame_fused.py:124",
    "integrate_blend": f"{PALLAS}frame_fused.py:124; "
                       f"{PALLAS}integrate_blend.py:41",
    "composite": f"{PALLAS}zg_composite.py:83; {PALLAS}zg_composite.py:126; "
                 f"{PALLAS}composite.py:61",
    "shadow_blend": f"{PALLAS}shadow_blend.py:32",
    "scatter": f"{PALLAS}scatter.py:380",
    "dir_shadow": f"{PALLAS}dir_shadow.py:77",
    "integrate": f"{PALLAS}integrate.py:58",
    "bake_visibility": f"{PALLAS}visibility.py:454; "
                       f"{PALLAS}frame_fused.py:124",
    "temporal_blend": f"{PALLAS}temporal.py:169",
    "windowed_warp": f"{PALLAS}warp.py:36",
    "pcf_shadow": f"{PALLAS}pcf_shadow.py:222",
    "ssr_march": f"{PALLAS}ssr.py:35",
    # no TPU kernel: the JAX package differentiates its XLA composites
    "composite_grad": "none; the adjoint of JAX's XLA composites "
                      "(volumetricrenderer_tpu/ops/tent_composite.py:28, "
                      "rowmm_composite.py:43, :147)",
}

# path -> (config changes from FULL_CONFIG, frames, kernels of the path; a
# kernel that a frame launches more than once is (name, launches per frame))
STAGED = dict(frame_fused=False)
VIS_BAKE = dict(STAGED, scatter_bake="vis")
HISTORY = dict(VIS_BAKE, temporal_blend_material=True,
               temporal_blend_scatter=True)
EXACT = dict(VIS_BAKE, raycast_shadow_subsample=1)
UHD = dict(image_width=3840, image_height=2160, composite_upsample=2)
MAP_DIR = dict(shadow_mode="map_dir")
MAP = dict(shadow_mode="map")
# one K12 launch per sun and frame (benchmark_scene has one sun)
MAP_DIR_KERNELS = ("pcf_shadow", "temporal_blend", "bake_radiance", "scatter",
                   "integrate_blend", "composite")
PATHS = {
    "fused": ({}, 4, ("bake_radiance", "shadow_scatter", "integrate_blend",
                      "composite")),
    "staged": (STAGED, 4, ("shadow_blend", "bake_radiance", "scatter",
                           "integrate_blend", "composite")),
    "exact": (EXACT, 2, ("shadow_blend", "scatter", "integrate_blend",
                         "composite")),
    "no_shadow_blend": (dict(STAGED, temporal_blend_shadow=False), 1,
                        ("dir_shadow", "bake_radiance", "scatter",
                         "integrate_blend", "composite")),
    "no_acc_blend": (dict(STAGED, temporal_blend_accumulation=False), 1,
                     ("shadow_blend", "bake_radiance", "scatter", "integrate",
                      "composite")),
    "history": (HISTORY, 4, (("windowed_warp", 2), "shadow_blend",
                             "bake_visibility", "scatter", "temporal_blend",
                             "composite")),
    "vis_bake": (VIS_BAKE, 2, ("shadow_blend", "bake_visibility", "scatter",
                               "integrate_blend", "composite")),
    "xla_shadow": (dict(HISTORY, dir_shadow_impl="xla"), 1,
                   (("windowed_warp", 2), ("temporal_blend", 2),
                    "bake_visibility", "scatter", "composite")),
    "map_dir": (MAP_DIR, 4, MAP_DIR_KERNELS),
    "map_dir_full_rate": (dict(MAP_DIR, dir_shadow_subsample=1), 1,
                          MAP_DIR_KERNELS),
    "map": (MAP, 2, ("pcf_shadow", "temporal_blend", "scatter",
                     "integrate_blend", "composite")),
    "map_gather": (dict(MAP, dir_shadow_impl="xla"), 1,
                   ("temporal_blend", "scatter", "integrate_blend",
                    "composite")),
    "pallas_composite": (dict(composite_impl="pallas"), 1,
                         ("bake_radiance", "shadow_scatter",
                          "integrate_blend", "composite")),
    "fused_exact": (dict(EXACT, frame_fused=True), 2,
                    ("shadow_scatter", "integrate_blend", "composite")),
    "fused_vis": (dict(VIS_BAKE, frame_fused=True), 2,
                  ("bake_visibility", "shadow_scatter", "integrate_blend",
                   "composite")),
    "uhd_exact": (dict(UHD, composite_upsample=1), 2,
                  ("bake_radiance", "shadow_scatter", "integrate_blend",
                   "composite")),
    "uhd": (UHD, 4, ("bake_radiance", "shadow_scatter", "integrate_blend",
                     "composite")),
    "xla_scatter": (dict(scatter_impl="xla"), 2,
                    ("shadow_blend", "temporal_blend", "composite")),
}


# post path -> (PostConfig fields, frames, kernels per frame); each renders
# the fused frame (FULL_CONFIG) under its post stack
FUSED_KERNELS = ("bake_radiance", "shadow_scatter", "integrate_blend",
                 "composite")
BENCH_POST = dict(exposure=1.0, bloom_strength=0.15, vignette=0.2)
SHOWCASE_POST = dict(exposure=1.1, bloom_strength=0.25, bloom_threshold=0.8,
                     vignette=0.25, chromatic_aberration=1.0, grain=0.02,
                     saturation=1.1, contrast=1.05, dof_focus_distance=20.0,
                     dof_aperture=11.0, dof_max_coc=3.0, motion_blur=0.4,
                     auto_exposure=True, ae_key=0.6, ae_min_ev=-2.0,
                     ae_max_ev=2.0, smaa=True, dithering=True,
                     lens_distortion=8.0, ao_intensity=0.5,
                     ao_multiscale=True, ssr_intensity=0.5)
REST_POST = dict(fxaa=True, ao_intensity=0.5, grade_luts=(
    (0.0, 0.25, 0.6, 1.0), (0.0, 0.5, 1.0), (0.05, 0.3, 0.7, 0.95)))
POST_PATHS = {
    "post_bench": (BENCH_POST, 4, FUSED_KERNELS),
    "post_showcase": (SHOWCASE_POST, 4, FUSED_KERNELS + ("ssr_march",)),
    "post_rest": (REST_POST, 2, FUSED_KERNELS),
}

# The reference demo scene (demo_scene: one sun, one red spot light,
# constant fog, analytic primitives over the procedural terrain, which every
# sun ray marches) and its variant with the first three boxes at opacity 0.5
# ("fractional"): path -> scene; their configs, frames and kernels join
# PATHS. demo_production is demo.py --production: DEMO_CONFIG with the
# production impl set at the demo grid, 160x88x64 froxels at 1280x720
# (720/88 is no integer: the per-pixel composite), ss=2.
PRODUCTION = dict(volume_width=160, volume_height=88, volume_depth=64,
                  image_width=1280, image_height=720,
                  raycast_shadow_subsample=2, dir_shadow_subsample=1)
HF_LOCAL = dict(heightfield_local_shadows=True)
# DEMO_CONFIG's fields where it differs from FULL_CONFIG (main() checks
# that FULL_CONFIG with them is DEMO_CONFIG)
DEMO_XLA = dict(volume_width=160, volume_height=88, volume_depth=64,
                image_width=1280, image_height=720, reproj_impl="windowed",
                shadow_mode="map", raycast_shadow_subsample=1,
                scatter_bake="vis", bake_procedural_noise=False,
                dir_shadow_subsample=1, scatter_impl="xla",
                material_impl="xla", dir_shadow_impl="xla",
                accumulate_impl="xla", composite_impl="tentmm",
                composite_precision="highest")
NO_SHADOW_BLEND_KERNELS = ("dir_shadow", "bake_radiance", "scatter",
                           "integrate_blend", "composite")
DEMO_PATHS = {
    "demo_full": ("demo", {}, 4, FUSED_KERNELS),
    "demo_production": ("demo", PRODUCTION, 4, FUSED_KERNELS),
    "demo_hf_local": ("demo", HF_LOCAL, 2, FUSED_KERNELS),
    "demo_exact_hf": ("demo", dict(EXACT, **HF_LOCAL), 2,
                      ("shadow_blend", "scatter", "integrate_blend",
                       "composite")),
    "demo_vis_hf": ("demo", dict(VIS_BAKE, frame_fused=True, **HF_LOCAL), 2,
                    ("bake_visibility", "shadow_scatter", "integrate_blend",
                     "composite")),
    "demo_no_shadow_blend": ("demo", dict(STAGED,
                                          temporal_blend_shadow=False), 1,
                             NO_SHADOW_BLEND_KERNELS),
    "demo_map_dir": ("demo", MAP_DIR, 2, MAP_DIR_KERNELS),
    "fractional": ("fractional", {}, 2, FUSED_KERNELS),
    "fractional_no_shadow_blend": ("fractional",
                                   dict(STAGED, temporal_blend_shadow=False),
                                   1, NO_SHADOW_BLEND_KERNELS),
    "anyres_xla": ("demo", dict(PRODUCTION, composite_impl="xla"), 1,
                   FUSED_KERNELS),
    "demo_xla": ("demo", DEMO_XLA, 2, ("composite",)),
}
# bench.py's texture frame and its staged forms (benchmark_scene with the
# fog sampling perlin_texture_3d()), demo.py --noise, and benchmark_scene
# without its sun or without media: path -> scene; their configs, frames
# and kernels join PATHS
STAGED_KERNELS = ("shadow_blend", "bake_radiance", "scatter",
                  "integrate_blend", "composite")
SCENE_PATHS = {
    "tex": ("tex", {}, 4, FUSED_KERNELS),
    "tex_staged": ("tex", STAGED, 2, STAGED_KERNELS),
    "tex_lowres": ("tex", dict(STAGED, texture_noise_subsample=4), 1,
                   STAGED_KERNELS),
    "demo_noise": ("demo_noise", DEMO_XLA, 2, ("composite",)),
    "sunless": ("sunless", {}, 2, ("temporal_blend", "bake_radiance",
                                   "scatter", "integrate_blend",
                                   "composite")),
    "no_media": ("no_media", {}, 2, ("shadow_blend", "bake_visibility",
                                     "scatter", "integrate_blend",
                                     "composite")),
}
# the paths of the plain XLA scatter, whose last frame's scatter is held
# against the same function on the CPU
XLA_SCATTER_PATHS = ("xla_scatter", "demo_xla", "demo_noise")
PATHS.update({name: v[1:] for name, v in DEMO_PATHS.items()})
PATHS.update({name: v[1:] for name, v in SCENE_PATHS.items()})
# (kernel, mode) of the terrain and fractional arms, of the demo grid
# (160x88x64, its low grid 80x44x32 at ss=2) and of K4's per-pixel form ->
# the paths that launch it in that mode
ARM_PATHS = {
    ("bake_radiance", "terrain_local"): ("demo_hf_local",),
    ("bake_radiance", "demo_grid"): ("demo_production", "anyres_xla"),
    ("bake_radiance", "fractional"): ("fractional",
                                      "fractional_no_shadow_blend"),
    ("shadow_scatter", "terrain"): ("demo_full", "demo_hf_local"),
    ("shadow_scatter", "demo_grid"): ("demo_production", "anyres_xla"),
    ("shadow_scatter", "fractional"): ("fractional",),
    ("integrate_blend", "demo_grid"): ("demo_production", "anyres_xla"),
    ("shadow_blend", "terrain"): ("demo_exact_hf",),
    ("scatter", "rays_terrain"): ("demo_exact_hf",),
    ("dir_shadow", "terrain"): ("demo_no_shadow_blend",
                                "fractional_no_shadow_blend"),
    ("bake_visibility", "terrain_local"): ("demo_vis_hf",),
    ("composite", "pixels_720p"): ("demo_production", "anyres_xla",
                                   "demo_xla", "demo_noise"),
    # K1 with a texture medium: the radiance channels alone (tex, where the
    # noise channels come from the plain bake, and the staged texture paths,
    # which bake none); K2 reading the texture's noise channel; K6 with no
    # sun term
    ("bake_radiance", "texture"): ("tex", "tex_staged", "tex_lowres"),
    ("shadow_scatter", "texture"): ("tex",),
    ("scatter", "no_sun"): ("sunless",),
}
# K6's modes held and timed on the inputs of a real frame -> the paths that
# launch the kernel in that mode
K6_MODE_PATHS = {"baked_planes": ("history", "xla_shadow", "no_media"),
                 "baked_fused": ("vis_bake",),
                 "radiance_planes": ("tex_staged", "tex_lowres")}
# (kernel, mode) -> the fraction of elements allowed past CHECKS' tolerance
# where it is below the kernel's: on demo_scene the local terrain changes
# only the few elements where the red spot light's cone meets the ground,
# fewer than K1's 1e-3 and K6's 5e-3 would let past, so those holds would
# pass a kernel that ignores the arm; main() checks that each local-terrain
# arm changes a larger share of its elements than its hold lets past
ARM_FRACTION = {
    ("bake_radiance", "terrain_local"): 1e-4,
    ("scatter", "rays_terrain"): 1e-4,
}


# The slab paths: make_multislab_render (parallel/shard_render.py) over n
# H-sharded slabs of 240x135x128 froxels at 1920x1080 (bench.py's slab
# scopes), each shard a halo-extended slab of 135/n + 12 froxel rows
# starting at global row 135 i/n - 6 and a band of 1080/n image rows, its
# G-buffer band bound as fixed_inputs: path -> (config changes from
# FULL_CONFIG, shards, frames, kernels launched once per shard and frame).
# slab3_staged is tests/test_shard_render.py's CFG impl set at full width:
# plain material volumes, K5, K6 with per-light rays, K3, and K4's
# per-pixel form (JAX's slab composite_rowmm).
SLAB_STAGED = dict(temporal_blend_alpha=0.6, raycast_shadow_subsample=1,
                   scatter_bake="vis", bake_procedural_noise=False,
                   dir_shadow_subsample=1, material_impl="xla",
                   composite_impl="tentmm", composite_precision="highest")
SLAB_PATHS = {
    "slab3": ({}, 3, 4, FUSED_KERNELS),
    "slab5": ({}, 5, 4, FUSED_KERNELS),
    "slab3_staged": (SLAB_STAGED, 3, 2, ("shadow_blend", "scatter",
                                         "integrate_blend", "composite")),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, n: int, spin: bool = False) -> float:
    """Mean device time of fn() over n calls after one warm-up call.
    spin=True, for a single kernel's wrapper: the device first spins for a
    few ms, so that the host queues every launch behind it and the events
    see the kernels alone; without that a kernel shorter than its wrapper's
    ~60 us of host work is timed at the host's launch rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_time_ms(fn, n: int) -> float:
    return cuda_time_ms(fn, n, spin=True)


# kernel -> (max abs err, hold label, index of that element, share past
# the tolerance, kernel - twin there) of the hold with the largest
# difference so far
LARGEST = {}


def compare(name: str, got: torch.Tensor, want: torch.Tensor,
            mode: str = "", label: str = "") -> float:
    """Check a kernel output against its twin per CHECKS (a mode in
    ARM_FRACTION lets fewer elements past); returns the max abs error and
    keeps the hold (`label`, else the mode) in LARGEST if its difference is
    the kernel's largest."""
    atol, rtol, frac_ok, why = CHECKS[name]
    frac_ok = ARM_FRACTION.get((name, mode), frac_ok)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    frac = float((err > atol + rtol * want.abs()).float().mean())
    max_err = float(err.max())
    label = label or mode or "main"
    at = tuple(int(v) for v in torch.unravel_index(err.argmax(), err.shape))
    if max_err > LARGEST.get(name, (-1.0,))[0]:
        LARGEST[name] = (max_err, label, at, frac,
                         float(got[at]) - float(want[at]))
    log(f"# check {name} ({label}): max_abs_err {max_err:.3e} at {at}, "
        f"fraction past atol {atol:g} + rtol {rtol:g} = {frac:.2e} (allowed "
        f"{frac_ok:g}: {why})")
    if frac > frac_ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_err


def scatter_terms(sca, vis, mtl, inputs, largest) -> str:
    """An account of K6's largest difference from its twin: the twin's
    terms at that element's froxel, from scatter_slice on its slice --
    sigma_s, the sun term and the local lights' term and, in the per-light
    modes, each light's contribution unshadowed x its gate (what a flip of
    its any-hit changes) against the difference."""
    t, shadow, bake, vis_vol, mat = inputs
    _, lab, (c, z, y, x), _, diff = largest
    zs = torch.tensor([[[z]]], device=shadow.device)
    up = lambda v: vis.upsample_low(v, zs, t.ss, t.tent_x, t.tent_y)
    planes = None if mat is None else (
        mat[0][0, z:z + 1], mat[0][1, z:z + 1], mat[0][2, z:z + 1],
        mat[1][0, z:z + 1])
    radiance = noise = local = None
    if bake is not None:
        radiance = up(bake[:3])
        if t.n_noise and mat is None:
            noise = list(up(bake[3:3 + t.n_noise]))
    else:
        active = sca.schedule_mask(t.order, t.count).T[:, z:z + 1, None,
                                                         None]
        local = (t.lights, active, t.planes, t.spheres, t.boxes,
                 t.occluders(local=True),
                 None if vis_vol is None else up(vis_vol))

    def run(n_dir, local_):
        out = sca.scatter_slice(
            t.spar, t.dirs, t.med, t.media_static, zs,
            [p[z:z + 1] for p in shadow], radiance, noise,
            grid_whd=t.grid_whd, n_dir=n_dir, h_glob=t.h_glob,
            jitter_dir=t.jitter_dir, local=local_, material=planes)
        return [float(v[0, y, x]) for v in out[:3]]

    full, lights = run(t.n_dir, local), run(0, local)
    if planes is None:
        wx, wy, wz = sca.froxel_world(t.spar, zs, t.grid_whd, t.h_glob)
        sigma = mtl.material_planes(t.med, t.media_static, wx, wy, wz,
                                    noise_planes=noise)[:3]
    else:
        sigma = planes[:3]
    sigma = [float(v[0, y, x]) for v in sigma]
    fmt = lambda vals: "(" + ", ".join(f"{v:.4e}" for v in vals) + ")"
    text = (f"# largest difference of scatter: hold {lab!r}, froxel (z, y, "
            f"x) = ({z}, {y}, {x}), plane {'rgbe'[c]}, kernel - twin "
            f"{diff:.3e}; the twin there: sigma_s {fmt(sigma)}, sun term "
            f"{fmt([f - l for f, l in zip(full, lights)])}, local lights' "
            f"term {fmt(lights)}")
    if c < 3 and local is not None:
        ones = [torch.ones_like(shadow[0][z:z + 1])] * t.lights.shape[0]
        flips = []
        for li in range(t.lights.shape[0]):
            only = torch.zeros_like(active)
            only[li] = active[li]
            contrib = run(0, (local[0], only, *local[2:6], ones))
            flips.append(contrib[c] * float(t.lights[li, 14]))
        li = min(range(len(flips)), key=lambda j: abs(abs(diff) - flips[j]))
        text += (f"; light {li}'s contribution unshadowed x gate there "
                 f"{flips[li]:.3e} (difference / that = "
                 f"{diff / flips[li] if flips[li] else float('nan'):.4f}): "
                 f"the nearest flip of one light's shadow")
    return text


def profile_frames(step, n: int) -> None:
    """torch.profiler over n warm frames: device busy share of the window
    and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if not kern or busy_ms <= 0.0:
        log("# profile: no device time recorded (device busy share not "
            "measured)")
        return
    log(f"# profile over {n} frames: window {window_ms / n:.3f} ms/frame "
        f"(host clock, profiler on), device busy {busy_ms / n:.3f} "
        f"ms/frame = {busy_ms / window_ms:.1%}, {len(kern)} kernel names, "
        f"{sum(e.count for e in kern) / n:.0f} launches/frame")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"#   {e.self_device_time_total / 1e3 / n:8.4f} ms/frame "
            f"x{e.count // n:<4d} {e.key[:90]}")


def drive(name: str, renderer, scene, scene_color, view_depth, cuda,
          shadow_data):
    """Render path `name` from a fresh state with the launch counters set to
    0 just before and read just after; check that exactly the path's kernels
    ran, as often per frame as PATHS says, and that the image is finite and
    not flat. Returns
    (last image, the states before each frame and after the last, counts)."""
    _, n_frames, expect = PATHS[name]
    expect = dict(k if isinstance(k, tuple) else (k, 1) for k in expect)
    state = renderer.init_state(scene.dir_lights.count)
    torch.cuda.synchronize()
    cuda.reset_launches()
    states = [state]
    img = None
    for i in range(n_frames):
        img, _, state = renderer.render_frame(state, scene, 0.1 * i,
                                              scene_color, view_depth,
                                              shadow_data)
        states.append(state)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"# {name}: launches in the {n_frames}-frame run: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for k in cuda.SOURCES:
        if launches[k] != n_frames * expect.get(k, 0):
            raise AssertionError(
                f"path {name}: kernel {k} launched {launches[k]} times in "
                f"{n_frames} frames (on the path: {k in expect})")
    checksum = float(img.sum(dtype=torch.float32))
    std = float(img[..., :3].std())
    log(f"# {name}: image {tuple(img.shape)} checksum {checksum!r} "
        f"std {std:.4g}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"path {name}: non-finite frame output")
    if not std > 1e-4:
        raise AssertionError(f"path {name}: degenerate frame output")
    return img, states, launches


def slab_scene(scene, i: int):
    """Frame i of the slab paths: the camera moved i steps right, up and
    forward, so that each frame's persistent halos carry reprojected
    history."""
    cam = scene.camera
    step = torch.tensor([0.1, 0.08, 0.1], device=cam.position.device)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        cam, position=cam.position + i * step))


def drive_slab(name: str, fn, scene, cuda):
    """Render slab path `name` through its multislab fn from its first
    carry (frame i on slab_scene(scene, i)) with the launch counters set
    to 0 just before and read just after. Each shard's step is counted on
    its own (the counters read around the shards' render_frame calls): it
    must launch each of the path's kernels once and no other kernel, and
    its counts are summed by the y phase of its frame tables. Checks that
    the image put together from the bands is finite and not flat. Returns
    (last image, its bands, the carries before each frame and after the
    last, counts, {y phase: counts of the shards of that phase})."""
    _, n_sh, n_frames, expect = SLAB_PATHS[name]
    r_loc = fn.renderer
    render_frame, frame_tables = r_loc.render_frame, r_loc.frame_tables
    seen, by_phase = {}, {}

    def counted_tables(*args, **kw):
        out = frame_tables(*args, **kw)
        seen["phase"] = int(float(out[0].spar[0, 24]))
        return out

    def counted_frame(*args, **kw):
        before = dict(cuda.LAUNCHES)
        out = render_frame(*args, **kw)
        delta = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.SOURCES}
        for k, v in delta.items():
            if v != (k in expect):
                raise AssertionError(
                    f"path {name}: a shard's step launched kernel {k} {v} "
                    f"times (on the path: {k in expect})")
        counts = by_phase.setdefault(seen.pop("phase"), {})
        for k, v in delta.items():
            counts[k] = counts.get(k, 0) + v
        return out

    carry = fn.init_carry(scene.dir_lights.count)
    scenes = [slab_scene(scene, i) for i in range(n_frames)]
    r_loc.render_frame, r_loc.frame_tables = counted_frame, counted_tables
    try:
        torch.cuda.synchronize()
        cuda.reset_launches()
        carries = [carry]
        bands = None
        for i in range(n_frames):
            bands, carry = fn(carry, scenes[i], 0.1 * i)
            carries.append(carry)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
    finally:
        del r_loc.render_frame, r_loc.frame_tables
    nonzero = lambda c: {k: v for k, v in c.items() if v}
    phased = {ph: nonzero(c) for ph, c in sorted(by_phase.items())}
    log(f"# {name}: launches in the {n_frames}-frame run of {n_sh} "
        f"shards: {json.dumps(nonzero(launches))}; by the shards' y phase: "
        f"{json.dumps(phased)}")
    for k in cuda.SOURCES:
        if launches[k] != n_frames * n_sh * (k in expect) or launches[k] \
                != sum(c[k] for c in by_phase.values()):
            raise AssertionError(
                f"path {name}: kernel {k} launched {launches[k]} times in "
                f"{n_frames} frames of {n_sh} shards (on the path: "
                f"{k in expect})")
    img = torch.cat(bands)
    std = float(img[..., :3].std())
    log(f"# {name}: image {tuple(img.shape)} from {n_sh} bands of "
        f"{tuple(bands[0].shape)}, checksum "
        f"{float(img.sum(dtype=torch.float32))!r} std {std:.4g}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"path {name}: non-finite frame output")
    if not std > 1e-4:
        raise AssertionError(f"path {name}: degenerate frame output")
    return img, bands, carries, launches, by_phase


def orbit(scene, i: int):
    """demo.py's showcase camera: frame i orbits the start position."""
    ang = 0.04 * i
    cam = scene.camera
    pos = torch.tensor([-0.4 + 4.0 * math.sin(ang), 1.9,
                        -15.8 + 2.0 * (1 - math.cos(ang))],
                       device=cam.position.device)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        cam, position=pos))


def post_frame(name: str, renderer, post, cfg, state, scene, time_x,
               scene_color, view_depth, carry):
    """One frame of post path `name`, as its user runs it. carry is what the
    path threads across frames (post_showcase: the adapted luma; post_rest:
    the TAA history). Returns (display rgb, new state, new carry)."""
    if name == "post_bench":
        rgb, _, new_state = renderer.render_frame_post(
            state, scene, cfg, time_x, scene_color, view_depth)
        return rgb, new_state, carry
    image, aux, new_state = renderer.render_frame(state, scene, time_x,
                                                  scene_color, view_depth)
    vd = aux["view_depth"]
    cam = scene.camera
    vel = post.camera_velocity(vd, cam.fov_y, cam.aspect, cam.view_to_world(),
                               state.prev_world_to_view)
    planes = [image[..., c] for c in range(3)]
    if name == "post_showcase":
        scale, carry = post.auto_exposure_step(planes, carry, cfg)
        rgb = post.apply_post(image, cfg, view_depth=vd, velocity=vel,
                              exposure_scale=scale,
                              dither_frame=state.frame_count)
        return rgb, new_state, carry
    planes, carry = post.taa_step(planes, carry, vel, cfg)
    return (torch.stack(post.apply_post_planes(planes, cfg, vd, vel), -1),
            new_state, carry)


def drive_post(name: str, renderer, post, scene, scene_color, view_depth,
               cuda):
    """Render post path `name` from a fresh state with the launch counters
    set to 0 just before and read just after; post_showcase orbits the
    camera and renders its G-buffer per frame, as demo.py does. Checks the
    launch counts and that every display image is finite, in [0, 1] and not
    flat. Returns (last display image, the states, counts)."""
    kw, n_frames, expect = POST_PATHS[name]
    cfg = post.PostConfig(**kw)
    state = renderer.init_state(scene.dir_lights.count)
    carry = torch.ones((), device="cuda") if name == "post_showcase" \
        else None
    torch.cuda.synchronize()
    cuda.reset_launches()
    states = [state]
    outs = []
    for i in range(n_frames):
        if name == "post_showcase":
            rgb, state, carry = post_frame(name, renderer, post, cfg, state,
                                           orbit(scene, i), 0.1 * i, None,
                                           None, carry)
        else:
            rgb, state, carry = post_frame(name, renderer, post, cfg, state,
                                           scene, 0.1 * i, scene_color,
                                           view_depth, carry)
        outs.append(rgb)
        states.append(state)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"# {name}: launches in the {n_frames}-frame run: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")
    for k in cuda.SOURCES:
        if launches[k] != n_frames * (k in expect):
            raise AssertionError(
                f"path {name}: kernel {k} launched {launches[k]} times in "
                f"{n_frames} frames (on the path: {k in expect})")
    for i, rgb in enumerate(outs):
        std = float(rgb.std())
        log(f"# {name} frame {i + 1}: display {tuple(rgb.shape)} checksum "
            f"{float(rgb.sum(dtype=torch.float32))!r} std {std:.4g}"
            + (f", adapted luma {float(carry):.5f}"
               if name == "post_showcase" and i == n_frames - 1 else ""))
        if rgb.shape != (*view_depth.shape, 3):
            raise AssertionError(f"path {name}: display shape {rgb.shape}")
        if not bool(torch.isfinite(rgb).all()):
            raise AssertionError(f"path {name}: non-finite display image")
        if not (float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0):
            raise AssertionError(f"path {name}: display outside [0, 1]")
        if not std > 1e-3:
            raise AssertionError(f"path {name}: degenerate display image")
    return outs[-1], states, launches


def frame_times(name: str, renderer, scene, scene_color, view_depth, state,
                n: int, shadow_data=None):
    """Warm frames of one path: (device-event mean ms, host wall mean ms)."""
    st = state

    def one_frame():
        nonlocal st
        _, _, st = renderer.render_frame(st, scene, 0.5, scene_color,
                                         view_depth, shadow_data)

    frame_ms = cuda_time_ms(one_frame, n)
    t0 = time.perf_counter()
    for _ in range(n):
        one_frame()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"# {name} frame: {frame_ms:.3f} ms device-event mean, "
        f"{wall_ms:.3f} ms host wall mean over {n} warm frames")
    return one_frame, st


def step_times(label: str, fn, n: int) -> None:
    """Warm calls of fn: device-event mean and host-wall mean, in ms."""
    ev_ms = cuda_time_ms(fn, n)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    log(f"# {label}: {ev_ms:.3f} ms device-event mean, {wall_ms:.3f} ms host "
        f"wall mean over {n} warm calls")


def two_suns(t, atlas):
    """K12's tables and atlases of one sun with a second sun after it, made
    from the first: its slices' schedules rolled by a third of the grid,
    its atlas mirrored in u and its shadow strength another, so that a
    sun's offsets into the tables are seen."""
    d = t.grid_whd[2]
    roll = lambda v: torch.roll(v, d // 3, dims=1)
    par2 = t.par.clone()
    par2[:, 20] = 0.3
    cat = lambda a, b: torch.cat([a, b]).contiguous()
    t2 = dataclasses.replace(
        t, par=cat(t.par, par2), coef=cat(t.coef, roll(t.coef)),
        order=cat(t.order, roll(t.order)), count=cat(t.count, roll(t.count)),
        spheres=cat(t.spheres, t.spheres))
    return t2, cat(atlas, atlas.flip(-1))


def fractional_scene(demo, geometry_cls):
    """demo_scene with its first three boxes at shadow opacity 0.5, built
    with Geometry.create's (min, max, albedo, opacity) boxes."""
    g = demo.geometry
    rows = lambda *ts: list(zip(*(t.tolist() for t in ts)))
    boxes = [(*b, 0.5 if i < 3 else 1.0)
             for i, b in enumerate(rows(g.box_min, g.box_max,
                                        g.box_albedo))]
    hf = dict(amp=float(g.hf_amp), base=float(g.hf_base),
              tiling=g.hf_tiling.tolist(), offset=g.hf_offset.tolist(),
              albedo=g.hf_albedo.tolist(), octaves=g.hf_octaves,
              period=g.hf_period, seed=g.hf_seed, steps=g.hf_steps,
              far=g.hf_far)
    geom = geometry_cls.create(
        planes=rows(g.plane_normal, g.plane_d, g.plane_albedo),
        spheres=rows(g.sphere_center, g.sphere_radius, g.sphere_albedo),
        boxes=boxes, heightfield=hf, device=g.box_min.device)
    if not geom.box_fractional:
        raise AssertionError("the fractional scene has no fractional box")
    return dataclasses.replace(demo, geometry=geom)


# The training paths (inverse.py): path -> (config changes from
# DEMO_CONFIG, scene, the parameters trained, K4's and K14's form). Each
# takes TRAIN_STEPS Adam steps (lr TRAIN_LR) through make_train_step's step,
# one K4 and one K14 launch a step and no other kernel.
RAYCAST_704 = dict(shadow_mode="raycast", image_height=704)
TRAIN_PATHS = {
    "train_fog": ({}, "demo", "fog", "pixels"),
    "train_lights": (RAYCAST_704, "fractional", "lights", "cells"),
    "train_opacity": (RAYCAST_704, "fractional", "opacity", "cells"),
}
TRAIN_STEPS = 4
TRAIN_LR = 5e-2
# K14's forms held and timed on seeded random inputs: form -> (K4's form,
# (IH, IW), grid (W, H, D), what the training paths run it on)
K14_FORMS = {
    "pixels_720p": ("pixels", (720, 1280), (160, 88, 64), "train_fog"),
    "cells_704p": ("cells", (704, 1280), (160, 88, 64),
                   "train_lights, train_opacity, train_sharded"),
    "cells_1080p": ("cells", (1080, 1920), (240, 135, 128),
                    "checked and timed only"),
}


def train_setup(kind, inverse, scene):
    """(parameters, apply_fn, the target's scene) of a training path: the
    fog toward absorption 0.6; the lights toward a spot light 3x as bright
    and moved 1 m and a sun 1.3x as bright; the first three boxes'
    opacities toward (0.35, 0.8, 1.0) from 0.5."""
    if kind == "fog":
        params = inverse.FogParams.from_medium(scene.media[0])
        with torch.no_grad():
            t = inverse.FogParams.from_medium(scene.media[0])
            t.log_absorption.fill_(math.log(0.6))
        return params, inverse.scene_with_fog, inverse.scene_with_fog(
            t, scene)
    if kind == "lights":
        params = inverse.LightParams.from_scene(scene)
        with torch.no_grad():
            t = inverse.LightParams.from_scene(scene)
            t.spot_position.add_(torch.tensor([1.0, 0.0, 0.0],
                                              device=t.spot_position.device))
            t.spot_log_ci.add_(math.log(3.0))
            t.dir_log_ci.add_(math.log(1.3))
        return params, lambda p, s: p.apply(s), t.apply(scene)
    params = inverse.OpacityParams.from_scene(scene)
    with torch.no_grad():
        t = inverse.OpacityParams.from_scene(scene)
        o = torch.full_like(t.logit_opacity, 1.0 - 1e-3)
        o[:3] = torch.tensor([0.35, 0.8, 1.0 - 1e-3], device=o.device)
        t.logit_opacity.copy_(torch.log(o / (1.0 - o)))
    return params, lambda p, s: p.apply(s), t.apply(scene)


def leaf_grads(params):
    return {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for n, p in params.named_parameters()}


def train_path(name, renderer, scene, scene_color, view_depth, shadow_data,
               inverse, cuda, zg):
    """Train path `name`: TRAIN_STEPS steps of make_train_step from a fresh
    state with the launch counters set to 0 just before and read just
    after; each step must launch K4 once and K14 once and nothing else.
    Holds the first step's gradients against the same step with K4 and K14
    swapped for their twins (|g - g_twin| <= 1e-4 max|g_twin| + 1e-12 a
    leaf: K14's atomics and K4's log() ulps), checks that every gradient is
    finite, that one is non-zero and that the last loss is below the first;
    times forward, backward and the Adam step with CUDA events, the forward
    without grad, and profiles 2 steps (device busy, launches a step), and
    reports the peak device memory. Returns (launches, record)."""
    import copy
    kind = TRAIN_PATHS[name][2]
    params, apply_fn, target_scene = train_setup(kind, inverse, scene)
    state = renderer.init_state(scene.dir_lights.count)
    with torch.no_grad():
        target = renderer.render_frame(state, target_scene, 0.0, scene_color,
                                       view_depth, shadow_data)[0][..., :3]
    target = target.contiguous()
    # the first step's gradients with the twins
    twin_params = copy.deepcopy(params)
    real = zg._k4, zg._k14
    zg._k4 = lambda form, *a: (zg.composite_plain if form == "cells"
                               else zg.composite_pixels_plain)(*a)
    zg._k14 = lambda form, g, sc, vd, p, grid: zg.composite_grad_plain(
        g, sc, vd, p, grid, form)
    try:
        inverse.image_loss(renderer, apply_fn(twin_params, scene), state,
                           target, scene_color, view_depth,
                           shadow_data).backward()
    finally:
        zg._k4, zg._k14 = real
    twin = leaf_grads(twin_params)

    opt = torch.optim.Adam(params.parameters(), lr=TRAIN_LR,
                           betas=(0.9, 0.999), eps=1e-8)
    step = inverse.make_train_step(renderer, opt, apply_fn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    cuda.reset_launches()
    losses, first = [], None
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        before = dict(cuda.LAUNCHES)
        loss = step(params, scene, state, target, scene_color, view_depth,
                    shadow_data)
        delta = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.SOURCES}
        want = {k: int(k in ("composite", "composite_grad"))
                for k in cuda.SOURCES}
        if delta != want:
            raise AssertionError(
                f"path {name}: step {i} launched "
                f"{ {k: v for k, v in delta.items() if v} }, not K4 and K14 "
                "once each")
        if i == 0:
            first = leaf_grads(params)
        losses.append(float(loss))
    torch.cuda.synchronize()
    step_wall = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
    launches = dict(cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    log(f"# {name}: launches in the {TRAIN_STEPS}-step run: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}; losses "
        f"{[f'{v:.6e}' for v in losses]}")
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"path {name}: the loss did not fall: {losses}")
    nonzero = False
    for n, g in first.items():
        w = twin[n]
        if not (bool(torch.isfinite(g).all())
                and bool(torch.isfinite(w).all())):
            raise AssertionError(f"path {name}: non-finite gradient {n}")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        nonzero = nonzero or float(g.abs().max() if g.numel() else 0) > 0
        log(f"# {name}: gradient {n} {tuple(g.shape)} max |g| "
            f"{float(g.abs().max()) if g.numel() else 0.0:.4e}, max |g - "
            f"g_twin| {err:.3e} (allowed 1e-4 max|g_twin| + 1e-12 = "
            f"{1e-4 * scale + 1e-12:.3e})")
        if err > 1e-4 * scale + 1e-12:
            raise AssertionError(f"path {name}: gradient {n} disagrees with "
                                 "the twins' step")
    if not nonzero:
        raise AssertionError(f"path {name}: every gradient is zero")
    # the step's parts, timed with CUDA events over 3 more steps
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = {"forward": 0.0, "backward": 0.0, "adam": 0.0}
    n = 3
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = inverse.image_loss(renderer, apply_fn(params, scene), state,
                                  target, scene_color, view_depth,
                                  shadow_data)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k] += ev[a].elapsed_time(ev[b]) / n
    # the forward without grad (the frame alone), and a profiler window
    # over 2 steps: device busy, launches a step, the kernels' shares
    with torch.no_grad():
        no_grad = cuda_time_ms(lambda: inverse.image_loss(
            renderer, apply_fn(params, scene), state, target, scene_color,
            view_depth, shadow_data), n)
    log(f"# {name}: the same forward without grad {no_grad:.3f} ms (CUDA "
        f"events, mean of {n})")
    profile_frames(lambda: step(params, scene, state, target, scene_color,
                                view_depth, shadow_data), 2)
    record = dict(parts, step_wall_ms=step_wall, peak_bytes=peak,
                  losses=losses, forward_no_grad_ms=no_grad)
    log(f"# {name} step: forward {parts['forward']:.3f} ms, backward "
        f"{parts['backward']:.3f} ms, Adam {parts['adam']:.3f} ms "
        f"(CUDA events, mean of {n}); {step_wall:.3f} ms host wall a step "
        f"over the counted run; peak device memory of the steps "
        f"{peak / 2**20:.1f} MiB above the {held / 2**20:.1f} MiB the run "
        "held before them")
    return launches, record


def k14_forms(zg, froxel, camera, sample_grid, bound):
    """K14 against composite_grad_plain in each of K14_FORMS on seeded random
    inputs (a torch.Generator): a gradient in [-1, 1], a scene in [0, 1],
    depths from the near plane to 140 (past the volume's far end); its
    time, the twin's, the bound and, as the library yardstick, the backward
    of grid_sample (3D, border) at the same sample points. Returns form ->
    (max abs err, ms, plain ms, library ms, (bytes, operations))."""
    dev = camera.position.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    out = {}
    for form, (k4_form, (ih, iw), grid, _) in K14_FORMS.items():
        w, h, d = grid
        p = froxel.make_froxel_params(camera.fov_y, camera.aspect,
                                      camera.near, 100.0, 0.5, grid)
        rnd = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        g_img = (rnd(ih, iw, 4) * 2.0 - 1.0).contiguous()
        sc = rnd(ih, iw, 3).contiguous()
        vd = (float(camera.near) + rnd(ih, iw) * 140.0).contiguous()
        args = (g_img, sc, vd, p, grid, k4_form)
        got = zg.composite_grad(*args)
        err = compare("composite_grad", got, zg.composite_grad_plain(*args),
                      form)
        ms = kernel_time_ms(lambda: zg.composite_grad(*args), 20)
        plain = cuda_time_ms(lambda: zg.composite_grad_plain(*args), 2)
        vol = torch.zeros((1, 4, d, h, w), device=dev, requires_grad=True)
        res = torch.nn.functional.grid_sample(
            vol, sample_grid(p, vd, d), mode="bilinear",
            padding_mode="border", align_corners=False)
        g_out = zg._grad_of_v(g_img, sc)[None, :, None].contiguous()
        lib = kernel_time_ms(lambda: torch.autograd.grad(
            res, vol, g_out, retain_graph=True), 20)
        n_pix, n_fro = ih * iw, w * h * d
        work = (n_pix * (16 + 4 + 12) + 16 * n_fro, 70 * n_pix)
        b_ms, b_by = bound(*work)
        log(f"# composite_grad, {form} ({k4_form}, {iw}x{ih} on "
            f"{w}x{h}x{d}): {ms:.4f} ms/launch, plain {plain:.3f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} ({work[0] / 1e6:.1f} MB), grid_sample "
            f"backward {lib:.4f} ms")
        out[form] = (err, ms, plain, lib, work)
    return out


def train_sharded(renderer, scene, scene_color, view_depth, inverse,
                  cuda):
    """make_sharded_train_step on a one-rank NCCL group over 2 views (the
    camera moved for the second) against one process's step over their
    mean loss, each from the same fog and a fresh Adam: the loss and the
    updated parameters to 1e-6 relative (K14's atomics)."""
    import copy
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dev = view_depth.device
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        params = inverse.FogParams.from_medium(scene.media[0])
        ref = copy.deepcopy(params)
        cam = scene.camera.position
        cams = torch.stack([cam, cam + torch.tensor([0.3, 0.1, 0.4],
                                                    device=cam.device)])
        st = renderer.init_state(scene.dir_lights.count)
        targets = torch.full((2, *view_depth.shape, 3), 0.2, device=dev)
        colors = torch.stack([scene_color] * 2)
        depths = torch.stack([view_depth] * 2)
        adam = lambda p: torch.optim.Adam(p.parameters(), lr=TRAIN_LR,
                                          betas=(0.9, 0.999), eps=1e-8)
        step = inverse.make_sharded_train_step(renderer, adam(params))
        torch.cuda.synchronize()
        cuda.reset_launches()
        loss = float(step(params, scene, st, cams, targets, colors, depths))
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        log(f"# train_sharded: launches in the step over 2 views: "
            f"{json.dumps(launches)}")
        if launches != {"composite": 2, "composite_grad": 2}:
            raise AssertionError("train_sharded: the step over 2 views must "
                                 "launch K4 and K14 twice each and nothing "
                                 "else")
        opt = adam(ref)
        views = [dataclasses.replace(scene, camera=dataclasses.replace(
            scene.camera, position=cams[i])) for i in range(2)]
        ref_loss = torch.stack([inverse.render_loss(
            renderer, ref, views[i], st, targets[i], colors[i], depths[i])
            for i in range(2)]).mean()
        ref_loss.backward()
        opt.step()
        ref_loss = float(ref_loss.detach())
    finally:
        dist.destroy_process_group()
    errs = {n: float(((p - q).abs() / q.abs().clamp(min=1e-30)).max())
            for (n, p), q in zip(params.named_parameters(),
                                 ref.parameters())}
    rel = abs(loss - ref_loss) / abs(ref_loss)
    log(f"# train_sharded: loss {loss!r} vs one process {ref_loss!r} "
        f"(relative {rel:.2e}); parameters' largest relative difference "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        "(allowed 1e-6)")
    if rel > 1e-6 or max(errs.values()) > 1e-6:
        raise AssertionError("the sharded step differs from one process's "
                             "step over both views")
    return launches


def k14_entry(k14, train_launches, replaces, bound):
    """The `kernels` JSON entry of K14: the per-pixel form at the demo grid
    (train_fog's) at the top, the cells forms beside it; launches from the
    training paths."""
    by_path = {p: c["composite_grad"] for p, c in train_launches.items()
               if c["composite_grad"]}

    def fields(form):
        err, ms, plain, lib, work = k14[form]
        b_ms, b_by = bound(*work)
        paths = K14_FORMS[form][3]
        return {"launches": sum(by_path.get(p.strip(), 0)
                                for p in paths.split(",")),
                "paths": paths, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib}

    entry = {"name": "composite_grad", "route": "cuda",
             "source": "volumetricrenderer_tpu_torch/csrc/composite_grad.cu",
             "replaces": replaces}
    entry.update(fields("pixels_720p"))
    del entry["paths"]
    entry["launches"] = sum(by_path.values())
    entry["launches_by_path"] = by_path
    entry["max_abs_err"] = max(v[0] for v in k14.values())
    entry["largest_hold"] = LARGEST.get("composite_grad", (None, None))[1]
    for form in K14_FORMS:
        if form != "pixels_720p":
            entry[form] = fields(form)
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from volumetricrenderer_tpu_torch import (DEMO_CONFIG, FULL_CONFIG,
                                              Geometry, VolumetricRenderer,
                                              benchmark_scene, demo_scene,
                                              froxel, pipeline)
    from volumetricrenderer_tpu_torch.ops import cuda, frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import integrate as integ
    from volumetricrenderer_tpu_torch.ops import pcf_shadow as pcf
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    from volumetricrenderer_tpu_torch.ops import warp as wp
    from volumetricrenderer_tpu_torch.ops import zg_composite as zg
    from volumetricrenderer_tpu_torch.ops import material as mtl
    from volumetricrenderer_tpu_torch.ops import occlude as occl
    from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops
    from volumetricrenderer_tpu_torch.ops.noise import perlin_texture_3d
    from volumetricrenderer_tpu_torch import post
    from volumetricrenderer_tpu_torch.parallel import shard_render as shr

    t_start = time.perf_counter()
    # 1. device
    dev_name = torch.cuda.get_device_name(0)
    n_dev = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"# device: {dev_name} x{n_dev}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    build_s = cuda.build(verbose=True)
    log(f"# build: {time.perf_counter() - t0:.1f} s wall, per source "
        f"{json.dumps({k: round(v, 1) for k, v in build_s.items()})}")
    for src in cuda.ATTR_KERNELS:
        log(f"# kernel attributes, {src}: "
            f"{json.dumps(cuda.kernel_attrs(src))}")

    # 3. configs, scene and G-buffers (one per image size: 1080p, and 4K for
    # the uhd paths)
    cfg = FULL_CONFIG
    if dataclasses.replace(cfg, **DEMO_XLA) != DEMO_CONFIG:
        raise AssertionError("demo_xla's configuration is not DEMO_CONFIG")
    renderers = {name: VolumetricRenderer(dataclasses.replace(cfg, **kw))
                 for name, (kw, _, _) in PATHS.items()}
    renderer = renderers["fused"]
    scene = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                            num_local_lights=16, noise_mode="procedural")
    t0 = time.perf_counter()
    scene_color, view_depth = renderer.render_scene_inputs(scene)
    torch.cuda.synchronize()
    log(f"# gbuffer: {1e3 * (time.perf_counter() - t0):.1f} ms "
        f"{tuple(scene_color.shape)}")
    uhd_r = renderers["uhd"]
    t0 = time.perf_counter()
    color_4k, depth_4k = uhd_r.render_scene_inputs(scene)
    torch.cuda.synchronize()
    log(f"# gbuffer 4K: {1e3 * (time.perf_counter() - t0):.1f} ms "
        f"{tuple(color_4k.shape)}")
    # the demo scene, its fractional variant (the same primitives through
    # Geometry.create's 4-tuples, the first three boxes at opacity 0.5) and
    # their G-buffers at 1920x1080 and 1280x720 (box opacity shadows only:
    # the fractional scene shares the demo G-buffers)
    demo = demo_scene(aspect=cfg.image_width / cfg.image_height)
    frac = fractional_scene(demo, Geometry)
    # SCENE_PATHS' scenes: benchmark_scene with the fog sampling a 32^3
    # noise texture (bench.py's run_texture), without its sun and without
    # media, and demo_scene with the fog's texture (demo.py --noise); the
    # sunless scene has a G-buffer of its own, the others share their base
    # scene's (media do not enter it)
    aspect = cfg.image_width / cfg.image_height
    tex_scene = benchmark_scene(aspect=aspect, num_local_lights=16,
                                noise_tex=perlin_texture_3d(),
                                noise_mode="texture")
    sunless = dataclasses.replace(scene, dir_lights=dataclasses.replace(
        scene.dir_lights, **{f.name: getattr(scene.dir_lights, f.name)[:0]
                             for f in dataclasses.fields(scene.dir_lights)}))
    no_media = dataclasses.replace(scene, media=())
    demo_noise = demo_scene(aspect=aspect, with_noise=True,
                            noise_tex=perlin_texture_3d(32))
    scenes = {"demo": demo, "fractional": frac, "tex": tex_scene,
              "sunless": sunless, "no_media": no_media,
              "demo_noise": demo_noise}
    scene_key = {name: v[0] for name, v in {**DEMO_PATHS,
                                             **SCENE_PATHS}.items()}
    scene_of = lambda name: scenes[scene_key[name]] \
        if name in scene_key else scene
    t0 = time.perf_counter()
    sunless_gbuf = renderer.render_scene_inputs(sunless)
    torch.cuda.synchronize()
    log(f"# gbuffer without the sun: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    demo_gbuf = {}
    for size, name in ((1080, "demo_full"), (720, "demo_production")):
        t0 = time.perf_counter()
        demo_gbuf[size] = renderers[name].render_scene_inputs(demo)
        torch.cuda.synchronize()
        log(f"# gbuffer demo_scene {size}p: "
            f"{1e3 * (time.perf_counter() - t0):.1f} ms "
            f"{tuple(demo_gbuf[size][0].shape)}")

    def gbuf(name):
        if name.startswith("uhd"):
            return color_4k, depth_4k
        if name in DEMO_PATHS or name == "demo_noise":
            return demo_gbuf[renderers[name].config.image_height]
        if name == "sunless":
            return sunless_gbuf
        return scene_color, view_depth

    # 4. the main paths, each from a fresh state; the shadow maps of a map
    # path baked once, up front (timed apart from the frames)
    bakes = {}
    for name, r in renderers.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bakes[name] = r.bake_shadow_data(scene_of(name))
        torch.cuda.synchronize()
        if r.config.shadow_mode != "raycast":
            log(f"# {name}: bake_shadow_data "
                f"{1e3 * (time.perf_counter() - t0):.1f} ms (first call)")
    # the plain XLA scatter's arguments of each path's last frame, kept for
    # its hold against the CPU
    xla_args, current = {}, {}
    real_xla = pipeline.write_scatter_xla

    def recording_xla(*args):
        xla_args[current["path"]] = args
        return real_xla(*args)

    pipeline.write_scatter_xla = recording_xla
    runs = {}
    try:
        for name in PATHS:
            current["path"] = name
            runs[name] = drive(name, renderers[name], scene_of(name),
                               *gbuf(name), cuda, bakes[name])
    finally:
        pipeline.write_scatter_xla = real_xla
    if sorted(xla_args) != sorted(XLA_SCATTER_PATHS):
        raise AssertionError(f"the XLA scatter ran on {sorted(xla_args)}, "
                             f"not on {sorted(XLA_SCATTER_PATHS)}")
    # the post stack on the fused frame; the SSR march's inputs of the last
    # post_showcase frame are kept for K13's check
    march_args = []
    real_march = ssr_ops.ssr_march

    def recording_march(*args):
        march_args[:] = [args]
        return real_march(*args)

    ssr_ops.ssr_march = recording_march
    try:
        for name in POST_PATHS:
            runs[name] = drive_post(name, renderers["fused"], post, scene,
                                    scene_color, view_depth, cuda)
    finally:
        ssr_ops.ssr_march = real_march
    # the slab paths through make_multislab_render, each shard's G-buffer
    # band bound as fixed_inputs (bench.py's run_slabn)
    slab_fns, slab_runs = {}, {}
    for name, (kw, n_sh, _, _) in SLAB_PATHS.items():
        s_r = VolumetricRenderer(dataclasses.replace(cfg, **kw))
        slab_fns[name] = (s_r, shr.make_multislab_render(
            s_r, n_sh, fixed_inputs=(list(scene_color.chunk(n_sh)),
                                     list(view_depth.chunk(n_sh)))))
        slab_runs[name] = drive_slab(name, slab_fns[name][1], scene, cuda)
        runs[name] = (slab_runs[name][0], slab_runs[name][2],
                      slab_runs[name][3])
    img, states, _ = runs["fused"]
    launches = {k: {name: run[2][k] for name, run in runs.items()
                    if run[2][k]} for k in cuda.SOURCES}
    s_img = runs["staged"][0]
    err = (s_img - img).abs()
    past = float((err > 1e-6 + 1e-5 * img.abs()).float().mean())
    far = float((err / (1.0 + img.abs()) > 1e-3).float().mean())
    log(f"# staged vs fused, frame 4: max |diff| {float(err.max()):.3e}, "
        f"mean {float(err.mean()):.3e}, fraction past atol 1e-6 + rtol 1e-5 "
        f"= {past:.2e}, beyond 1e-3 relative = {far:.2e} (allowed 5e-3 "
        f"each: {BOUNDARY})")
    if past > 5e-3 or far > 5e-3:
        raise AssertionError("the staged frame disagrees with the fused one")
    # composite_impl="pallas" renders the fused frame and composites it on
    # K4 as the zgather route does: its one frame is the fused frame 1
    pc_same = torch.equal(runs["pallas_composite"][0],
                          renderer.render_frame(
                              states[0], scene, 0.0, scene_color,
                              view_depth)[0])
    log(f"# pallas_composite frame 1 = fused frame 1 bit for bit: {pc_same}")
    if not pc_same:
        raise AssertionError("the pallas composite differs from the zgather "
                             "one")
    # the fused per-light and inline-visibility frames run the staged
    # frames' device functions in another grouping: the same image and
    # histories bit for bit after the same 2 frames
    for fused, staged in (("fused_exact", "exact"), ("fused_vis", "vis_bake")):
        f_img, f_states, _ = runs[fused]
        s_img, s_states, _ = runs[staged]
        same = (torch.equal(f_img, s_img)
                and torch.equal(f_states[-1].prev_shadow,
                                s_states[-1].prev_shadow)
                and torch.equal(f_states[-1].prev_accumulation,
                                s_states[-1].prev_accumulation))
        log(f"# {fused} = {staged} (image and histories, frame 2) bit for "
            f"bit: {same}")
        if not same:
            raise AssertionError(f"{fused} differs from {staged}")
    # UHD_CONFIG's every second pixel is the exact 4K composite there: its
    # frame 2 (re-rendered from its state before frame 2) against
    # uhd_exact's frame 2; the volume phase is the same
    u_states = runs["uhd"][1]
    x_img, x_states, _ = runs["uhd_exact"]
    u_img2 = uhd_r.render_frame(u_states[1], scene, 0.1, color_4k,
                                depth_4k)[0]
    u_diff = float((u_img2 - x_img).abs().max())
    cosite_same = (torch.equal(u_img2[::2, ::2], x_img[::2, ::2])
                   and torch.equal(u_states[2].prev_accumulation,
                                   x_states[2].prev_accumulation))
    log(f"# uhd frame 2 [::2, ::2] = uhd_exact frame 2 [::2, ::2] bit for "
        f"bit: {cosite_same} (whole image max |diff| {u_diff:.3e})")
    if not cosite_same:
        raise AssertionError("the co-sited composite misses the exact one at "
                             "its co-sited pixels")
    del u_img2
    # a scene edited in place between frames: the host copy the tables are
    # packed from is made again (scene tensors on the card, so the copy is
    # a real one); frame 2 against a fresh renderer's frame of the edited
    # scene
    edited = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                             num_local_lights=16, noise_mode="procedural")
    e_r = VolumetricRenderer(cfg)
    _, _, e_st = e_r.render_frame(e_r.init_state(1), edited, 0.0)
    stale = e_r.render_frame(e_st, edited, 0.1)[0]
    edited.camera.position.add_(torch.tensor([0.5, 0.2, 1.0], device="cuda"))
    e_img = e_r.render_frame(e_st, edited, 0.1)[0]
    f_img = VolumetricRenderer(cfg).render_frame(e_st, edited, 0.1)[0]
    c2_same = torch.equal(e_img, f_img)
    log(f"# scene edited in place: next frame = a fresh renderer's bit for "
        f"bit: {c2_same}; it moved from the unedited frame by max |diff| "
        f"{float((e_img - stale).abs().max()):.3e}")
    if not c2_same or torch.equal(e_img, stale):
        raise AssertionError("the frame after an in-place scene edit used "
                             "a stale host copy")
    del edited, e_r, stale, e_img, f_img
    # the demo scene: composite_impl="xla" takes the per-pixel form that
    # demo_production's ineligible zgather takes (JAX: the gather and
    # composite_rowmm, the same trilinear), on the same volume phase, so its
    # one frame is demo_production's frame 1; the local terrain, the
    # fractional boxes and the staged frame each move the image
    ax_same = torch.equal(runs["anyres_xla"][0], renderers[
        "demo_production"].render_frame(
            runs["demo_production"][1][0], demo, 0.0,
            *demo_gbuf[720])[0])
    log(f"# anyres_xla frame 1 = demo_production frame 1 bit for bit: "
        f"{ax_same}")
    if not ax_same:
        raise AssertionError("the xla composite differs from the rowmm one")
    d_img2 = renderers["demo_full"].render_frame(
        runs["demo_full"][1][1], demo, 0.1, *demo_gbuf[1080])[0]
    for name in ("demo_hf_local", "fractional", "demo_vis_hf",
                 "demo_exact_hf"):
        diff = (runs[name][0] - d_img2).abs()
        log(f"# {name} frame 2 against demo_full frame 2: max |diff| "
            f"{float(diff.max()):.3e}, mean {float(diff.mean()):.3e}")
    if torch.equal(runs["fractional"][0], d_img2):
        raise AssertionError("the fractional boxes change nothing")
    del d_img2

    # 5. each kernel against its twin on the inputs of frame 4 (index 3);
    # the fused and staged configs pack the same tables
    prev = states[3]
    tables, params, _ = renderer.frame_tables(prev, scene, 0.1 * 3)
    prev_sh = prev.prev_shadow.float().contiguous()
    prev_acc = prev.prev_accumulation.float().contiguous()
    bake = ff.bake_radiance(tables)
    sh, sc = ff.shadow_scatter(tables, prev_sh, bake)
    acc = ff.integrate_blend(tables, sc, prev_acc)
    out = zg.composite(acc, scene_color, view_depth, params, cfg.grid)
    errs = {}
    errs["bake_radiance"] = compare("bake_radiance", bake,
                                    ff.bake_radiance_plain(tables),
                                    label="fused frame 4")
    sh_p, sc_p = ff.shadow_scatter_plain(tables, prev_sh, bake)
    errs["shadow_scatter"] = max(
        compare("shadow_scatter", sh, sh_p, label="radiance, history"),
        compare("shadow_scatter", sc, sc_p, label="radiance, planes"))
    # the two non-production branches of K2 and K6 (radiance mode): the
    # jittered sun scatter and the fBm evaluated per froxel (no baked noise
    # channel; K1 then writes its three radiance channels and nothing past
    # them, checked with a sentinel behind the volume)
    opt = dataclasses.replace(tables, jitter_dir=True, n_noise=0)
    guard = torch.full((4 * bake[0].numel(),), -7.0, device="cuda")
    st_opt = opt.c_struct()
    cuda.launch("bake_radiance", cuda.ctypes.byref(st_opt), cuda.ptr(guard))
    bake_rgb = guard[:3 * bake[0].numel()].view(bake[:3].shape)
    errs["bake_radiance"] = max(
        errs["bake_radiance"],
        compare("bake_radiance", bake_rgb, ff.bake_radiance_plain(opt),
                label="no fBm channel"))
    if not bool((guard[3 * bake[0].numel():] == -7.0).all()):
        raise AssertionError("bake_radiance wrote past its 3 channels")
    bake_rgb = bake_rgb.clone()
    sc_opt_p = ff.shadow_scatter_plain(opt, prev_sh, bake_rgb)[1]
    errs["shadow_scatter"] = max(
        errs["shadow_scatter"],
        compare("shadow_scatter", ff.shadow_scatter(opt, prev_sh, bake_rgb)[1],
                sc_opt_p, label="radiance, jittered sun, fBm per froxel"))
    errs["integrate_blend"] = compare(
        "integrate_blend", acc, ff.integrate_blend_plain(tables, sc, prev_acc))
    errs["composite"] = compare(
        "composite", out, zg.composite_plain(acc, scene_color, view_depth,
                                             params, cfg.grid))
    frame4 = torch.equal(out, img)
    log(f"# frame-4 inputs reproduce the fused path's image: {frame4}")
    if not frame4:
        raise AssertionError("the kernel chain on frame-4 inputs differs "
                             "from the fused path's last image")
    # the staged kernels on the same frame; K6's per-light mode on the
    # inputs of the exact path's frame 2
    errs["shadow_blend"] = compare("shadow_blend",
                                   sb.dir_shadow_blend(tables, prev_sh), sh_p,
                                   label="fused frame 4")
    unblended_p = ds.dir_shadow_plain(tables)
    errs["dir_shadow"] = compare("dir_shadow", ds.dir_shadow(tables),
                                 unblended_p)
    # K6's holds: label -> (tables, shadow, bake, vis, material), for the
    # account of the largest difference (scatter_terms)
    k6_in = {"radiance x fused": (tables, sh_p, bake, None, None),
             "radiance x fused, jittered sun, fBm per froxel": (
                 opt, sh_p, bake_rgb, None, None)}
    errs["scatter"] = max(
        compare("scatter", sca.scatter_local(tables, sh_p, bake), sc_p,
                label="radiance x fused"),
        compare("scatter", sca.scatter_local(opt, sh_p, bake_rgb), sc_opt_p,
                label="radiance x fused, jittered sun, fBm per froxel"))
    x_prev = runs["exact"][1][1]
    x_tables, _, _ = renderers["exact"].frame_tables(x_prev, scene, 0.1)
    x_sh = sb.dir_shadow_blend(x_tables,
                               x_prev.prev_shadow.float().contiguous())
    x_sc = sca.scatter_local(x_tables, x_sh)
    x_sc_p = sca.scatter_local_plain(x_tables, x_sh)
    x_opt = dataclasses.replace(x_tables, jitter_dir=True)
    k6_in["rays x fused"] = (x_tables, x_sh, None, None, None)
    k6_in["rays x fused, jittered sun"] = (x_opt, x_sh, None, None, None)
    per_light_err = compare("scatter", x_sc, x_sc_p, label="rays x fused")
    per_light_err = max(per_light_err, compare(
        "scatter", sca.scatter_local(x_opt, x_sh),
        sca.scatter_local_plain(x_opt, x_sh),
        label="rays x fused, jittered sun"))
    errs["scatter"] = max(errs["scatter"], per_light_err)
    errs["integrate"] = compare("integrate", integ.accumulate(tables, sc),
                                integ.accumulate_plain(tables, sc))
    del x_sc_p, sc_opt_p, guard
    # K1 with more local lights than one pass takes (40 on benchmark_scene:
    # two passes, the sums carried from the first into the second), on the
    # fused frame's first tables
    scene40 = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                              num_local_lights=40, noise_mode="procedural")
    t40, _, _ = renderer.frame_tables(
        renderer.init_state(scene40.dir_lights.count), scene40, 0.0)
    passes40 = ff.k1_geometry(t40.lights.shape[0], t40.n_noise,
                              t40.low_dims).passes
    late40 = int(t40.active[ff.K1_PASS:].sum())
    log(f"# bake_radiance, 40 lights: {passes40} passes, {late40} (light, "
        f"low slice) pairs active past the first pass")
    if passes40 < 2 or late40 == 0:
        raise AssertionError("the 40-light hold does not reach K1's second "
                             "pass")
    k1_err = {"lights40": compare("bake_radiance", ff.bake_radiance(t40),
                                  ff.bake_radiance_plain(t40),
                                  label="40 local lights")}
    errs["bake_radiance"] = max(errs["bake_radiance"], k1_err["lights40"])

    # K2's per-light modes on the inputs of the fused_exact and fused_vis
    # paths' frame 2: rays, and the visibility of K9
    k2_in = {}
    for mode, path in (("rays", "fused_exact"), ("baked", "fused_vis")):
        p_prev = runs[path][1][1]
        p_tables, _, _ = renderers[path].frame_tables(p_prev, scene, 0.1)
        p_vis = vis.bake_visibility(p_tables) if mode == "baked" else None
        k2_in[mode] = (p_tables, p_prev.prev_shadow.float().contiguous(),
                       p_vis)
    k2_err = {}
    for mode, (p_tables, p_sh, p_vis) in k2_in.items():
        got = ff.shadow_scatter(p_tables, p_sh, vis=p_vis)
        want = ff.shadow_scatter_plain(p_tables, p_sh, vis=p_vis)
        k2_err[mode] = max(compare("shadow_scatter", g, w_,
                                   label=f"{mode}, {part}")
                           for g, w_, part in zip(got, want,
                                                  ("history", "planes")))
        log(f"# shadow_scatter, {mode}: source {p_tables.local_source}")
    errs["shadow_scatter"] = max(errs["shadow_scatter"], *k2_err.values())
    del got, want
    # K2 is K5 then K6 in one kernel: its history and scatter planes equal
    # theirs bit for bit, in each local source
    for mode, (p_tables, p_sh, p_bake, p_vis) in (
            ("radiance", (tables, prev_sh, bake, None)),
            ("rays", k2_in["rays"][:2] + (None, None)),
            ("baked", k2_in["baked"][:2] + (None, k2_in["baked"][2]))):
        k2_sh, k2_sc = ff.shadow_scatter(p_tables, p_sh, p_bake, p_vis)
        k5_sh = sb.dir_shadow_blend(p_tables, p_sh)
        k6_sc = sca.scatter_local(p_tables, k5_sh, p_bake, p_vis)
        same = torch.equal(k2_sh, k5_sh) and torch.equal(k2_sc, k6_sc)
        log(f"# shadow_scatter, {mode}: = shadow_blend then scatter bit for "
            f"bit: {same}")
        if not same:
            raise AssertionError(f"K2 ({mode}) differs from K5 then K6")
    del k2_sh, k2_sc, k5_sh, k6_sc
    # K2's and K6's blocks and K2's dynamic shared memory, as the wrappers
    # reckon them
    blk = (cuda.ctypes.c_int * 3)()
    for local in (sca.LOCAL_RADIANCE, sca.LOCAL_RAY, sca.LOCAL_BAKED):
        for kw in (0, 1, cfg.reproj_window, 8, 25):
            cuda.lib("shadow_scatter").vr_shadow_scatter_geometry(
                local, kw, cuda.ctypes.cast(blk, cuda.ctypes.c_void_p))
            want = (*ff.K2_TILE, ff.k2_shared_bytes(kw))
            if tuple(blk) != want:
                raise AssertionError(f"K2's block and shared bytes at mode "
                                     f"{local}, k={kw}: {tuple(blk)} in the "
                                     f"kernel, {want} in ops/frame_fused")
        cuda.lib("scatter").vr_scatter_geometry(
            local, cuda.ctypes.cast(blk, cuda.ctypes.c_void_p))
        if tuple(blk[:2]) != sca.K6_TILES[local]:
            raise AssertionError(f"K6's block at mode {local}: "
                                 f"{tuple(blk[:2])} in the kernel, "
                                 f"{sca.K6_TILES[local]} in ops/scatter")
    for kw in (0, 1, cfg.reproj_window, 8, 25):
        cuda.lib("shadow_blend").vr_shadow_blend_geometry(
            kw, cuda.ctypes.cast(blk, cuda.ctypes.c_void_p))
        want = (*sb.K5_TILE, sb.k5_shared_bytes(kw))
        if tuple(blk) != want:
            raise AssertionError(f"K5's block and shared bytes at k={kw}: "
                                 f"{tuple(blk)} in the kernel, {want} in "
                                 f"ops/shadow_blend")
        # K10's and K11's blocks and dynamic shared memory
        for src, mirror in (
                ("temporal_blend", (*tmp.K10_TILE, tmp.k10_shared_bytes(kw),
                                    "ops/temporal")),
                ("windowed_warp", (*wp.K11_TILE, wp.k11_shared_bytes(kw),
                                   "ops/warp"))):
            getattr(cuda.lib(src), f"vr_{src}_geometry")(
                kw, cuda.ctypes.cast(blk, cuda.ctypes.c_void_p))
            if tuple(blk) != mirror[:3]:
                raise AssertionError(f"{src}'s block and shared bytes at "
                                     f"k={kw}: {tuple(blk)} in the kernel, "
                                     f"{mirror[:3]} in {mirror[3]}")
    # K7's tile, and K8's tile, chunk, threads and dynamic shared memory
    cuda.lib("dir_shadow").vr_dir_shadow_geometry(
        cuda.ctypes.cast(blk, cuda.ctypes.c_void_p))
    if tuple(blk[:2]) != ds.K7_TILE:
        raise AssertionError(f"K7's block: {tuple(blk[:2])} in the kernel, "
                             f"{ds.K7_TILE} in ops/dir_shadow")
    k8_geo = (cuda.ctypes.c_int * 5)()
    cuda.lib("integrate").vr_integrate_geometry(
        cuda.ctypes.cast(k8_geo, cuda.ctypes.c_void_p))
    if tuple(k8_geo) != dataclasses.astuple(integ.k8_geometry()):
        raise AssertionError(f"K8's tile, chunk, threads and shared bytes: "
                             f"{tuple(k8_geo)} in the kernel, "
                             f"{integ.k8_geometry()} in ops/integrate")
    # K1's launch: (local lights, fBm channels, low grid) of the full grid,
    # the demo grid, a slab5 shard, a ragged low slice and no lights, and
    # 40 lights (two passes)
    geo = (cuda.ctypes.c_int * 8)()
    k1_shapes = ((tables.lights.shape[0], tables.n_noise, tables.low_dims),
                 (1, 0, (80, 44, 32)), (16, 1, (60, 10, 32)),
                 (3, 2, (13, 5, 3)), (0, 1, (13, 5, 3)),
                 (40, 1, (60, 34, 32)))
    for n_l, n_n, (wl_, hl_, dl_) in k1_shapes:
        cuda.lib("bake_radiance").vr_bake_radiance_geometry(
            n_l, n_n, wl_, hl_, dl_, cuda.ctypes.cast(geo,
                                                       cuda.ctypes.c_void_p))
        want = ff.k1_geometry(n_l, n_n, (wl_, hl_, dl_))
        if tuple(geo) != dataclasses.astuple(want):
            raise AssertionError(f"K1's launch for {n_l} lights, {n_n} fBm "
                                 f"channels on {(wl_, hl_, dl_)}: "
                                 f"{tuple(geo)} in the kernel, {want} in "
                                 f"ops/frame_fused")
    # K12's tile, dynamic shared memory at 1-4 cascades and rows of
    # threads; K9's launch (local lights, low grid) of the full grid, the
    # demo grid's one spot light, 40 lights and a ragged low slice
    k12_geo = (cuda.ctypes.c_int * 4)()
    for nc in (1, 2, 3, 4):
        cuda.lib("pcf_shadow").vr_pcf_shadow_geometry(
            nc, cuda.ctypes.cast(k12_geo, cuda.ctypes.c_void_p))
        want = (*pcf.K12_TILE, pcf.k12_shared_bytes(nc),
                pcf.K12_TILE[1] // pcf.K12_ROWS_PER_THREAD)
        if tuple(k12_geo) != want:
            raise AssertionError(f"K12's tile, shared bytes and rows of "
                                 f"threads at {nc} cascades: "
                                 f"{tuple(k12_geo)} in the kernel, "
                                 f"{want} in ops/pcf_shadow")
    k9_geo = (cuda.ctypes.c_int * 6)()
    k9_shapes = ((tables.lights.shape[0], tables.low_dims),
                 (1, (60, 34, 32)), (1, (80, 44, 32)), (40, (60, 34, 32)),
                 (3, (13, 5, 3)), (2, (13, 5, 3)))
    for n_l, (wl_, hl_, dl_) in k9_shapes:
        cuda.lib("bake_visibility").vr_bake_visibility_geometry(
            n_l, wl_, hl_, dl_, cuda.ctypes.cast(k9_geo,
                                                 cuda.ctypes.c_void_p))
        want = vis.k9_geometry(n_l, (wl_, hl_, dl_))
        if tuple(k9_geo) != dataclasses.astuple(want):
            raise AssertionError(f"K9's launch for {n_l} lights on "
                                 f"{(wl_, hl_, dl_)}: {tuple(k9_geo)} in the "
                                 f"kernel, {want} in ops/visibility")
    # K13's tile, shared bytes and unrolled taps at (bins, taps a bin):
    # the default table, the 24-step 16-bin one and the edges of each
    # instance
    k13_geo = (cuda.ctypes.c_int * 4)()
    for nb, nt in ((8, 12), (16, 24), (1, 1), (8, 16), (8, 17), (4, 32)):
        cuda.lib("ssr_march").vr_ssr_march_geometry(
            nb, nt, cuda.ctypes.cast(k13_geo, cuda.ctypes.c_void_p))
        want = (*ssr_ops.K13_TILE, ssr_ops.k13_shared_bytes(nb, nt),
                ssr_ops.k13_unroll(nt))
        if tuple(k13_geo) != want:
            raise AssertionError(f"K13's tile, shared bytes and unrolled "
                                 f"taps at {nb} bins of {nt} taps: "
                                 f"{tuple(k13_geo)} in the kernel, {want} "
                                 f"in ops/ssr")
    log(f"# blocks as the wrappers reckon them: K2 {ff.K2_TILE} with "
        f"{ff.k2_shared_bytes(cfg.reproj_window)} B of shared memory at k="
        f"{cfg.reproj_window}, K5 {sb.K5_TILE} with "
        f"{sb.k5_shared_bytes(cfg.reproj_window)} B, K6 {sca.K6_TILES}, K10 "
        f"{tmp.K10_TILE} with {tmp.k10_shared_bytes(cfg.reproj_window)} B, "
        f"K11 {wp.K11_TILE} with {wp.k11_shared_bytes(cfg.reproj_window)} "
        f"B, K7 {ds.K7_TILE}, K8 {integ.k8_geometry()} in "
        f"{integ.k8_blocks(cfg.grid)} blocks, K1 on the full grid "
        f"{ff.k1_geometry(*k1_shapes[0])}, K12 {pcf.K12_TILE} with "
        f"{pcf.k12_shared_bytes(4)} B at 4 cascades, K9 on the full grid "
        f"{vis.k9_geometry(*k9_shapes[0])}, K13 {ssr_ops.K13_TILE} with "
        f"{ssr_ops.k13_shared_bytes(8, 12)} B at 8 bins of 12 taps")

    # K4 at 16x16-pixel cells (3840x2160) and its co-sited planes form
    # (1920x1080) on the inputs of uhd_exact's frame 2
    u_tables, u_params, _ = renderers["uhd_exact"].frame_tables(
        x_states[1], scene, 0.1)
    u_acc = x_states[2].prev_accumulation.float().contiguous()
    u_out = zg.composite(u_acc, color_4k, depth_4k, u_params, cfg.grid)
    if not torch.equal(u_out, x_img):
        raise AssertionError("K4 on uhd_exact's frame-2 inputs differs from "
                             "the path's image")
    k4_err = {"cells_16x16": compare(
        "composite", u_out, zg.composite_plain(u_acc, color_4k, depth_4k,
                                               u_params, cfg.grid))}
    depth_lo = depth_4k[::2, ::2].contiguous()
    w9_lo = zg.cell_weights(depth_lo.shape[0] // cfg.grid[1],
                            depth_lo.shape[1] // cfg.grid[0], 2)
    lo_planes = zg.composite_planes(u_acc, depth_lo, u_params, cfg.grid,
                                    w9_lo)
    k4_err["cosited_planes"] = compare(
        "composite", lo_planes, zg.composite_planes_plain(
            u_acc, depth_lo, u_params, cfg.grid, w9_lo))
    errs["composite"] = max(errs["composite"], *k4_err.values())
    log(f"# composite: 16x16 cells {tuple(u_out.shape)}, co-sited planes "
        f"{tuple(lo_planes.shape)}")
    del u_out

    # K10 on the same frame: both modes against the twin, and the two
    # identities it is built on -- K7 then K10 = K5, K8 then K10 = K3
    whd, hg, kk = tables.grid_whd, tables.h_glob, tables.k
    unblended = ds.dir_shadow(tables)
    acc_un = integ.accumulate(tables, sc)
    blend_w = lambda: tmp.temporal_blend(tables.sbpar, prev_sh, unblended,
                                         whd, hg, kk, "weight")
    blend_a = lambda: tmp.temporal_blend(tables.abpar, prev_acc, acc_un, whd,
                                         hg, kk, "alpha")
    weight_err = compare("temporal_blend", blend_w(), tmp.temporal_blend_plain(
        tables.sbpar, prev_sh, unblended, whd, hg, kk, "weight"))
    errs["temporal_blend"] = compare(
        "temporal_blend", blend_a(), tmp.temporal_blend_plain(
            tables.abpar, prev_acc, acc_un, whd, hg, kk, "alpha"))
    same_sb = torch.equal(blend_w(), sb.dir_shadow_blend(tables, prev_sh))
    same_ib = torch.equal(blend_a(), acc)
    log(f"# K7 then K10 (weight) = K5 bit for bit: {same_sb}; K8 then K10 "
        f"(alpha) = K3 bit for bit: {same_ib}")
    if not (same_sb and same_ib):
        raise AssertionError("the standalone blend disagrees with the fused "
                             "shadow or integrate blend")
    del unblended_p

    # K9, K11 and K6's baked-visibility and material-volume modes on the
    # inputs of the history path's frame 4
    h_r = renderers["history"]
    h_prev = runs["history"][1][3]
    h_tables, h_params, h_w2v = h_r.frame_tables(h_prev, scene, 0.1 * 3)
    geo, scene_dev = h_r.frame_geometry(h_prev, scene, h_tables, h_params,
                                        h_w2v)
    h_vis = vis.bake_visibility(h_tables)
    errs["bake_visibility"] = compare("bake_visibility", h_vis,
                                      vis.bake_visibility_plain(h_tables))
    # K9 on 40 local lights (ten a light group) at vis_bake's configuration
    v40, _, _ = renderers["vis_bake"].frame_tables(
        renderers["vis_bake"].init_state(scene40.dir_lights.count), scene40,
        0.0)
    k9_err = {"lights40": compare("bake_visibility",
                                  vis.bake_visibility(v40),
                                  vis.bake_visibility_plain(v40),
                                  label="40 local lights")}
    errs["bake_visibility"] = max(errs["bake_visibility"], k9_err["lights40"])
    tx, ty, tz, _ = geo.centre_texel
    h_prev_sc = h_prev.prev_scatter.float().contiguous()
    errs["windowed_warp"] = compare(
        "windowed_warp", wp.windowed_warp(h_prev_sc, tx, ty, tz, kk),
        wp.windowed_warp_plain(h_prev_sc, tx, ty, tz, kk))
    mat_a, mat_b = pipeline.write_material_volumes(
        h_r.config, h_params, geo.view_to_world, geo.jitter, 0.1 * 3,
        scene_dev.media)
    mat_a = pipeline.temporal_blend_material(
        h_r.config, geo, mat_a, h_prev.prev_material_a.float())
    mat = (mat_a.contiguous(), mat_b.contiguous())
    h_sh = sb.dir_shadow_blend(h_tables,
                               h_prev.prev_shadow.float().contiguous())
    # K6 radiance x planes on tex_staged's frame 2: K1's radiance (no noise
    # channel) over the material volumes with the fog's texture sample
    ts_r = renderers["tex_staged"]
    ts_prev = runs["tex_staged"][1][1]
    ts_tables, ts_params, ts_w2v = ts_r.frame_tables(ts_prev, tex_scene, 0.1)
    ts_geo, ts_dev = ts_r.frame_geometry(ts_prev, tex_scene, ts_tables,
                                         ts_params, ts_w2v)
    ts_mat = tuple(v.contiguous() for v in pipeline.write_material_volumes(
        ts_r.config, ts_params, ts_geo.view_to_world, ts_geo.jitter, 0.1,
        ts_dev.media))
    ts_sh = sb.dir_shadow_blend(ts_tables,
                                ts_prev.prev_shadow.float().contiguous())
    ts_bake = ff.bake_radiance(ts_tables)
    if ts_tables.n_noise or ts_bake.shape[0] != 3:
        raise AssertionError("tex_staged's K1 baked a noise channel")
    # mode -> (tables, shadow, bake, vis, material) of scatter_local
    k6_modes = {"baked_planes": (h_tables, h_sh, None, h_vis, mat),
                "baked_fused": (h_tables, h_sh, None, h_vis, None),
                "radiance_planes": (ts_tables, ts_sh, ts_bake, None, ts_mat)}
    k6_in.update({m.replace("_", " x "): a for m, a in k6_modes.items()})
    mode_err = {m: compare("scatter", sca.scatter_local(*a),
                           sca.scatter_local_plain(*a),
                           label=m.replace("_", " x "))
                for m, a in k6_modes.items()}
    errs["scatter"] = max(errs["scatter"], *mode_err.values())

    # K12 on the inputs of the map_dir path's frame 4: the low-rate grid of
    # the path, and the full rate of map_dir_full_rate
    m_r, f_r = renderers["map_dir"], renderers["map_dir_full_rate"]
    m_prev = runs["map_dir"][1][3]
    m_dir, f_dir = bakes["map_dir"][0], bakes["map_dir_full_rate"][0]
    pcf_low = m_r.pcf_tables(m_prev, scene, m_dir)
    pcf_full = f_r.pcf_tables(m_prev, scene, f_dir)
    log(f"# pcf_shadow grids: low {pcf_low.grid_whd}, full "
        f"{pcf_full.grid_whd}; atlas {tuple(m_dir.atlas.shape)}; active "
        f"cascades per slice (low) {pcf_low.count[0].tolist()}")
    k12_low = pcf.pcf_shadow(pcf_low, m_dir.atlas)
    errs["pcf_shadow"] = compare("pcf_shadow", k12_low,
                                 pcf.pcf_shadow_plain(pcf_low, m_dir.atlas))
    full_err = compare("pcf_shadow", pcf.pcf_shadow(pcf_full, f_dir.atlas),
                       pcf.pcf_shadow_plain(pcf_full, f_dir.atlas))
    errs["pcf_shadow"] = max(errs["pcf_shadow"], full_err)
    # K12 on map_dir's tables with a second sun: one launch for both suns,
    # each sun's volume = its one-sun launch's bit for bit
    t2, atlas2 = two_suns(pcf_low, m_dir.atlas)
    k12_two = pcf.pcf_shadow(t2, atlas2)
    errs["pcf_shadow"] = max(errs["pcf_shadow"], compare(
        "pcf_shadow", k12_two, pcf.pcf_shadow_plain(t2, atlas2),
        label="two suns"))
    one = lambda li: dataclasses.replace(
        t2, **{f: getattr(t2, f)[li:li + 1] for f in (
            "par", "coef", "order", "count", "spheres")})
    same = all(torch.equal(k12_two[li:li + 1], pcf.pcf_shadow(
        one(li), atlas2[li:li + 1])) for li in range(2))
    log(f"# pcf_shadow, two suns in one launch = each sun alone bit for "
        f"bit: {same}")
    if not same:
        raise AssertionError("K12's two-sun launch differs from its one-sun "
                             "launches")
    lit = float((k12_low == 1.0).float().mean())
    log(f"# pcf_shadow low-rate volume: min {float(k12_low.min()):.4f}, "
        f"fully lit share {lit:.3f}")
    if not (float(k12_low.min()) < 0.5 and lit < 1.0):
        raise AssertionError("the sun shadow volume of map_dir casts no "
                             "shadow")

    # K13 on the SSR inputs of post_showcase's last frame
    m_args = march_args[0]
    k13 = torch.stack(ssr_ops.ssr_march(*m_args))
    k13_p = torch.stack(ssr_ops.ssr_march_reference(*m_args))
    errs["ssr_march"] = compare("ssr_march", k13, k13_p)
    hq, wq = m_args[0].shape
    hit_share = float(k13[3].mean())
    log(f"# ssr_march: {hq}x{wq} planes, {len(m_args[6])} bins, taps per "
        f"bin {[len(b) for b in m_args[6]]}, hit share {hit_share:.4f}, "
        f"valid share {float(m_args[5].mean()):.4f}, equal to its twin bit "
        f"for bit: {torch.equal(k13, k13_p)}")
    if not 0.0 < hit_share < 1.0:
        raise AssertionError("the SSR march finds no reflection hits")

    # the plain XLA scatter on the card against the same function on the
    # CPU, on the arguments of xla_scatter's and demo_xla's last frames:
    # tests/torch_tolerance.py's any-hit tolerance (rtol 1e-5 / atol 1e-6,
    # at most 5e-3 of the elements past it or beyond 1e-3 relative)
    def on_cpu(args):
        c_, geo_, shadow_, material_, scene_, maps_ = args
        geo_c = dataclasses.replace(
            geo_, params=froxel.params_to(geo_.params, "cpu"),
            view_to_world=geo_.view_to_world.cpu(),
            prev_world_to_view=geo_.prev_world_to_view.cpu(),
            jitter=geo_.jitter.cpu())
        return (c_, geo_c, shadow_.cpu(), tuple(m.cpu() for m in material_),
                scene_.to("cpu"),
                tuple(None if m is None else m.to("cpu") for m in maps_))

    for name in XLA_SCATTER_PATHS:
        got = pipeline.write_scatter_xla(*xla_args[name]).cpu()
        want = pipeline.write_scatter_xla(*on_cpu(xla_args[name]))
        err = (got - want).abs()
        past = float((err > 1e-6 + 1e-5 * want.abs()).float().mean())
        far = float((err / (1.0 + want.abs()) > 1e-3).float().mean())
        at = tuple(int(v) for v in torch.unravel_index(err.argmax(),
                                                       err.shape))
        log(f"# plain XLA scatter, {name}: {tuple(got.shape)}, card - CPU "
            f"largest {float(err.max()):.3e} at {at} (CPU value "
            f"{float(want[at]):.4e}), fraction past atol 1e-6 + rtol 1e-5 "
            f"{past:.2e}, beyond 1e-3 relative {far:.2e} (allowed 5e-3 "
            f"each: {BOUNDARY})")
        if not bool(torch.isfinite(got).all()) or past > 5e-3 \
                or far > 5e-3:
            raise AssertionError(f"the plain XLA scatter of {name} on the "
                                 f"card disagrees with the CPU")

    # the terrain and fractional arms on the demo paths' inputs: K2, K7
    # (sun rays over the terrain) on demo_full's frame 4; K1 with the local
    # terrain on demo_hf_local's frame 2; K5 and K6 with rays on
    # demo_exact_hf's, K9 on demo_vis_hf's; K1 and K2 on the fractional
    # path's frame 2; K1, K2, K3 and K4's per-pixel form on
    # demo_production's frame 4 (the demo grid)
    def path_tables(name, i):
        st_i = runs[name][1][i]
        t_i, p_i, _ = renderers[name].frame_tables(st_i, scene_of(name),
                                                   0.1 * i)
        return t_i, p_i, st_i.prev_shadow.float().contiguous()

    d_tables, _, d_sh = path_tables("demo_full", 3)
    d_bake = ff.bake_radiance(d_tables)
    hl_tables, _, _ = path_tables("demo_hf_local", 1)
    dx_tables, _, dx_prev = path_tables("demo_exact_hf", 1)
    dx_sh = sb.dir_shadow_blend(dx_tables, dx_prev)
    dv_tables, _, _ = path_tables("demo_vis_hf", 1)
    fr_tables, _, fr_sh = path_tables("fractional", 1)
    fr_bake = ff.bake_radiance(fr_tables)
    dp_r = renderers["demo_production"]
    dp_states = runs["demo_production"][1]
    dp_tables, dp_params, dp_sh = path_tables("demo_production", 3)
    dp_prev_acc = dp_states[3].prev_accumulation.float().contiguous()
    dp_bake = ff.bake_radiance(dp_tables)
    dp_sc = ff.shadow_scatter(dp_tables, dp_sh, dp_bake)[1]
    # kernel -> mode -> (kernel call, twin call)
    arm_calls = {
        "bake_radiance": {
            "terrain_local": (lambda: ff.bake_radiance(hl_tables),
                              lambda: ff.bake_radiance_plain(hl_tables)),
            "demo_grid": (lambda: ff.bake_radiance(dp_tables),
                          lambda: ff.bake_radiance_plain(dp_tables)),
            "fractional": (lambda: ff.bake_radiance(fr_tables),
                           lambda: ff.bake_radiance_plain(fr_tables))},
        "shadow_scatter": {
            "terrain": (lambda: ff.shadow_scatter(d_tables, d_sh, d_bake),
                        lambda: ff.shadow_scatter_plain(d_tables, d_sh,
                                                        d_bake)),
            "demo_grid": (
                lambda: ff.shadow_scatter(dp_tables, dp_sh, dp_bake),
                lambda: ff.shadow_scatter_plain(dp_tables, dp_sh, dp_bake)),
            "fractional": (
                lambda: ff.shadow_scatter(fr_tables, fr_sh, fr_bake),
                lambda: ff.shadow_scatter_plain(fr_tables, fr_sh,
                                                fr_bake))},
        "integrate_blend": {"demo_grid": (
            lambda: ff.integrate_blend(dp_tables, dp_sc, dp_prev_acc),
            lambda: ff.integrate_blend_plain(dp_tables, dp_sc,
                                             dp_prev_acc))},
        "shadow_blend": {"terrain": (
            lambda: sb.dir_shadow_blend(dx_tables, dx_prev),
            lambda: sb.dir_shadow_blend_plain(dx_tables, dx_prev))},
        "scatter": {"rays_terrain": (
            lambda: sca.scatter_local(dx_tables, dx_sh),
            lambda: sca.scatter_local_plain(dx_tables, dx_sh))},
        "dir_shadow": {"terrain": (lambda: ds.dir_shadow(d_tables),
                                   lambda: ds.dir_shadow_plain(d_tables))},
        "bake_visibility": {"terrain_local": (
            lambda: vis.bake_visibility(dv_tables),
            lambda: vis.bake_visibility_plain(dv_tables))},
    }
    # the texture, sunless and media-less paths (SCENE_PATHS). tex, frame
    # 4: the noise channels (plain torch) on the card against the same bake
    # on the CPU, K1 launched without noise channels (k1_tables) and the
    # channels passed through it bit for bit, K2 reading them, and K3 and
    # K4 after them reproducing the path's image bit for bit
    tx_r = renderers["tex"]
    tx_prev = runs["tex"][1][3]
    tx_tables, tx_params, tx_w2v = tx_r.frame_tables(tx_prev, tex_scene,
                                                     0.1 * 3)
    tx_geo, tx_dev = tx_r.frame_geometry(tx_prev, tex_scene, tx_tables,
                                         tx_params, tx_w2v)
    tx_noise = vis.bake_noise_channels(
        tx_r.config, tx_params, tx_geo.view_to_world, tx_geo.jitter,
        tx_dev.media, 0.1 * 3, tx_tables.ss)
    noise_cpu = vis.bake_noise_channels(
        tx_r.config, froxel.params_to(tx_params, "cpu"),
        tx_geo.view_to_world.cpu(), tx_geo.jitter.cpu(),
        tex_scene.to("cpu").media, 0.1 * 3, tx_tables.ss)
    err = (tx_noise.cpu() - noise_cpu).abs()
    past = float((err > 1e-6 + 1e-5 * noise_cpu.abs()).float().mean())
    log(f"# tex: noise channels {tuple(tx_noise.shape)} (std "
        f"{float(tx_noise.std()):.4f}), card - CPU largest "
        f"{float(err.max()):.3e}, fraction past atol 1e-6 + rtol 1e-5 "
        f"{past:.2e} (allowed 1e-3: the card's exp and log in the low "
        f"grid's positions may differ from the CPU's by an ulp)")
    if not bool(torch.isfinite(tx_noise).all()) or past > 1e-3 \
            or not float(tx_noise.std()) > 1e-3:
        raise AssertionError("tex's noise channels on the card disagree "
                             "with the CPU's, or are flat")
    tx_k1 = ff.k1_tables(tx_tables)
    tx_bake = ff.bake_radiance(tx_tables, tx_noise)
    passed = torch.equal(tx_bake[3:], tx_noise)
    log(f"# tex: K1's tables carry {tx_k1.n_noise} noise channels, K2's "
        f"{tx_tables.n_noise}; the noise channels pass K1 bit for bit: "
        f"{passed}")
    if tx_k1.n_noise != 0 or tx_tables.n_noise != 1 or not passed:
        raise AssertionError("tex: K1 baked a noise channel, or K2 reads "
                             "another count of them")
    tx_sh_in = tx_prev.prev_shadow.float().contiguous()
    tx_acc_in = tx_prev.prev_accumulation.float().contiguous()
    tx_sh, tx_sc = ff.shadow_scatter(tx_tables, tx_sh_in, tx_bake)
    tx_acc = ff.integrate_blend(tx_tables, tx_sc, tx_acc_in)
    tx_out = zg.composite(tx_acc, scene_color, view_depth, tx_params,
                          cfg.grid)
    same = torch.equal(tx_out, runs["tex"][0])
    log(f"# tex frame-4 inputs: the noise bake, K1, K2, K3 and K4 reproduce "
        f"the path's image bit for bit: {same}")
    if not same:
        raise AssertionError("the kernel chain on tex's frame-4 inputs "
                             "differs from the path's last image")
    del tx_sc, tx_acc, tx_out, err
    # sunless, frame 2: K6 with no sun term over its shadow volume of ones
    # (unread); no_media, frame 2: K9, and K6 baked x planes over zero
    # material volumes
    sl_prev = runs["sunless"][1][1]
    sl_tables, _, _ = renderers["sunless"].frame_tables(sl_prev, sunless,
                                                        0.1)
    sl_bake = ff.bake_radiance(sl_tables)
    sl_sh = runs["sunless"][1][2].prev_shadow.float().contiguous()
    ones = bool((sl_sh == 1.0).all())
    log(f"# sunless: {sl_tables.n_dir} suns in the tables, shadow volume "
        f"{tuple(sl_sh.shape)}, all ones: {ones}")
    if sl_tables.n_dir != 0 or sl_sh.shape[0] != 1:
        raise AssertionError("the sunless frame packed a sun")
    nm_r = renderers["no_media"]
    nm_prev = runs["no_media"][1][1]
    nm_tables, nm_params, nm_w2v = nm_r.frame_tables(nm_prev, no_media, 0.1)
    nm_geo, nm_dev = nm_r.frame_geometry(nm_prev, no_media, nm_tables,
                                         nm_params, nm_w2v)
    nm_mat = tuple(v.contiguous() for v in pipeline.write_material_volumes(
        nm_r.config, nm_params, nm_geo.view_to_world, nm_geo.jitter, 0.1,
        nm_dev.media))
    nm_vis = vis.bake_visibility(nm_tables)
    errs["bake_visibility"] = max(errs["bake_visibility"], compare(
        "bake_visibility", nm_vis, vis.bake_visibility_plain(nm_tables),
        label="no_media frame 2"))
    nm_sh = sb.dir_shadow_blend(nm_tables,
                                nm_prev.prev_shadow.float().contiguous())
    nm_args = (nm_tables, nm_sh, None, nm_vis, nm_mat)
    k6_in["baked x planes, no media"] = nm_args
    mode_err["baked_planes"] = max(mode_err["baked_planes"], compare(
        "scatter", sca.scatter_local(*nm_args),
        sca.scatter_local_plain(*nm_args), label="baked x planes, no media"))
    errs["scatter"] = max(errs["scatter"], mode_err["baked_planes"])
    arm_calls["bake_radiance"]["texture"] = (
        lambda: ff.bake_radiance(tx_k1),
        lambda: ff.bake_radiance_plain(tx_k1))
    arm_calls["shadow_scatter"]["texture"] = (
        lambda: ff.shadow_scatter(tx_tables, tx_sh_in, tx_bake),
        lambda: ff.shadow_scatter_plain(tx_tables, tx_sh_in, tx_bake))
    arm_calls["scatter"]["no_sun"] = (
        lambda: sca.scatter_local(sl_tables, sl_sh, sl_bake),
        lambda: sca.scatter_local_plain(sl_tables, sl_sh, sl_bake))
    k6_in["no_sun"] = (sl_tables, sl_sh, sl_bake, None, None)
    k6_in["rays_terrain"] = (dx_tables, dx_sh, None, None, None)
    arm_err = {}
    for k, modes in arm_calls.items():
        for m, (call, twin) in modes.items():
            got, want = call(), twin()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            arm_err[(k, m)] = max(compare(k, g, w_, m)
                                  for g, w_ in zip(got, want))
            errs[k] = max(errs[k], arm_err[(k, m)])
    del got, want
    # the local terrain's arms: the share of elements past the kernel's
    # tolerance between the twin with the local rays over the terrain and
    # without (hf_local off) must exceed what the mode's hold lets past
    flat = lambda o: torch.cat([x.flatten() for x in (
        o if isinstance(o, tuple) else (o,))])
    for k, m, t_on, twin in (
            ("bake_radiance", "terrain_local", hl_tables,
             ff.bake_radiance_plain),
            ("bake_visibility", "terrain_local", dv_tables,
             vis.bake_visibility_plain),
            ("scatter", "rays_terrain", dx_tables,
             lambda t: sca.scatter_local_plain(t, dx_sh))):
        on = flat(twin(t_on))
        off = flat(twin(dataclasses.replace(t_on, hf_local=False)))
        atol, rtol, frac_ok, _ = CHECKS[k]
        frac_ok = ARM_FRACTION.get((k, m), frac_ok)
        share = float(((on - off).abs() > atol + rtol * on.abs())
                      .float().mean())
        log(f"# local terrain: {k} ({m}) changes {share:.3e} of its "
            f"{on.numel()} elements past atol {atol:g} + rtol {rtol:g} "
            f"(its hold lets {frac_ok:g} past)")
        if share <= frac_ok:
            raise AssertionError(f"{k}'s hold cannot see the local terrain")
    del on, off
    lit = ds.dir_shadow(d_tables)
    lit_flat = ds.dir_shadow(dataclasses.replace(d_tables, hf=None,
                                                 hf_static=None))
    terrain_share = float((lit != lit_flat).float().mean())
    log(f"# terrain: the sun's shadow volume of demo_full frame 4 differs "
        f"from the one without the terrain on {terrain_share:.4f} of the "
        f"froxels (its hold lets {CHECKS['dir_shadow'][2]:g} past)")
    if terrain_share <= CHECKS["dir_shadow"][2]:
        raise AssertionError("the sun rays do not see the terrain")
    del lit, lit_flat
    dp_acc = ff.integrate_blend(dp_tables, dp_sc, dp_prev_acc)
    dp_color, dp_depth = demo_gbuf[720]
    dp_grid = dp_r.config.grid
    dp_out = zg.composite_pixels(dp_acc, dp_color, dp_depth, dp_params,
                                 dp_grid)
    if not torch.equal(dp_out, runs["demo_production"][0]):
        raise AssertionError("K1-K4 on demo_production's frame-4 inputs "
                             "differ from the path's image")
    arm_err[("composite", "pixels_720p")] = compare(
        "composite", dp_out, zg.composite_pixels_plain(
            dp_acc, dp_color, dp_depth, dp_params, dp_grid))
    errs["composite"] = max(errs["composite"],
                            arm_err[("composite", "pixels_720p")])

    # the slab forms on real slabs' inputs: each shard's step replayed
    # kernel by kernel from the carry before it (its halos written as the
    # step writes them) reproduces the shard's band bit for bit; on frame 4
    # K1 at each of the four y phases of slab5's shards, K2 with the phased
    # tent, K3 and K4 at row_off = halo (exactly) against their twins, K3
    # also on slab3's middle shard (its "slab_shard" mode); on
    # slab3_staged's frame 2 (the middle shard) K5, K6 with per-light rays
    # over material planes, K3 and K4's per-pixel form
    def slab_shard(name, frame, i):
        """(renderer of shard i, its Slab, its state with the halos written
        as step `frame` writes them, its G-buffer band)."""
        s_r, fn = slab_fns[name]
        n_sh, halo = fn.n_shards, fn.halo
        c = s_r.config
        h_loc, ih_loc = c.volume_height // n_sh, c.image_height // n_sh
        h_ext = h_loc + 2 * halo
        r_loc = VolumetricRenderer(dataclasses.replace(
            c, volume_height=h_ext, image_height=ih_loc))
        slab = shr.Slab(float(i * h_loc - halo), halo, c.grid,
                        c.image_height)
        sts, edges = slab_runs[name][2][frame]
        top = edges[i - 1][1] if i > 0 else edges[i][2]
        bot = edges[i + 1][0] if i < n_sh - 1 else edges[i][3]
        st_i = dataclasses.replace(sts[i], **{
            f: None if getattr(sts[i], f) is None else shr._write_halo(
                getattr(sts[i], f), top[f], bot[f], halo, shr.HALO_AXIS,
                h_ext) for f in shr.HALO_FIELDS})
        band = (scene_color[i * ih_loc:(i + 1) * ih_loc],
                view_depth[i * ih_loc:(i + 1) * ih_loc])
        return r_loc, slab, st_i, band

    slab_err = {}       # (kernel, mode) -> max abs err against the twin
    slab_in = {}        # mode -> the inputs it is timed on
    slab_phases = {}    # path -> each shard's y phase
    for name in ("slab3", "slab5"):
        slab_phases[name] = []
        for i in range(slab_fns[name][1].n_shards):
            r_loc, slab, st_i, (b_sc, b_vd) = slab_shard(name, 3, i)
            t_s, p_s, _ = r_loc.frame_tables(st_i, slab_scene(scene, 3),
                                             0.1 * 3, slab)
            ph = float(t_s.spar[0, 24])
            slab_phases[name].append(int(ph))
            sh_in = st_i.prev_shadow.float().contiguous()
            acc_in = st_i.prev_accumulation.float().contiguous()
            k1 = ff.bake_radiance(t_s)
            sh_s, sc_s = ff.shadow_scatter(t_s, sh_in, k1)
            acc_s = ff.integrate_blend(t_s, sc_s, acc_in)
            w_l, h_l, d_l = r_loc.config.grid
            band_grid = (w_l, h_l - 2 * slab.halo, d_l)
            out_s = zg.composite(acc_s, b_sc, b_vd, p_s, band_grid,
                                 row_off=slab.halo)
            if not torch.equal(out_s, slab_runs[name][1][i]):
                raise AssertionError(f"{name} shard {i}: K1-K4 on its "
                                     "frame-4 inputs differ from its band")
            log(f"# {name} shard {i}: y0 {slab.y0:g}, y phase {ph:g}, low "
                f"grid {t_s.low_dims}, K1-K4 reproduce its band bit for "
                f"bit")
            if name == "slab5":
                m = f"slab_phase{int(ph)}"
                slab_err[("bake_radiance", m)] = max(
                    slab_err.get(("bake_radiance", m), 0.0),
                    compare("bake_radiance", k1,
                            ff.bake_radiance_plain(t_s),
                            label=f"slab5 shard {i}, y phase {int(ph)}"))
                slab_in.setdefault(m, t_s)
            if (name, i) == ("slab5", 1):       # phase 3: K2, K3, K4
                slab_err[("shadow_scatter", "slab_phased")] = max(
                    compare("shadow_scatter", g, w_,
                            label=f"slab5 shard 1, phased tent, {part}")
                    for g, w_, part in zip(
                        (sh_s, sc_s),
                        ff.shadow_scatter_plain(t_s, sh_in, k1),
                        ("history", "planes")))
                errs["integrate_blend"] = max(
                    errs["integrate_blend"], compare(
                        "integrate_blend", acc_s,
                        ff.integrate_blend_plain(t_s, sc_s, acc_in)))
                slab_in["slab_phased"] = (t_s, sh_in, k1)
            if (name, i) == ("slab3", 1):       # the 360x1920 band
                slab_err[("integrate_blend", "slab_shard")] = compare(
                    "integrate_blend", acc_s,
                    ff.integrate_blend_plain(t_s, sc_s, acc_in))
                slab_in["slab_shard"] = (t_s, sc_s, acc_in)
                k4_p = zg.composite_plain(acc_s, b_sc, b_vd, p_s, band_grid,
                                          slab.halo)
                k4_e = compare("composite", out_s, k4_p)
                if k4_e != 0.0:
                    raise AssertionError("K4 with a row offset differs from "
                                         "its twin")
                slab_err[("composite", "slab_row_offset")] = k4_e
                slab_in["slab_row_offset"] = (acc_s, b_sc, b_vd, p_s,
                                              band_grid, slab.halo)
    if sorted(set(slab_phases["slab5"])) != [0, 1, 2, 3]:
        raise AssertionError(f"slab5's shards miss a y phase: "
                             f"{slab_phases['slab5']}")
    r_loc, slab, st_i, (b_sc, b_vd) = slab_shard("slab3_staged", 1, 1)
    scene_1 = slab_scene(scene, 1)
    t_s, p_s, w2v_s = r_loc.frame_tables(st_i, scene_1, 0.1, slab)
    geo_s, scene_s = r_loc.frame_geometry(st_i, scene_1, t_s, p_s, w2v_s)
    mat_s = tuple(v.contiguous() for v in pipeline.write_material_volumes(
        r_loc.config, p_s, geo_s.view_to_world, geo_s.jitter, 0.1,
        scene_s.media))
    sh_in = st_i.prev_shadow.float().contiguous()
    acc_in = st_i.prev_accumulation.float().contiguous()
    sh_s = sb.dir_shadow_blend(t_s, sh_in)
    errs["shadow_blend"] = max(errs["shadow_blend"], compare(
        "shadow_blend", sh_s, sb.dir_shadow_blend_plain(t_s, sh_in),
        label="slab3_staged shard 1"))
    k6_in["rays x planes, slab3_staged shard 1"] = (t_s, sh_s, None, None,
                                                    mat_s)
    errs["scatter"] = max(errs["scatter"], compare(
        "scatter", sca.scatter_local(t_s, sh_s, None, None, mat_s),
        sca.scatter_local_plain(t_s, sh_s, None, None, mat_s),
        label="rays x planes, slab3_staged shard 1"))
    sc_s = pipeline.write_scatter_volume(r_loc.config, t_s, sh_s, mat_s,
                                         geo_s, scene_s, (None, None), 0.1)
    acc_s = ff.integrate_blend(t_s, sc_s, acc_in)
    errs["integrate_blend"] = max(errs["integrate_blend"], compare(
        "integrate_blend", acc_s,
        ff.integrate_blend_plain(t_s, sc_s, acc_in)))
    y_map = (cfg.volume_height, cfg.image_height, slab.halo)
    out_s = zg.composite_pixels(acc_s, b_sc, b_vd, p_s, r_loc.config.grid,
                                y_map)
    if not torch.equal(out_s, slab_runs["slab3_staged"][1][1]):
        raise AssertionError("slab3_staged shard 1: K5, K6, K3 and K4 on "
                             "its frame-2 inputs differ from its band")
    slab_err[("composite", "slab_pixels")] = compare(
        "composite", out_s, zg.composite_pixels_plain(
            acc_s, b_sc, b_vd, p_s, r_loc.config.grid, y_map))
    slab_in["slab_pixels"] = (acc_s, b_sc, b_vd, p_s, r_loc.config.grid,
                              y_map)
    for (k, m), e in slab_err.items():
        errs[k] = max(errs[k], e)
    # the hold of each kernel with its largest difference; for K6, the
    # twin's terms at that froxel (ROADMAP C8)
    for k, (e, lab, at, frac, _) in sorted(LARGEST.items()):
        log(f"# largest difference of {k}: {e:.3e} in its hold {lab!r} at "
            f"{at} (that hold's share past the tolerance {frac:.2e})")
    log(scatter_terms(sca, vis, mtl, k6_in[LARGEST["scatter"][1]],
                      LARGEST["scatter"]))
    log("# slab3_staged shard 1: K5, K6 (rays, material planes), K3 and "
        "K4's per-pixel form reproduce its band bit for bit")
    # the images put together from the bands against the whole grid's
    # (tests/test_shard_render.py's odd-slab-start bounds: relative to the
    # image maximum, under 2e-3 on rows 2..-2 and 0.02 everywhere)
    refs = {}
    for name in ("slab3", "slab3_staged"):     # slab5 renders slab3's frames
        s_r = slab_fns[name][0]
        s_st = s_r.init_state(scene.dir_lights.count)
        for i in range(SLAB_PATHS[name][2]):
            refs[name], _, s_st = s_r.render_frame(
                s_st, slab_scene(scene, i), 0.1 * i, scene_color, view_depth)
    refs["slab5"] = refs["slab3"]
    for name, ref in refs.items():
        rel = (runs[name][0] - ref).abs() / ref.abs().max()
        inner, worst = float(rel[2:-2].max()), float(rel.max())
        row_max = rel.amax(dim=(1, 2))
        rows, rows_far = int((row_max > 0).sum()), int((row_max > 1e-6).sum())
        log(f"# {name} against the whole grid's frame: max relative "
            f"{worst:.3e}, on rows 2..-2 {inner:.3e}, mean "
            f"{float(rel.mean()):.3e}, {rows} of {rel.shape[0]} rows differ, "
            f"{rows_far} by more than 1e-6 (bounds 0.02 and 2e-3)")
        if not (inner < 2e-3 and worst < 0.02):
            raise AssertionError(f"{name} differs from the whole grid's "
                                 "image")
    del refs, s_st

    # 6. timing
    one_frame, st = frame_times("fused", renderer, scene, scene_color,
                                view_depth, states[-1], 20)
    t0 = time.perf_counter()
    for _ in range(20):
        renderer.frame_tables(st, scene, 0.5)
    torch.cuda.synchronize()
    log(f"# host prep (frame_tables): "
        f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms/frame")
    profile_frames(one_frame, 5)
    one_staged, _ = frame_times("staged", renderers["staged"], scene,
                                scene_color, view_depth,
                                runs["staged"][1][-1], 20)
    profile_frames(one_staged, 5)
    _, x_st = frame_times("exact", renderers["exact"], scene, scene_color,
                          view_depth, runs["exact"][1][-1], 5)
    t0 = time.perf_counter()
    for _ in range(20):
        renderers["exact"].frame_tables(x_st, scene, 0.5)
    torch.cuda.synchronize()
    log(f"# host prep (frame_tables), exact: "
        f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms/frame")
    one_history, _ = frame_times("history", h_r, scene, scene_color,
                                 view_depth, runs["history"][1][-1], 5)
    profile_frames(one_history, 3)
    frame_times("vis_bake", renderers["vis_bake"], scene, scene_color,
                view_depth, runs["vis_bake"][1][-1], 20)
    for name, n_f in (("fused_exact", 5), ("fused_vis", 20),
                      ("uhd_exact", 10), ("uhd", 10)):
        one, _ = frame_times(name, renderers[name], scene, *gbuf(name),
                             runs[name][1][-1], n_f)
        if name != "fused_exact":
            profile_frames(one, 3)
    # the co-sited composite whole (K4's planes, the plain upsample and
    # blend) on uhd_exact's frame-2 accumulation
    step_times("uhd co-sited composite (K4 planes + plain upsample + blend)",
               lambda: zg.composite_cosited(u_acc, color_4k, depth_4k,
                                            u_params, cfg.grid, 2), 10)
    # the demo scene's paths (the map paths with their maps baked up
    # front), and the XLA scatter's paths and the scatter alone
    for name, n_f in (("demo_full", 20), ("demo_production", 20),
                      ("demo_hf_local", 10), ("demo_exact_hf", 5),
                      ("demo_vis_hf", 10), ("demo_map_dir", 10),
                      ("fractional", 10), ("demo_xla", 5),
                      ("xla_scatter", 5)):
        one, _ = frame_times(name, renderers[name], scene_of(name),
                             *gbuf(name), runs[name][1][-1], n_f,
                             bakes[name])
        if name in ("demo_full", "demo_production") + XLA_SCATTER_PATHS:
            profile_frames(one, 3)
    for name in XLA_SCATTER_PATHS:
        fn = lambda a=xla_args[name]: pipeline.write_scatter_xla(*a)
        step_times(f"{name}, the plain XLA scatter alone", fn, 3)
        profile_frames(fn, 2)
    # the texture, sunless and media-less paths, and the plain passes the
    # texture adds: the noise channels of tex, the material volumes of
    # tex_staged (the texture at every froxel) and tex_lowres (at 1/4^3 of
    # them, tent-upsampled)
    for name, n_f in (("tex", 20), ("tex_staged", 10), ("tex_lowres", 10),
                      ("demo_noise", 5), ("sunless", 10), ("no_media", 10)):
        one, _ = frame_times(name, renderers[name], scene_of(name),
                             *gbuf(name), runs[name][1][-1], n_f,
                             bakes[name])
        profile_frames(one, 3)
    step_times("tex: bake_noise_channels (plain torch)",
               lambda: vis.bake_noise_channels(
                   tx_r.config, tx_params, tx_geo.view_to_world,
                   tx_geo.jitter, tx_dev.media, 0.3, tx_tables.ss), 10)
    for name in ("tex_staged", "tex_lowres"):
        step_times(f"{name}: write_material_volumes (plain torch)",
                   lambda c=renderers[name].config: (
                       pipeline.write_material_volumes(
                           c, ts_params, ts_geo.view_to_world,
                           ts_geo.jitter, 0.3, ts_dev.media)), 5)
    one_map_dir, _ = frame_times("map_dir", m_r, scene, scene_color,
                                 view_depth, runs["map_dir"][1][-1], 20,
                                 bakes["map_dir"])
    profile_frames(one_map_dir, 5)
    one_map, _ = frame_times("map", renderers["map"], scene, scene_color,
                             view_depth, runs["map"][1][-1], 20, bakes["map"])
    profile_frames(one_map, 3)
    t0 = time.perf_counter()
    for _ in range(20):
        m_r.frame_tables(m_prev, scene, 0.5)
        m_r.pcf_tables(m_prev, scene, m_dir)
    torch.cuda.synchronize()
    log(f"# host prep (frame_tables + pcf_tables), map_dir: "
        f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms/frame")
    for name in ("map_dir", "map"):
        fn = lambda r=renderers[name]: r.bake_shadow_data(scene)
        bake_ms = cuda_time_ms(fn, 3)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        log(f"# {name}: bake_shadow_data {bake_ms:.3f} ms device-event mean "
            f"(warm), {1e3 * (time.perf_counter() - t0):.3f} ms host wall")
    # frame + post and the post chain alone (bench.py's frame_post_ms and
    # post_ms scopes), with a fixed camera and the G-buffer given
    fr = renderers["fused"]
    cam = scene.camera
    for name in ("post_bench", "post_showcase"):
        cfg_p = post.PostConfig(**POST_PATHS[name][0])
        box = {"st": runs[name][1][-1], "carry": torch.ones((), device="cuda")
               if name == "post_showcase" else None}

        def frame_post(name=name, cfg_p=cfg_p, box=box):
            _, box["st"], box["carry"] = post_frame(
                name, fr, post, cfg_p, box["st"], scene, 0.5, scene_color,
                view_depth, box["carry"])

        def post_only(name=name, cfg_p=cfg_p, st=states[-1]):
            planes = [img[..., c] for c in range(3)]
            if name == "post_bench":
                return post.apply_post_planes(planes, cfg_p,
                                              view_depth=view_depth)
            vel = post.camera_velocity(view_depth, cam.fov_y, cam.aspect,
                                       cam.view_to_world(),
                                       st.prev_world_to_view)
            scale, _ = post.auto_exposure_step(
                planes, torch.ones((), device="cuda"), cfg_p)
            return post.apply_post(img, cfg_p, view_depth=view_depth,
                                   velocity=vel, exposure_scale=scale,
                                   dither_frame=st.frame_count)

        step_times(f"{name} frame + post", frame_post, 10)
        profile_frames(frame_post, 3)
        step_times(f"{name} post chain alone", post_only, 10)
        profile_frames(post_only, 3)

    # the slab frames: n shards one after the other (total and per shard),
    # and one shard's host prep
    for name, (_, n_sh, _, _) in SLAB_PATHS.items():
        fn = slab_fns[name][1]
        box = {"c": slab_runs[name][2][-1]}

        def one_slab(fn=fn, box=box):
            _, box["c"] = fn(box["c"], scene, 0.5)

        n_f = 3 if name == "slab3_staged" else 10
        ev_ms = cuda_time_ms(one_slab, n_f)
        t0 = time.perf_counter()
        for _ in range(n_f):
            one_slab()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_f
        log(f"# {name} frame: {ev_ms:.3f} ms device-event mean "
            f"({ev_ms / n_sh:.3f} per shard), {wall_ms:.3f} ms host wall "
            f"mean ({wall_ms / n_sh:.3f} per shard) over {n_f} warm frames "
            f"of {n_sh} shards")
        profile_frames(one_slab, 2 if name == "slab3_staged" else 3)
        r_loc, slab, st_i, _ = slab_shard(name, 1, 0)
        t0 = time.perf_counter()
        for _ in range(20):
            r_loc.frame_tables(st_i, scene, 0.5, slab)
        torch.cuda.synchronize()
        log(f"# host prep (frame_tables), {name}: "
            f"{1e3 * (time.perf_counter() - t0) / 20:.3f} ms per shard")

    for what, fn in (
            ("write_material_volumes", lambda: pipeline.write_material_volumes(
                h_r.config, h_params, geo.view_to_world, geo.jitter, 0.3,
                scene_dev.media)),
            ("reproject_texel", lambda: pipeline.reproject_texel(
                geo, False, 0.0)),
            ("plain accumulate", lambda: pipeline.accumulate(
                h_r.config, h_tables, h_prev_sc, h_params, False))):
        log(f"# history frame, plain torch {what}: "
            f"{cuda_time_ms(fn, 3):.3f} ms")

    n = 20
    ms = {
        "bake_radiance": kernel_time_ms(lambda: ff.bake_radiance(tables), n),
        "shadow_scatter": kernel_time_ms(
            lambda: ff.shadow_scatter(tables, prev_sh, bake), n),
        "integrate_blend": kernel_time_ms(
            lambda: ff.integrate_blend(tables, sc, prev_acc), n),
        "composite": kernel_time_ms(
            lambda: zg.composite(acc, scene_color, view_depth, params,
                                 cfg.grid), n),
        "shadow_blend": kernel_time_ms(
            lambda: sb.dir_shadow_blend(tables, prev_sh), n),
        "scatter": kernel_time_ms(
            lambda: sca.scatter_local(tables, sh, bake), n),
        "dir_shadow": kernel_time_ms(lambda: ds.dir_shadow(tables), n),
        "integrate": kernel_time_ms(lambda: integ.accumulate(tables, sc), n),
        "bake_visibility": kernel_time_ms(
            lambda: vis.bake_visibility(h_tables), n),
        "temporal_blend": kernel_time_ms(blend_a, n),
        "windowed_warp": kernel_time_ms(
            lambda: wp.windowed_warp(h_prev_sc, tx, ty, tz, kk), n),
        "pcf_shadow": kernel_time_ms(
            lambda: pcf.pcf_shadow(pcf_low, m_dir.atlas), n),
        "ssr_march": kernel_time_ms(lambda: ssr_ops.ssr_march(*m_args), n),
    }
    pcf_full_ms = kernel_time_ms(lambda: pcf.pcf_shadow(pcf_full, f_dir.atlas),
                                 n)
    weight_ms = kernel_time_ms(blend_w, n)
    mode_ms = {m: kernel_time_ms(lambda a=a: sca.scatter_local(*a), n)
               for m, a in k6_modes.items()}
    per_light_ms = kernel_time_ms(lambda: sca.scatter_local(x_tables, x_sh), 5)
    k1_ms = {"lights40": kernel_time_ms(lambda: ff.bake_radiance(t40), n)}
    k9_ms = {"lights40": kernel_time_ms(lambda: vis.bake_visibility(v40), n)}
    k2_ms = {m: kernel_time_ms(lambda a=a: ff.shadow_scatter(a[0], a[1],
                                                             vis=a[2]),
                               5 if m == "rays" else n)
             for m, a in k2_in.items()}
    k4_ms = {
        "cells_16x16": kernel_time_ms(lambda: zg.composite(
            u_acc, color_4k, depth_4k, u_params, cfg.grid), n),
        "cosited_planes": kernel_time_ms(lambda: zg.composite_planes(
            u_acc, depth_lo, u_params, cfg.grid, w9_lo), n)}
    n_p = 3
    plain_ms = {
        "bake_radiance": cuda_time_ms(lambda: ff.bake_radiance_plain(tables),
                                      n_p),
        "shadow_scatter": cuda_time_ms(
            lambda: ff.shadow_scatter_plain(tables, prev_sh, bake), n_p),
        "integrate_blend": cuda_time_ms(
            lambda: ff.integrate_blend_plain(tables, sc, prev_acc), n_p),
        "composite": cuda_time_ms(
            lambda: zg.composite_plain(acc, scene_color, view_depth, params,
                                       cfg.grid), n_p),
        "shadow_blend": cuda_time_ms(
            lambda: sb.dir_shadow_blend_plain(tables, prev_sh), n_p),
        "scatter": cuda_time_ms(
            lambda: sca.scatter_local_plain(tables, sh, bake), n_p),
        "dir_shadow": cuda_time_ms(lambda: ds.dir_shadow_plain(tables), n_p),
        "integrate": cuda_time_ms(
            lambda: integ.accumulate_plain(tables, sc), n_p),
        "bake_visibility": cuda_time_ms(
            lambda: vis.bake_visibility_plain(h_tables), n_p),
        "temporal_blend": cuda_time_ms(
            lambda: tmp.temporal_blend_plain(tables.abpar, prev_acc, acc_un,
                                             whd, hg, kk, "alpha"), n_p),
        "windowed_warp": cuda_time_ms(
            lambda: wp.windowed_warp_plain(h_prev_sc, tx, ty, tz, kk), n_p),
        "pcf_shadow": cuda_time_ms(
            lambda: pcf.pcf_shadow_plain(pcf_low, m_dir.atlas), n_p),
        "ssr_march": cuda_time_ms(
            lambda: ssr_ops.ssr_march_reference(*m_args), n_p),
    }
    pcf_full_plain_ms = cuda_time_ms(
        lambda: pcf.pcf_shadow_plain(pcf_full, f_dir.atlas), n_p)
    weight_plain_ms = cuda_time_ms(
        lambda: tmp.temporal_blend_plain(tables.sbpar, prev_sh, unblended,
                                         whd, hg, kk, "weight"), n_p)
    mode_plain_ms = {m: cuda_time_ms(
        lambda a=a: sca.scatter_local_plain(*a), 1)
        for m, a in k6_modes.items()}
    per_light_plain_ms = cuda_time_ms(
        lambda: sca.scatter_local_plain(x_tables, x_sh), 1)
    k1_plain_ms = {"lights40": cuda_time_ms(
        lambda: ff.bake_radiance_plain(t40), 1)}
    k9_plain_ms = {"lights40": cuda_time_ms(
        lambda: vis.bake_visibility_plain(v40), 1)}
    k2_plain_ms = {m: cuda_time_ms(
        lambda a=a: ff.shadow_scatter_plain(a[0], a[1], vis=a[2]), 1)
        for m, a in k2_in.items()}
    k4_plain_ms = {
        "cells_16x16": cuda_time_ms(lambda: zg.composite_plain(
            u_acc, color_4k, depth_4k, u_params, cfg.grid), 1),
        "cosited_planes": cuda_time_ms(lambda: zg.composite_planes_plain(
            u_acc, depth_lo, u_params, cfg.grid, w9_lo), 1)}
    # the terrain and fractional arms, and K4's per-pixel form
    arm_calls["composite"] = {"pixels_720p": (
        lambda: zg.composite_pixels(dp_acc, dp_color, dp_depth, dp_params,
                                    dp_grid),
        lambda: zg.composite_pixels_plain(dp_acc, dp_color, dp_depth,
                                          dp_params, dp_grid))}
    arm_ms, arm_plain_ms = {}, {}
    for k, modes in arm_calls.items():
        for m, (call, twin) in modes.items():
            arm_ms[(k, m)] = kernel_time_ms(
                call, 5 if m == "rays_terrain" else n)
            arm_plain_ms[(k, m)] = cuda_time_ms(twin, 1)
    # the slab forms: K1 at each phase, K2 with the phased tent, K4 with a
    # row offset and K4's per-pixel form on a slab's rows
    slab_calls = {
        ("integrate_blend", "slab_shard"): (
            lambda a=slab_in["slab_shard"]: ff.integrate_blend(*a),
            lambda a=slab_in["slab_shard"]: ff.integrate_blend_plain(*a)),
        ("shadow_scatter", "slab_phased"): (
            lambda a=slab_in["slab_phased"]: ff.shadow_scatter(*a),
            lambda a=slab_in["slab_phased"]: ff.shadow_scatter_plain(*a)),
        ("composite", "slab_row_offset"): (
            lambda a=slab_in["slab_row_offset"]: zg.composite(
                *a[:5], row_off=a[5]),
            lambda a=slab_in["slab_row_offset"]: zg.composite_plain(*a)),
        ("composite", "slab_pixels"): (
            lambda a=slab_in["slab_pixels"]: zg.composite_pixels(*a),
            lambda a=slab_in["slab_pixels"]: zg.composite_pixels_plain(*a)),
    }
    for ph in range(4):
        t_ph = slab_in[f"slab_phase{ph}"]
        slab_calls[("bake_radiance", f"slab_phase{ph}")] = (
            lambda t=t_ph: ff.bake_radiance(t),
            lambda t=t_ph: ff.bake_radiance_plain(t))
    slab_ms = {km: kernel_time_ms(call, n)
               for km, (call, _) in slab_calls.items()}
    slab_plain_ms = {km: cuda_time_ms(twin, 1)
                     for km, (_, twin) in slab_calls.items()}
    # yardstick for K4: one grid_sample computing the same trilinear of
    # (L, T) at (pixel -> froxel xy, fz), border clamp (used nowhere else);
    # at 1080p, at 4K (16x16-pixel cells) and at the co-sited pixels (every
    # second 4K pixel of each axis)
    w, h, d = cfg.grid

    def sample_grid(p, depth, d=d):
        ih_, iw_ = depth.shape
        fz_ = torch.clamp(froxel.depth_to_froxel_z(p, depth) - 0.5, 0.0,
                          d - 1.0)
        gx = ((torch.arange(iw_, device="cuda") + 0.5) / iw_ * 2.0 - 1.0)
        gy = ((torch.arange(ih_, device="cuda") + 0.5) / ih_ * 2.0 - 1.0)
        gz = (fz_ + 0.5) / d * 2.0 - 1.0
        return torch.stack([gx[None, :].expand(ih_, iw_),
                            gy[:, None].expand(ih_, iw_), gz],
                           dim=-1)[None, None].contiguous()

    def yardstick(label, vol, grid, t_k4):
        gs = lambda: torch.nn.functional.grid_sample(
            vol[None], grid, mode="bilinear", padding_mode="border",
            align_corners=False)
        t_ms = kernel_time_ms(gs, n)
        gs_err = float((gs()[0, 3, 0] - t_k4).abs().max())
        log(f"# grid_sample yardstick, {label}: {t_ms:.4f} ms, max |T - K4 "
            f"T| {gs_err:.2e}")
        return t_ms

    ih, iw = view_depth.shape
    lib_ms = yardstick("1080p", acc, sample_grid(params, view_depth),
                       out[..., 3])
    grid_4k = sample_grid(u_params, depth_4k)
    k4_lib_ms = {
        "cells_16x16": yardstick("3840x2160", u_acc, grid_4k, x_img[..., 3]),
        "cosited_planes": yardstick(
            "co-sited 1920x1080", u_acc,
            grid_4k[:, :, ::2, ::2].contiguous(), lo_planes[3])}
    del grid_4k
    arm_lib_ms = {("composite", "pixels_720p"): yardstick(
        "1280x720 on 160x88x64 (per-pixel form)", dp_acc,
        sample_grid(dp_params, dp_depth, dp_grid[2]), dp_out[..., 3])}

    def slab_grid(p, depth, h_ext, y_of_row):
        """grid_sample coordinates of a band over a slab's extended
        accumulation of h_ext rows: band row v at acc row y_of_row(v)."""
        g = sample_grid(p, depth)
        fy = y_of_row(torch.arange(depth.shape[0], device="cuda") + 0.5)
        g[..., 1] = ((fy + 0.5) / h_ext * 2.0 - 1.0)[None, None, :, None]
        return g

    a_ro = slab_in["slab_row_offset"]
    h_ext_ro = a_ro[0].shape[2]
    py_ro = a_ro[2].shape[0] // a_ro[4][1]
    a_px = slab_in["slab_pixels"]
    ih_g, h_g = cfg.image_height, cfg.volume_height
    slab_lib_ms = {
        ("composite", "slab_row_offset"): yardstick(
            f"band {tuple(a_ro[2].shape)} at row_off {a_ro[5]}", a_ro[0],
            slab_grid(a_ro[3], a_ro[2], h_ext_ro,
                      lambda v: v / py_ro - 0.5 + a_ro[5]),
            zg.composite(*a_ro[:5], row_off=a_ro[5])[..., 3]),
        ("composite", "slab_pixels"): yardstick(
            f"band {tuple(a_px[2].shape)}, per-pixel form", a_px[0],
            slab_grid(a_px[3], a_px[2], a_px[0].shape[2],
                      lambda v: v * (h_g / ih_g) - 0.5 + a_px[5][2]),
            zg.composite_pixels(*a_px)[..., 3])}

    # bounds from this run's inputs (bytes each read once / written once;
    # the operations the function needs, counted from the plain versions'
    # arithmetic, at the fp32 rate)
    wl, hl, dl = tables.low_dims
    n_low = wl * hl * dl
    n_fro = w * h * d
    n_pix = ih * iw
    nd = tables.n_dir
    prims = tables.n_planes + tables.n_spheres + tables.n_boxes
    ops_ray = 14 * tables.n_planes + 22 * tables.n_spheres \
        + 30 * tables.n_boxes
    active_pairs = int(tables.active.sum()) * hl * wl
    # the exact path's (froxel, light) pairs: each slice's scheduled lights
    full_pairs = int(x_tables.count.sum()) * h * w
    ops_perlin = 3 * 8 * 40      # 3 octaves x 8 corners x hash + grad + lerp
    n_noise = tables.n_noise
    n_media = len(scene.media)
    n_lights = h_tables.lights.shape[0]
    h_active_pairs = int(h_tables.active.sum()) * hl * wl
    # the history path's (froxel, light) pairs: each slice's scheduled lights
    h_pairs = int(h_tables.count.sum()) * h * w
    # one reprojection per froxel and blend: the three tent passes read
    # offsets taken at their own output points, so each froxel's offset
    # triple serves all three (the kernels recompute neighbours' offsets,
    # which is their choice, not the function's work)
    ops_reproj = 45
    # the three 1-D tent passes: 6 tent weights (4 ops each) per froxel,
    # then 6 taps (multiply + add) per channel
    warp = lambda channels: 24 + 12 * channels
    ops_shadow = ops_reproj + warp(nd) + nd * (30 + ops_ray)
    ops_scatter = (3 + n_noise) * 20 + 60 * n_media + 40 * nd + 40
    ops_integrate = 4 * 20 + 30
    work = {
        "bake_radiance": (
            4 * (3 + n_noise) * n_low,
            n_low * (60 + ops_perlin * n_noise)
            + active_pairs * (60 + ops_ray)),
        "shadow_scatter": (
            4 * (nd * n_fro + (3 + n_noise) * n_low
                 + nd * n_fro + 4 * n_fro),
            n_fro * (ops_shadow + ops_scatter)),
        "integrate_blend": (
            4 * (4 * n_fro + 4 * n_fro + 4 * n_fro),
            n_fro * (ops_integrate + ops_reproj + warp(4) + 12)),
        "composite": (
            4 * (4 * n_fro + n_pix + 3 * n_pix + 4 * n_pix),
            n_pix * (20 + 8 * 4 * 2 + 16)),
        "shadow_blend": (4 * 2 * nd * n_fro, n_fro * ops_shadow),
        "scatter": (
            4 * (nd * n_fro + (3 + n_noise) * n_low + 4 * n_fro),
            n_fro * ops_scatter),
        "dir_shadow": (4 * nd * n_fro, n_fro * nd * (30 + ops_ray)),
        "integrate": (4 * (4 * n_fro + 4 * n_fro), n_fro * ops_integrate),
        # K9: one ray and its set-up per (low sample, light) pair that
        # low_slice_active keeps
        "bake_visibility": (4 * n_lights * n_low,
                            h_active_pairs * (40 + ops_ray)),
        # K10, alpha mode: prev, cur and out of the 4 accumulation channels
        "temporal_blend": (4 * 12 * n_fro,
                           n_fro * (ops_reproj + warp(4) + 12)),
        # K11 at 4 channels: the volume and 3 target volumes in, the volume
        # out; 3 offsets (4 ops each) where temporal_blend reprojects
        "windowed_warp": (4 * (4 + 3 + 4) * n_fro, n_fro * (12 + warp(4))),
    }
    # K12: the atlas read once and the volume written once; per output
    # froxel its world position, per (froxel, active cascade) pair the
    # affine coordinates, 4 compares, the bilinear weights and the sphere
    # tests
    s2 = m_dir.atlas.shape[-1]

    def pcf_work(t):
        wq, hq, dq = t.grid_whd
        n_out = nd * wq * hq * dq
        pairs = int(t.count.sum()) * hq * wq
        return 4 * (nd * s2 * s2 + n_out), n_out * 45 + pairs * 50

    work["pcf_shadow"] = pcf_work(pcf_low)
    # K13: 8 planes in and 5 out; per valid pixel its own bin's taps, ~28
    # operations each (two 1/z lines and divides, the crossing and onscreen
    # tests, the first-hit weight and five accumulators)
    m_counts = torch.tensor([len(b) for b in m_args[6]], device="cuda")
    m_taps = int((m_counts[m_args[4].long().clamp(0, len(m_args[6]) - 1)]
                  * m_args[5]).sum())
    work["ssr_march"] = (4 * 13 * hq * wq, 28 * m_taps)
    weight_work = (4 * 3 * nd * n_fro,
                   n_fro * (ops_reproj + warp(nd) + 3 * nd))
    # K6 per-light: the shadow in, the planes out; per froxel the material
    # with its Perlin and the sun term, per scheduled (froxel, light) pair
    # the light factor and one ray
    noise_media = sum(1 for st in x_tables.media_static if st[0])
    per_light_work = (
        4 * (nd * n_fro + 4 * n_fro),
        n_fro * (60 * n_media + ops_perlin * noise_media + 40 * nd + 40)
        + full_pairs * (60 + ops_ray))
    # K6's further modes: per froxel the sun term and (fused) the material
    # with its Perlin, per scheduled pair the light factor and one upsample
    # of the light's visibility (baked), or three upsamples (radiance)
    sun = 40 * nd + 40
    mode_work = {
        "baked_planes": (
            4 * (nd * n_fro + n_lights * n_low + 4 * n_fro + 3 * n_fro),
            n_fro * sun + h_pairs * (60 + 20)),
        "baked_fused": (
            4 * (nd * n_fro + n_lights * n_low + 4 * n_fro),
            n_fro * (60 * n_media + ops_perlin * noise_media + sun)
            + h_pairs * (60 + 20)),
        "radiance_planes": (
            4 * (nd * n_fro + 3 * n_low + 4 * n_fro + 3 * n_fro),
            n_fro * (3 * 20 + sun)),
    }
    # K2's per-light modes: K5's work (shadow, blend) and K6's in the same
    # mode (material with its Perlin, the sun term, per scheduled pair the
    # light factor and a ray or one visibility upsample); the previous
    # shadow (and the visibility volume) in, shadow and planes out
    k2_pairs = {m: int(a[0].count.sum()) * h * w for m, a in k2_in.items()}
    k2_work = {m: (
        4 * (2 * nd * n_fro + 4 * n_fro
             + (n_lights * n_low if m == "baked" else 0)),
        n_fro * (ops_shadow + 60 * n_media + ops_perlin * noise_media + sun)
        + k2_pairs[m] * (60 + (ops_ray if m == "rays" else 20)))
        for m in k2_in}
    # K4 at 4K: the accumulation, depth and scene in, the image out; the
    # co-sited planes at 1920x1080: no scene, four planes out
    n_4k = depth_4k.numel()
    n_lo = depth_lo.numel()
    k4_work = {
        "cells_16x16": (4 * (4 * n_fro + n_4k + 3 * n_4k + 4 * n_4k),
                        n_4k * (20 + 8 * 4 * 2 + 16)),
        "cosited_planes": (4 * (4 * n_fro + n_lo + 4 * n_lo),
                           n_lo * (20 + 8 * 4 * 2))}

    # the terrain and fractional arms: each mode's work without the terrain
    # as above, from its own tables, plus the terrain samples its rays take
    # in this run (march_samples: none where a primitive occludes first or
    # the band is empty, else up to the first sample below the surface), at
    # one fBm per sample (the march's set-up + 320 per octave)
    def march_samples(t, wx, wy, wz, dx, dy, dz, max_t, local, mask=None):
        kw = t.occluders(local)
        hs = kw["hf_static"]
        if hs is None:
            return 0
        first = occl.any_hit(t.planes, t.spheres, t.boxes, wx, wy, wz, dx,
                             dy, dz, max_t, **dict(kw, hf_static=None))
        lo, hi = mtl.heightfield_band(t.hf, hs, wy, dy, max_t)
        run = (first.to(torch.float32) < 1.0) & (hi > lo)
        if mask is not None:
            run = run & mask
        count = torch.zeros(run.shape, dtype=torch.int64, device="cuda")
        for i in range(hs[3]):
            count += run.long()
            run = run & ~mtl.heightfield_below(t.hf, hs, lo, hi, i, wx, wy,
                                               wz, dx, dy, dz)
        return int(count.sum())

    def sun_samples(t):
        zs = torch.arange(t.grid_whd[2], device="cuda")[:, None, None]
        wx, wy, wz = ds.froxel_world(t.spar, zs, t.grid_whd, t.h_glob)
        return sum(march_samples(t, wx, wy, wz, -q[0], -q[1], -q[2], 1e4,
                                 False) for q in t.slights)

    def local_samples(t, low):
        if low:
            ms_ = torch.arange(t.low_dims[2], device="cuda")[:, None, None]
            wx, wy, wz = vis.bake_world_planes(t.spar, ms_, t.grid_whd,
                                               t.ss, t.h_glob)
            mask_of = lambda li: t.active[li].bool()[:, None, None]
        else:
            zs = torch.arange(t.grid_whd[2], device="cuda")[:, None, None]
            wx, wy, wz = ds.froxel_world(t.spar, zs, t.grid_whd, t.h_glob)
            sched = sca.schedule_mask(t.order, t.count)
            mask_of = lambda li: sched[:, li][:, None, None]
        total = 0
        for li, q in enumerate(t.lights):
            tx, ty, tz = wx - q[0], wy - q[1], wz - q[2]
            d2 = tx * tx + ty * ty + tz * tz
            inv_d = torch.rsqrt(d2 + 1e-18)
            total += march_samples(t, wx, wy, wz, -tx * inv_d, -ty * inv_d,
                                   -tz * inv_d, d2 * inv_d - 0.05, True,
                                   mask_of(li))
        return total

    geo_ops = lambda t: 14 * t.n_planes + 22 * t.n_spheres + 30 * t.n_boxes
    ops_hf = lambda t: 20 + 320 * t.hf_static[0]
    n_fro_of = lambda t: math.prod(t.grid_whd)
    n_low_of = lambda t: math.prod(t.low_dims)
    plane_of = lambda t: t.low_dims[0] * t.low_dims[1]
    shadow_ops = lambda t: ops_reproj + warp(t.n_dir) + t.n_dir * (
        30 + geo_ops(t))
    # K1 on 40 lights: as the full grid's, from its own tables
    k1_work = {"lights40": (
        4 * (3 + t40.n_noise) * n_low_of(t40),
        n_low_of(t40) * (60 + ops_perlin * t40.n_noise)
        + int(t40.active.sum()) * plane_of(t40) * (60 + geo_ops(t40)))}
    # K9 on 40 lights: as the history path's, from its own tables
    k9_work = {"lights40": (
        4 * v40.lights.shape[0] * n_low_of(v40),
        int(v40.active.sum()) * plane_of(v40) * (40 + geo_ops(v40)))}
    samples = {"sun": {}, "low": {}, "full": {}}
    for t_name, t in (("demo_full", d_tables), ("demo_exact_hf", dx_tables),
                      ("fractional", fr_tables),
                      ("demo_production", dp_tables)):
        samples["sun"][t_name] = sun_samples(t)
    samples["low"]["demo_hf_local"] = local_samples(hl_tables, True)
    samples["low"]["demo_vis_hf"] = local_samples(dv_tables, True)
    samples["full"]["demo_exact_hf"] = local_samples(dx_tables, False)
    log(f"# terrain samples marched per launch: {json.dumps(samples)}")
    arm_work = {}
    for m, t, n_s in (
            ("terrain_local", hl_tables, samples["low"]["demo_hf_local"]),
            ("demo_grid", dp_tables, 0), ("fractional", fr_tables, 0)):
        arm_work[("bake_radiance", m)] = (
            4 * (3 + t.n_noise) * n_low_of(t),
            n_low_of(t) * (60 + ops_perlin * t.n_noise)
            + int(t.active.sum()) * plane_of(t) * (60 + geo_ops(t))
            + n_s * ops_hf(t))
    for m, t_name, t in (("terrain", "demo_full", d_tables),
                         ("demo_grid", "demo_production", dp_tables),
                         ("fractional", "fractional", fr_tables)):
        nf, nl = n_fro_of(t), n_low_of(t)
        arm_work[("shadow_scatter", m)] = (
            4 * (2 * t.n_dir * nf + (3 + t.n_noise) * nl + 4 * nf),
            nf * (shadow_ops(t) + (3 + t.n_noise) * 20
                  + 60 * len(t.media_static) + 40 * t.n_dir + 40)
            + samples["sun"][t_name] * ops_hf(t))
    nf = n_fro_of(dp_tables)
    arm_work[("integrate_blend", "demo_grid")] = (
        4 * 12 * nf, nf * (ops_integrate + ops_reproj + warp(4) + 12))
    t = dx_tables
    nf = n_fro_of(t)
    arm_work[("shadow_blend", "terrain")] = (
        4 * 2 * t.n_dir * nf,
        nf * shadow_ops(t) + samples["sun"]["demo_exact_hf"] * ops_hf(t))
    noise_m = sum(1 for st in t.media_static if st[0])
    arm_work[("scatter", "rays_terrain")] = (
        4 * (t.n_dir * nf + 4 * nf),
        nf * (60 * len(t.media_static) + ops_perlin * noise_m
              + 40 * t.n_dir + 40)
        + int(t.count.sum()) * t.grid_whd[0] * t.grid_whd[1]
        * (60 + geo_ops(t))
        + samples["full"]["demo_exact_hf"] * ops_hf(t))
    t = d_tables
    arm_work[("dir_shadow", "terrain")] = (
        4 * t.n_dir * n_fro_of(t),
        n_fro_of(t) * t.n_dir * (30 + geo_ops(t))
        + samples["sun"]["demo_full"] * ops_hf(t))
    t = dv_tables
    arm_work[("bake_visibility", "terrain_local")] = (
        4 * t.lights.shape[0] * n_low_of(t),
        int(t.active.sum()) * plane_of(t) * (40 + geo_ops(t))
        + samples["low"]["demo_vis_hf"] * ops_hf(t))
    n_720 = dp_depth.numel()
    arm_work[("composite", "pixels_720p")] = (
        4 * (4 * math.prod(dp_grid) + n_720 + 3 * n_720 + 4 * n_720),
        n_720 * (20 + 8 * 4 * 2 + 16))
    # the texture and sunless modes: K1 with no noise channel (its three
    # radiance channels written), K2 reading the noise channels, K6 with no
    # sun (no shadow read, no sun term), each from its own tables
    t = tx_k1
    arm_work[("bake_radiance", "texture")] = (
        4 * 3 * n_low_of(t),
        n_low_of(t) * 60
        + int(t.active.sum()) * plane_of(t) * (60 + geo_ops(t)))
    t = tx_tables
    nf, nl = n_fro_of(t), n_low_of(t)
    arm_work[("shadow_scatter", "texture")] = (
        4 * (2 * t.n_dir * nf + (3 + t.n_noise) * nl + 4 * nf),
        nf * (shadow_ops(t) + (3 + t.n_noise) * 20
              + 60 * len(t.media_static) + 40 * t.n_dir + 40))
    t = sl_tables
    nf, nl = n_fro_of(t), n_low_of(t)
    arm_work[("scatter", "no_sun")] = (
        4 * ((3 + t.n_noise) * nl + 4 * nf),
        nf * ((3 + t.n_noise) * 20 + 60 * len(t.media_static) + 40))
    # the slab forms: as their whole-grid forms, from the slab's tables;
    # K4 reads the h_out + 2 accumulation rows its band needs (row offset)
    # or the rows its taps reach (per-pixel)
    slab_work = {}
    for ph in range(4):
        t = slab_in[f"slab_phase{ph}"]
        slab_work[("bake_radiance", f"slab_phase{ph}")] = (
            4 * (3 + t.n_noise) * n_low_of(t),
            n_low_of(t) * (60 + ops_perlin * t.n_noise)
            + int(t.active.sum()) * plane_of(t) * (60 + geo_ops(t)))
    nf = n_fro_of(slab_in["slab_shard"][0])
    slab_work[("integrate_blend", "slab_shard")] = (
        4 * 12 * nf, nf * (ops_integrate + ops_reproj + warp(4) + 12))
    t = slab_in["slab_phased"][0]
    nf, nl = n_fro_of(t), n_low_of(t)
    slab_work[("shadow_scatter", "slab_phased")] = (
        4 * (2 * t.n_dir * nf + (3 + t.n_noise) * nl + 4 * nf),
        nf * (shadow_ops(t) + (3 + t.n_noise) * 20
              + 60 * len(t.media_static) + 40 * t.n_dir + 40))
    for m in ("slab_row_offset", "slab_pixels"):
        a = slab_in[m]
        n_b = a[2].numel()
        if m == "slab_row_offset":
            rows_read = a[4][1] + 2
        else:
            yk_, _ = zg.pixel_taps(a[2].shape[0], *a[5])
            rows_read = int(yk_.max()) - int(yk_.min()) + 2
        n_acc = 4 * a[0].shape[1] * rows_read * a[0].shape[3]
        slab_work[("composite", m)] = (
            4 * (n_acc + n_b + 3 * n_b + 4 * n_b),
            n_b * (20 + 8 * 4 * 2 + 16))
    # launches of each slab form in the slab paths' runs: K1 and K2 as the
    # shards' steps counted them, summed by the shards' y phase (K2's tent
    # is phased where the phase is not 0), K4 per path
    slab_launch = {}
    for name in ("slab3", "slab5"):
        for ph, counts in slab_runs[name][4].items():
            km = ("bake_radiance", f"slab_phase{ph}")
            slab_launch[km] = slab_launch.get(km, 0) \
                + counts["bake_radiance"]
            if ph:
                km = ("shadow_scatter", "slab_phased")
                slab_launch[km] = slab_launch.get(km, 0) \
                    + counts["shadow_scatter"]
    slab_launch[("integrate_blend", "slab_shard")] = sum(
        launches["integrate_blend"].get(p_, 0) for p_ in SLAB_PATHS)
    slab_launch[("composite", "slab_row_offset")] = sum(
        launches["composite"].get(p_, 0) for p_ in ("slab3", "slab5"))
    slab_launch[("composite", "slab_pixels")] = \
        launches["composite"].get("slab3_staged", 0)
    log(f"# y phases of the shards: {json.dumps(slab_phases)}")
    log(f"# bound inputs: {prims} primitives, {active_pairs} active "
        f"(low sample, light) pairs, {n_noise} noise channel(s), "
        f"{full_pairs} scheduled (froxel, light) pairs on the exact path, "
        f"{h_pairs} on the history path, {h_active_pairs} active (low "
        f"sample, light) pairs in its visibility bake, {k2_pairs} on K2's "
        f"frames")

    def bound(nbytes, nops):
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * nops / FP32_FLOPS
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
            else "operations"

    # 8. the training paths (inverse.py), each from a fresh state with the
    # launch counters set to 0 just before and read just after: K4 forward
    # and K14 backward a step; then K14 against its twin in three forms,
    # the data-parallel step, a checkpoint of demo_xla's state and the
    # refusal of a frame JAX cannot differentiate
    from volumetricrenderer_tpu_torch import inverse
    from volumetricrenderer_tpu_torch.checkpoint import load_state, save_state
    train_launches, train_rec = {}, {}
    for name, (kw, key, _, _) in TRAIN_PATHS.items():
        r_t = VolumetricRenderer(dataclasses.replace(DEMO_CONFIG, **kw))
        sc_t = scenes[key]
        if r_t.config == renderers["demo_xla"].config:
            gb_t, maps_t = demo_gbuf[720], bakes["demo_xla"]
        else:
            gb_t = r_t.render_scene_inputs(sc_t)
            maps_t = r_t.bake_shadow_data(sc_t)
        train_launches[name], train_rec[name] = train_path(
            name, r_t, sc_t, *gb_t, maps_t, inverse, cuda, zg)
    k14 = k14_forms(zg, froxel, demo.camera, sample_grid, bound)
    errs["composite_grad"] = max(v[0] for v in k14.values())
    r_704 = VolumetricRenderer(dataclasses.replace(DEMO_CONFIG,
                                                   **RAYCAST_704))
    frac_scene = scenes["fractional"]
    train_launches["train_sharded"] = train_sharded(
        r_704, frac_scene, *r_704.render_scene_inputs(frac_scene), inverse,
        cuda)
    # checkpoint: demo_xla's state after its 2 frames, saved and loaded,
    # renders the next frame bit for bit
    import io
    x_r, x_state = renderers["demo_xla"], runs["demo_xla"][1][-1]
    buf = io.BytesIO()
    save_state(buf, x_state)
    buf.seek(0)
    x_loaded = load_state(buf, x_r.init_state(demo.dir_lights.count))
    torch.cuda.synchronize()
    cuda.reset_launches()
    x_a = x_r.render_frame(x_state, demo, 0.2, *demo_gbuf[720],
                           bakes["demo_xla"])[0]
    x_b = x_r.render_frame(x_loaded, demo, 0.2, *demo_gbuf[720],
                           bakes["demo_xla"])[0]
    torch.cuda.synchronize()
    ck_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    log(f"# checkpoint: demo_xla's state at frame {x_state.frame_count} "
        f"saved ({buf.getbuffer().nbytes} bytes) and loaded; launches of "
        f"the two next frames {json.dumps(ck_launches)}; equal: "
        f"{torch.equal(x_a, x_b)}")
    if not torch.equal(x_a, x_b) or ck_launches != {"composite": 2} \
            or x_loaded.frame_count != x_state.frame_count:
        raise AssertionError("checkpoint: the loaded state does not resume "
                             "demo_xla bit for bit")
    # grad_refusals: FULL_CONFIG's fused frame under grad on the card
    cuda.reset_launches()
    fog = inverse.FogParams.from_medium(scene.media[0])
    refusal = ""
    try:
        renderer.render_frame(renderer.init_state(1),
                              inverse.scene_with_fog(fog, scene), 0.0,
                              scene_color, view_depth)
    except NotImplementedError as e:
        refusal = str(e)
    log(f"# grad_refusals: FULL_CONFIG under grad raises: {refusal!r}")
    if any(cuda.LAUNCHES.values()) or "frame_volume_fused" not in refusal:
        raise AssertionError("grad_refusals: the refusal must name "
                             "frame_volume_fused and launch nothing")

    kernels = []
    for name in cuda.SOURCES:
        if name == "composite_grad":
            kernels.append(k14_entry(k14, train_launches, REPLACES[name],
                                     bound))
            continue
        b_ms, b_by = bound(*work[name])
        entry = {
            "name": name, "route": "cuda",
            "source": f"volumetricrenderer_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(launches[name].values()),
            "launches_by_path": launches[name],
            "max_abs_err": errs[name],
            "largest_hold": LARGEST.get(name, (None, None))[1],
            "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms if name == "composite" else None,
        }
        log(f"# {name}: {ms[name]:.4f} ms/launch, plain {plain_ms[name]:.3f}"
            f" ms, bound {b_ms:.4f} ms by {b_by} "
            f"({work[name][0] / 1e6:.1f} MB, {work[name][1] / 1e9:.2f} "
            f"GFLOP)")
        # the modes of this slice: K2's per-light loops, K4's 4K cells and
        # co-sited planes, each with the path that launches it
        modes = {
            "bake_radiance": (k1_work, k1_err, k1_ms, k1_plain_ms, {},
                              {"lights40": "checked and timed only"}),
            "bake_visibility": (k9_work, k9_err, k9_ms, k9_plain_ms, {},
                                {"lights40": "checked and timed only"}),
            "shadow_scatter": (k2_work, k2_err, k2_ms, k2_plain_ms, {},
                               {"rays": "fused_exact", "baked": "fused_vis"}),
            "composite": (k4_work, k4_err, k4_ms, k4_plain_ms, k4_lib_ms,
                          {"cells_16x16": "uhd_exact",
                           "cosited_planes": "uhd"}),
        }.get(name)
        for m in (modes[0] if modes else ()):
            m_work, m_err, m_ms, m_plain, m_lib, m_path = modes
            b_ms, b_by = bound(*m_work[m])
            entry[m] = {
                "launches": launches[name].get(m_path[m], 0),
                "max_abs_err": m_err[m], "ms": m_ms[m],
                "plain_ms": m_plain[m], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": m_lib.get(m)}
            log(f"# {name}, {m}: {m_ms[m]:.4f} ms/launch, plain "
                f"{m_plain[m]:.3f} ms, bound {b_ms:.4f} ms by {b_by} "
                f"({m_work[m][0] / 1e6:.1f} MB, {m_work[m][1] / 1e9:.2f} "
                f"GFLOP), launches {entry[m]['launches']} ({m_path[m]})"
                + (f", grid_sample {m_lib[m]:.4f} ms" if m in m_lib else ""))
        # the terrain and fractional arms (demo_scene) and K4's per-pixel
        # form, each with the paths that launch it
        for (k, m), m_work in arm_work.items():
            if k != name:
                continue
            b_ms, b_by = bound(*m_work)
            entry[m] = {
                "launches": sum(launches[name].get(p, 0)
                                for p in ARM_PATHS[(k, m)]),
                "paths": list(ARM_PATHS[(k, m)]),
                "max_abs_err": arm_err[(k, m)], "ms": arm_ms[(k, m)],
                "plain_ms": arm_plain_ms[(k, m)], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": arm_lib_ms.get((k, m))}
            log(f"# {name}, {m}: {arm_ms[(k, m)]:.4f} ms/launch, plain "
                f"{arm_plain_ms[(k, m)]:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({m_work[0] / 1e6:.1f} MB, {m_work[1] / 1e9:.3f} "
                f"GFLOP), launches {entry[m]['launches']} "
                f"({', '.join(ARM_PATHS[(k, m)])})"
                + (f", grid_sample {arm_lib_ms[(k, m)]:.4f} ms"
                   if (k, m) in arm_lib_ms else ""))
        # the slab forms (slab3, slab5, slab3_staged)
        for (k, m), m_work in slab_work.items():
            if k != name:
                continue
            b_ms, b_by = bound(*m_work)
            entry[m] = {
                "launches": slab_launch.get((k, m), 0),
                "max_abs_err": slab_err[(k, m)], "ms": slab_ms[(k, m)],
                "plain_ms": slab_plain_ms[(k, m)], "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": slab_lib_ms.get((k, m))}
            log(f"# {name}, {m}: {slab_ms[(k, m)]:.4f} ms/launch, plain "
                f"{slab_plain_ms[(k, m)]:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({m_work[0] / 1e6:.1f} MB, {m_work[1] / 1e9:.3f} "
                f"GFLOP), launches {entry[m]['launches']}"
                + (f", grid_sample {slab_lib_ms[(k, m)]:.4f} ms"
                   if (k, m) in slab_lib_ms else ""))
        if name == "scatter":
            b_ms, b_by = bound(*per_light_work)
            entry["per_light"] = {
                "max_abs_err": per_light_err, "ms": per_light_ms,
                "plain_ms": per_light_plain_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            log(f"# scatter, per-light mode: {per_light_ms:.4f} ms/launch, "
                f"plain {per_light_plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({per_light_work[0] / 1e6:.1f} MB, "
                f"{per_light_work[1] / 1e9:.2f} GFLOP)")
            for m in k6_modes:
                b_ms, b_by = bound(*mode_work[m])
                entry[m] = {
                    "launches": sum(launches[name].get(p, 0)
                                    for p in K6_MODE_PATHS[m]),
                    "paths": list(K6_MODE_PATHS[m]),
                    "max_abs_err": mode_err[m], "ms": mode_ms[m],
                    "plain_ms": mode_plain_ms[m], "bound_ms": b_ms,
                    "bound_by": b_by}
                log(f"# scatter, {m}: {mode_ms[m]:.4f} ms/launch, plain "
                    f"{mode_plain_ms[m]:.3f} ms, bound {b_ms:.4f} ms by "
                    f"{b_by} ({mode_work[m][0] / 1e6:.1f} MB, "
                    f"{mode_work[m][1] / 1e9:.2f} GFLOP), launches "
                    f"{entry[m]['launches']} "
                    f"({', '.join(K6_MODE_PATHS[m])})")
        if name == "pcf_shadow":
            b_ms, b_by = bound(*pcf_work(pcf_full))
            entry["full_rate"] = {
                "max_abs_err": full_err, "ms": pcf_full_ms,
                "plain_ms": pcf_full_plain_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            log(f"# pcf_shadow, full rate: {pcf_full_ms:.4f} ms/launch, "
                f"plain {pcf_full_plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}")
        if name == "temporal_blend":
            b_ms, b_by = bound(*weight_work)
            entry["weight"] = {
                "max_abs_err": weight_err, "ms": weight_ms,
                "plain_ms": weight_plain_ms, "bound_ms": b_ms,
                "bound_by": b_by}
            log(f"# temporal_blend, weight mode ({nd} channel): "
                f"{weight_ms:.4f} ms/launch, plain {weight_plain_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms by {b_by}")
        kernels.append(entry)
    log(f"# total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": n_dev}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
