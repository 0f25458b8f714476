"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's frames at full width (240x135x128 froxels, 1920x1080 and,
for the uhd paths, 3840x2160, on benchmark_scene with 16 local lights and
procedural noise, and with a 32^3 noise texture, without its sun or without
media; and on the reference demo scene, demo_scene, with its procedural
terrain, also with its tree meshes (mesh_env=True), at 1920x1080 and at the
demo grid, 160x88x64 froxels at 1280x720) through VolumetricRenderer, the
entry point a user calls, and the port's demo entry, and:

  1. prints the device and `nvidia-smi` name + power limit; exits non-zero
     without CUDA;
  2. builds every CUDA kernel from csrc/ (nvcc, all sources in parallel)
     and prints the registers per thread, shared memory per block and
     local (spill) bytes of the kernels of cuda.ATTR_KERNELS (K1-K15)
     (cudaFuncGetAttributes);
  3. computes the G-buffer once per image size; the raster phase: the
     mesh scene's G-buffer at 1920x1080 and 1280x720, timed whole, the
     raster alone and its shading alone (CUDA events and host clock), and
     the 720p one against the same plain code on the CPU;
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
     on benchmark_scene with 9 suns and 9 procedural noise media
     (many_suns_scene), past the fixed forms' 4 suns and 4 fBm channels,
     every launch of K1, K2, K5, K6 and K7 checked to take its general form
     (and every other path's its fixed form: check_forms):
       many_suns         FULL_CONFIG, 4 frames: K1 (9 fBm channels) K2 K3 K4
       many_suns_staged  frame_fused=False, 2 frames: K5 K1 K6 K3 K4
       many_suns_no_shadow_blend  staged, temporal_blend_shadow=False, 1
                         frame: K7 K1 K6 K3 K4
       many_suns_map_dir shadow_mode="map_dir", its 9 suns' maps baked once,
                         2 frames: K12 (9 suns, one launch) K10 (the 9
                         channels in 3 launches) K1 K6 K3 K4
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
     on demo_scene(mesh_env=True) (the tree meshes rasterized into the
     G-buffer, their 20 voxelized proxy boxes of opacity below 1 in every
     shadow ray: 23 boxes in the any-hit loops):
       mesh_full         FULL_CONFIG, 4 frames: K1 K2 K3 K4
       mesh_production   demo.py --production at the demo grid, 2 frames:
                         K1 K2 K3 and K4's per-pixel form
       mesh_demo         DEMO_CONFIG (demo.py --mesh-env's frame), its maps
                         baked once, 2 frames: K4's per-pixel form
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
       post_ssr_hq       render_frame_post with the showcase PostConfig at
                         ssr_steps=64, ssr_dirs=16 (39 taps a bin, past the
                         fixed instances' 32), 2 frames: K1-K4 and K13's
                         GEN instance
       post_ssr_wide     the same at ssr_steps=96, ssr_dirs=64 (54 taps a
                         bin, 55,552 B of table: GEN with its table in
                         device memory), 1 frame
     (the post paths' K13 launches each in the form its table takes,
     cuda.form_counts),
     and the slab paths through make_multislab_render (SLAB_PATHS: slab3,
     slab5 and slab3_staged; slab3_map_dir with K12 at the slab's y0,
     slab3_xla and slab3_tex), each shard's launches counted on their own,
     the new slab paths' images held against the whole grid's (SLAB_EDGE);
     after the holds, shardmap3: make_shardmap_render on 3 spawned ranks of
     one process group (NCCL where it takes them, else gloo with the edge
     rows staged through host memory), every band and cropped state bit
     for bit slab3's, each rank's frame and exchange times logged;
     every main path's K2, K3 and K5-K12 launches in their
     narrow index forms (cuda.index_form_launches);
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
     sun of that one launch = the one-sun launch bit for bit, and on
     many_suns_map_dir's frame 2, its 9 suns in one launch; K13 on the
     SSR inputs of post_showcase's
     last frame, and its launch geometry; on the same inputs K13's RECORD
     instance (SsrMarchFn's forward: its outputs = the no-grad instance's
     bit for bit, its hit record = the twin's) and K15, the march's
     backward, on that record and a seeded random cotangent (= its twin
     bit for bit, two launches bit for bit equal), and K15's tile and
     shared memory; K13 and K15 in every form that can take each table
     (ssr_form_holds: post_showcase's, post_ssr_hq's and post_ssr_wide's
     last marches and a 128-bin, 96-step march of the 1080p G-buffer;
     K13 with and without RECORD, K15 on each RECORD's hit record with
     int16 and int32 codes and its offsets in static, opted-in or device
     memory), each = its twin bit for bit and timed, K13's, K15's and
     K14's forms as the wrappers mirror them; the plain XLA scatter of
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
     reproduce the path's image bit for bit; on the mesh scene K1-K4 on
     mesh_full's frame 4 and at the demo grid on mesh_production's frame 2,
     each chain reproducing its path's image bit for bit; the XLA scatter
     of mesh_demo's last frame against the CPU), checks that the terrain
     changes more of K7's elements, and the local terrain more of K1's,
     K6's and K9's, than each hold lets past (ARM_FRACTION tightens K1's
     and K6's), and shows that K7 then K10 gives K5's volume, K8 then
     K10 gives K3's and K5 then K6 give K2's history and scatter planes (with
     the radiance bake, rays and the baked visibility), bit for bit, and
     that K2's, K5's, K6's, K7's, K10's and K11's blocks, K2's, K5's, K10's
     and K11's shared memory (and the general forms' of K2, K5 and K7 at
     5 to 1000 suns), K8's tile, chunk, threads and shared memory,
     K12's tile and shared memory at 1-4 cascades, and K1's and K9's
     launch (blocks, samples and light groups a block, passes of lights,
     shared memory, K1's also past 4 fBm channels) and K13's tile, shared
     memory and unrolled taps are what the wrappers reckon; holds K1 and
     K9 on a scene with 40 local lights (two passes of K1's lights; ten of
     K9's a light group); holds the general forms on many_suns' frame 4
     cut to (suns, fBm channels) (4, 4), (4, 5), (5, 5) and (9, 9)
     (many_suns_holds: K1, K2 in its three local sources, each = K5 then
     K6 bit for bit, K5, K6 in its six modes, K7, K10's weight mode on the
     suns' channels), checking which form each launch took (the fixed
     ones at 4 and 4), and times them at (9, 9); repeats every hold of K2,
     K3 and K5-K12 above in the wide index form (WideHolds: = the narrow
     form bit for bit, and against the same twin at the same tolerance)
     and
     holds the wrappers' index-form mirrors against the launchers' rules
     at their edges (index_form_mirrors); logs each hold's largest
     difference and where it lies, each kernel's largest hold and, for K6,
     the twin's terms at that froxel (ROADMAP C8);
  6. times warm frames of the fused, staged, exact, history, vis_bake,
     map_dir, map, fused_exact, fused_vis, uhd_exact, uhd, demo, XLA
     scatter (and that scatter alone), texture, sunless, media-less and
     many-sun paths (and the texture's plain noise bake and material
     volumes) and,
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
     else;
       train_ssr         train_fog's frame through render_frame_post with
                         ssr_intensity=0.5 under grad, 4 Adam steps of
                         FogParams, each step launching K4, K13's RECORD
                         instance, K15 and K14 once each and nothing else,
                         and no plain march; its first step's gradients
                         against the twins' step, forward, backward and
                         Adam ms and peak memory printed;
       train_ssr_hq      the same at ssr_steps=64, ssr_dirs=16, 2 steps:
                         K13's RECORD GEN instance and K15 each step;
     each path's gradients finite and one non-zero, its last loss
     below its first, its first step's gradients held against the same step
     with K4 and K14 swapped for their twins, its forward, backward and Adam
     ms (CUDA events), the forward without grad, a profiler window of 2
     steps and the peak device memory printed; then
       k14               K14 against composite_grad_plain on seeded random
                         inputs: the per-pixel form at 1280x720 and the cells
                         form at 1280x704 on 160x88x64, and the cells form at
                         1920x1080 on 240x135x128, and the per-pixel form at
                         1280x720 on 160x88x1024 (2 chunks of 512 slices),
                         bit for bit, two launches bit for bit equal, timed
                         beside the twin, the bound and grid_sample's
                         backward; 160x88x64 forced into 2 and 3 chunks =
                         its one launch bit for bit; K14's tile, shared
                         memory and chunk plan
       train_sharded     make_sharded_train_step on a one-rank NCCL group
                         over 2 views (K4 and K14 twice each) = one
                         process's step over their mean loss
       checkpoint        demo_xla's state after its 2 frames saved and loaded
                         (checkpoint.py) renders the next frame bit for bit
       grad_refusals     FULL_CONFIG's frame with its fog requiring grad
                         raises NotImplementedError naming
                         frame_volume_fused, and launches nothing;
       demo_entry        the port's demo (python -m
                         volumetricrenderer_tpu_torch.demo) through its
                         main(argv) in this process: --mesh-env 2 frames,
                         --dump-scene, then --scene on that file 2 frames,
                         its PNGs written and its display checksums equal
                         to the built scene's;
     K14 and K15 launch on no forward path (4., whose counts cover every
     kernel); the host time of a pass range (utils/profiling.scope, and
     the record_function it opens under a profiler) with no profiler
     recording;
  8. the wide index forms of K2, K3 and K5-K12 at their crossings
     (wide_paths), each path from a fresh state with the launch
     counters set to 0 just before and read just after, its index forms,
     peak memory and kernel times printed, the rest of its frame through to
     K4:
       deep_fused        FULL_CONFIG at 16x9x65664 froxels, 128x72, 2
                         frames: K2 past 65,535 slices (two parts of its
                         launch grid), K1, K3 (65,664 slices a block) and
                         K4 narrow, each against its twin on the whole grid
       many_suns_wide    FULL_CONFIG with 520 suns (104 copies of
                         many_suns_scene's 5), 2 frames: K2's histories past
                         2^31 floats; each copy's history = the narrow
                         form's on the 5-sun scene bit for bit, the
                         histories and planes on a band of rows against the
                         twin on the band's tables
       vis_wide          fused_vis with 32,912 local lights (2057 copies of
                         the 16, faded: copy c's intensity halved for each
                         copy after it), 2 frames: K9's and K2's visibility
                         volume past 2^31 floats; K9's volume by copies
                         against the narrow form on the 16, K2's history
                         against the twin, its planes on a band of rows
                         against the twin's per-light loop on the band (and
                         beside the narrow form on the band's tables)
       k3_wide           K3 alone on many_suns_wide's planes resampled:
                         [4, 520, 1024, 1024] planes past 2^31 floats (on a
                         band of rows) and 65,600 rows (two parts; the whole
                         grid's twin), each = the narrow form on a band's
                         tables bit for bit;
       k8_wide           K8 alone on the same [4, 520, 1024, 1024] planes:
                         = the narrow form on a band's tables bit for bit,
                         the twin on the band;
       k10_k11_wide      K10's alpha mode and K11 alone on the same planes
                         (K11 at smooth targets reaching past its window):
                         each = the narrow form on a band's tables bit for
                         bit, the twin on the band;
       deep_staged       STAGED at deep_fused's grid, 2 frames: K5 and K6
                         past 65,535 slices (two parts each), then one
                         no_shadow_blend frame (K7 in two parts), each
                         kernel against its twin on the whole grid
       many_suns_staged_wide  STAGED with the 520 suns, 2 frames: K5's
                         histories past 2^31 floats, K6's general wide form
                         reading them; K5 by copies against the narrow form
                         on the 5-sun scene, K5 and K6 on a band against the
                         twin; K7 once on the same tables (by copies and on
                         the band)
       vis_bake_wide     VIS_BAKE with 32,912 local lights (2057 equal
                         copies, unfaded), 2 frames: K9's and K6's baked
                         wide forms; K9 by copies, K6 = the narrow form on a
                         band's tables bit for bit, K2's wide form once on
                         the same tables (= K5 then K6 bit for bit), and
                         ROADMAP C12's hold (c12_hold): K6's and K2's
                         planes and the fp32 twin against an fp64 reference
                         within the gamma_(n-1) bound of the sum's n terms;
       deep_history      HISTORY at deep_fused's grid, 2 frames: K11 (both
                         blends) and K10 (alpha) past 65,535 slices (two
                         parts each), K5 and K6 wide, K9 and K4 narrow,
                         each kernel against its twin on the whole grid
       deep_map_full_rate  MAP_DIR at full rate at the same grid, 2
                         frames: K12 on one sun's 65,664 slices and K10's
                         weight mode wide (two parts each), K6 wide, each
                         against its twin on the whole grid
       many_suns_map_wide  MAP_DIR at full rate with the 520 suns (the 5
                         suns' maps baked once and repeated; = a bake of 2
                         copies bit for bit), 2 frames: K12 on 66,560
                         (sun, slice) pairs and [520, 128, 135, 240]
                         volumes past 2^31 floats, K10's weight mode in 130
                         narrow groups, K6's general wide form; K12 by
                         copies against the narrow form on the 5 suns and
                         on a band against the twin, K10's copies equal and
                         its 5 suns against the twin, K6 on the band;
     the wide forms' rows (also forced at 240x135x128 beside the narrow
     forms, in turns) join the kernels line;
  9. the forms past a block's shared memory (shared_edge_paths): the
     mirrors ops/scatter.sun_form, ops/frame_fused.k1_plan and
     check_k3_window against the launchers' own rules at their edges (K3
     refused at k = 159, where its bytes pass the card's limit, and held
     against its twin at 158 on many_suns' frame 4); K2 (radiance,
     rays, baked), K5 and K7 forced into gen_global (the suns' inverse
     directions in device memory) in both index forms and K1 forced into
     its chunked form on many_suns' frame 4 at 240x135x128, each = the
     general form bit for bit, timed in turns against it; then, each path
     from a fresh state through to K4, its per-form launches counted:
       many_suns_shared  FULL_CONFIG with 19,460 suns (3,892 copies of
                         many_suns_scene's 5), 2 frames, at 80x45x32 (1080p:
                         [19460, 32, 45, 80] histories past 2^31 floats, K2
                         gen_global wide) and 40x24x16 (160x90: gen_global
                         narrow); then STAGED (K5 gen_global) 2 frames and
                         no_shadow_blend (K7 gen_global) 1 frame on each
                         grid; each copy's history = the first copy's, the
                         first copy = the general form's on the 5-sun scene
                         bit for bit and the twin's on the whole grid, K2's
                         planes = K5 then K6 bit for bit
       many_noise_shared FULL_CONFIG with 16 lights and 432 procedural
                         noise media, 2 frames: K1 chunked (425 channels
                         staged, 7 whole), its channels = the general form
                         on the 425-media prefix and on the base medium
                         with the last 7 bit for bit, and the twin; K2's
                         general form reads the 432 channels (= K5 then K6
                         bit for bit);
     their rows join the kernels line;
  10. the region forms past a block's shared memory (region_edge_paths):
     the mirrors ops/temporal.region_form (K2, K5, K10) and
     ops/frame_fused.k3_window_form (K3) against the launchers' own rules
     around their edges (k = 52 and 159), and K11 refusing k = 108 by name;
     K2 (radiance, rays, baked), K5, K10 (weight, alpha) forced into their
     region_global form (the reprojection offsets in device memory) at
     k = 4 and 51, K3 at 4 and 158, on the fused path's frame 4 at
     240x135x128, and K2 and K5 on demo_scene's (the terrain), each = the
     region_shared form bit for bit, held against its twin and timed in
     turns against the region_shared form; then,
     each path from a fresh state through to K4, its launches counted by
     region form:
       fused_k52         FULL_CONFIG at reproj_window 52, 2 frames: K2
                         region_global (= K5 then K6 bit for bit), K3
                         region_shared, each against its twin
       fused_k159        the same at 159: K2 and K3 region_global
       staged_k52        STAGED at 52, 2 frames: K5 region_global
       map_dir_k52       MAP_DIR at 52, 2 frames: K10's weight mode
                         region_global
       history_k107      HISTORY at 107, 2 frames: K5 and K10's alpha mode
                         region_global, K11 at its widest window
     their rows join the kernels line;
  11. prints the `kernels` JSON line, then the result line.

Every failure raises: the script exits 0 only if every phase passed.
Imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

# bytes/s of HBM and fp32 (non-tensor-core) FLOP/s of an H100 SXM at its
# full 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# a block's shared memory on the H100, the opt-in limit
# (ops/temporal.MAX_SHARED_BYTES)
MAX_SHARED_BYTES = 232448

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
    "composite_grad": (0.0, 0.0, 0.0,
                       "a gather: the same terms in the same order, no "
                       "atomics"),
    "ssr_march_grad": (0.0, 0.0, 0.0,
                       "a gather: the same terms in the same order, no "
                       "atomics"),
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
    # no TPU kernel: the JAX package differentiates its XLA SSR march
    "ssr_march_grad": "none; the adjoint of JAX's XLA SSR march "
                      "(volumetricrenderer_tpu/post.py:599-638), K13's "
                      "backward",
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
# SSR tables past the fixed K13 instances (ssr_steps, ssr_dirs): 39 taps
# a bin, 10,048 B (GEN, static shared memory); 54 taps, 55,552 B (GEN, the
# table in device memory); and K15's 55,808 B at 128 bins of 54 taps (opted
# in)
SSR_HQ = dict(ssr_steps=64, ssr_dirs=16)
SSR_WIDE = dict(ssr_steps=96, ssr_dirs=64)
SSR_128 = dict(ssr_steps=96, ssr_dirs=128)
POST_PATHS = {
    "post_bench": (BENCH_POST, 4, FUSED_KERNELS),
    "post_showcase": (SHOWCASE_POST, 4, FUSED_KERNELS + ("ssr_march",)),
    "post_rest": (REST_POST, 2, FUSED_KERNELS),
    "post_ssr_hq": (dict(SHOWCASE_POST, **SSR_HQ), 2,
                    FUSED_KERNELS + ("ssr_march",)),
    "post_ssr_wide": (dict(SHOWCASE_POST, **SSR_WIDE), 1,
                      FUSED_KERNELS + ("ssr_march",)),
}
# the post paths that render through render_frame_post
FRAME_POST_PATHS = ("post_bench", "post_ssr_hq", "post_ssr_wide")

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
    # demo_scene(mesh_env=True): the tree meshes rasterized into the
    # G-buffer, their 20 voxelized proxy boxes (opacity below 1) in every
    # shadow ray: 23 boxes in the kernels' any-hit loops
    "mesh_full": ("mesh", {}, 4, FUSED_KERNELS),
    "mesh_production": ("mesh", PRODUCTION, 2, FUSED_KERNELS),
    "mesh_demo": ("mesh", DEMO_XLA, 2, ("composite",)),
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
    # benchmark_scene with 9 suns and 9 procedural noise media
    # (many_suns_scene): past the fixed forms' 4 suns and 4 fBm channels,
    # K1, K2, K5, K6 and K7 launch their general forms (check_forms), K12
    # takes the 9 suns in one launch and K10 blends their 9 shadow
    # channels in 3 launches of up to 4
    "many_suns": ("many", {}, 4, FUSED_KERNELS),
    "many_suns_staged": ("many", STAGED, 2, STAGED_KERNELS),
    "many_suns_no_shadow_blend": ("many", dict(STAGED,
                                               temporal_blend_shadow=False),
                                  1, NO_SHADOW_BLEND_KERNELS),
    "many_suns_map_dir": ("many", MAP_DIR, 2, (
        "pcf_shadow", ("temporal_blend", 3), "bake_radiance", "scatter",
        "integrate_blend", "composite")),
}
MANY_PATHS = ("many_suns", "many_suns_staged", "many_suns_no_shadow_blend",
              "many_suns_map_dir")
# the paths of the plain XLA scatter, whose last frame's scatter is held
# against the same function on the CPU
XLA_SCATTER_PATHS = ("xla_scatter", "demo_xla", "demo_noise",
                     "mesh_demo")
PATHS.update({name: v[1:] for name, v in DEMO_PATHS.items()})
PATHS.update({name: v[1:] for name, v in SCENE_PATHS.items()})
# (kernel, mode) of the terrain and fractional arms, of the demo grid
# (160x88x64, its low grid 80x44x32 at ss=2) and of K4's per-pixel form ->
# the paths that launch it in that mode
ARM_PATHS = {
    ("bake_radiance", "terrain_local"): ("demo_hf_local",),
    ("bake_radiance", "demo_grid"): ("demo_production", "anyres_xla",
                                     "mesh_production"),
    ("bake_radiance", "fractional"): ("fractional",
                                      "fractional_no_shadow_blend"),
    ("bake_radiance", "mesh"): ("mesh_full",),
    ("shadow_scatter", "terrain"): ("demo_full", "demo_hf_local"),
    ("shadow_scatter", "demo_grid"): ("demo_production", "anyres_xla",
                                      "mesh_production"),
    ("shadow_scatter", "fractional"): ("fractional",),
    ("shadow_scatter", "mesh"): ("mesh_full",),
    ("integrate_blend", "demo_grid"): ("demo_production", "anyres_xla",
                                       "mesh_production"),
    ("shadow_blend", "terrain"): ("demo_exact_hf",),
    ("scatter", "rays_terrain"): ("demo_exact_hf",),
    ("dir_shadow", "terrain"): ("demo_no_shadow_blend",
                                "fractional_no_shadow_blend"),
    ("bake_visibility", "terrain_local"): ("demo_vis_hf",),
    ("composite", "pixels_720p"): ("demo_production", "anyres_xla",
                                   "demo_xla", "demo_noise",
                                   "mesh_production", "mesh_demo"),
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


# The raster phase: the share of the 720p mesh G-buffer's pixels that may
# differ between the card and the CPU past ROADMAP C3's class, and why
RASTER_PAST = 5e-3
RASTER_WHY = ("last-ulp differences of the ray directions turn into other "
              "hits at grazing terrain samples and primitive edges (ROADMAP "
              "C3, C7)")


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
# The slab forms that the JAX package renders and the port refuses no more:
# slab3_map_dir (map_dir at FULL_CONFIG: K12 with the slab's y0, K10, K1,
# K6, K3, K4; every shard bakes its maps in its frame), slab3_xla (the XLA
# sun shadow and scatter and the plain scan, K10 blending shadow and
# accumulation, K4; raycast_shadow_subsample=1, as at ss > 1 the XLA
# scatter's rays subsample the slab's own rows, JAX pipeline.py:302, and so
# are other rays than the whole grid's) and slab3_tex (bench.py's texture
# frame: the plain noise bake at each slab's low grid, K1 K2 K3 K4); each
# held against the whole grid's frame (SLAB_EDGE).
SLAB_XLA = dict(scatter_impl="xla", dir_shadow_impl="xla",
                raycast_shadow_subsample=1)
SLAB_PATHS = {
    "slab3": ({}, 3, 4, FUSED_KERNELS),
    "slab5": ({}, 5, 4, FUSED_KERNELS),
    "slab3_staged": (SLAB_STAGED, 3, 2, ("shadow_blend", "scatter",
                                         "integrate_blend", "composite")),
    "slab3_map_dir": (MAP_DIR, 3, 2, MAP_DIR_KERNELS),
    "slab3_xla": (SLAB_XLA, 3, 2, (("temporal_blend", 2), "composite")),
    "slab3_tex": ({}, 3, 2, FUSED_KERNELS),
}
# slab path -> its scene in main()'s scenes (else benchmark_scene)
SLAB_SCENES = {"slab3_tex": "tex"}
# The new slab paths' hold against the whole grid's frame: rtol 1e-4 /
# atol 1e-5 per element (tests/test_shard_render.py's class for sharded
# against single device) on every image row whose composite reads only
# froxel rows [SLAB_EDGE, H - 1 - SLAB_EDGE]; the rows nearer the global
# top and bottom edges at the slab paths' class (relative to the image
# maximum, under 0.02), since there a slab's low-rate bake tent clamps
# against its own halo rows and its computed halo rows past the grid stand
# in for the whole grid's repeated edge row (the JAX package's slab
# semantics)
SLAB_EDGE = 2
# shardmap3: make_shardmap_render on 3 ranks spawned on the card, slab3's
# configuration and frames, each rank's band and cropped state held bit
# for bit against slab3's shard; frames timed after the held ones
SHARDMAP_RANKS = 3
SHARDMAP_TIMED = 10
SHARDMAP_JOIN_S = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes, nops):
    """The least time of a kernel's work, ms, and what sets it: its bytes
    (each input read once, each output written once) at the HBM rate or its
    operations at the fp32 rate."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * nops / FP32_FLOPS
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


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
    WIDE.check(name, got, want, mode, label)
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
    # the pass ranges' GPU annotations span kernels: not device work
    from volumetricrenderer_tpu_torch.utils.profiling import PASS_NAMES
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in PASS_NAMES]
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
    last, counts, {y phase: counts of the shards of that phase}, every
    frame's bands)."""
    _, n_sh, n_frames, expect = SLAB_PATHS[name]
    expect = dict(k if isinstance(k, tuple) else (k, 1) for k in expect)
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
            if v != expect.get(k, 0):
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
        bands, all_bands = None, []
        for i in range(n_frames):
            bands, carry = fn(carry, scenes[i], 0.1 * i)
            carries.append(carry)
            all_bands.append(bands)
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
        if launches[k] != n_frames * n_sh * expect.get(k, 0) or launches[k] \
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
    return img, bands, carries, launches, by_phase, all_bands


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
    if name in FRAME_POST_PATHS:
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
    flat, and that each K13 launch took the form its table takes
    (ops/ssr.k13_form). Returns (last display image, the states, counts)."""
    from volumetricrenderer_tpu_torch.ops import ssr as ssr_ops
    kw, n_frames, expect = POST_PATHS[name]
    cfg = post.PostConfig(**kw)
    state = renderer.init_state(scene.dir_lights.count)
    carry = torch.ones((), device="cuda") if name == "post_showcase" \
        else None
    torch.cuda.synchronize()
    forms_before = cuda.form_counts("ssr_march")
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
    forms = {f: n - forms_before[f]
             for f, n in cuda.form_counts("ssr_march").items()
             if n != forms_before[f]}
    offsets = post._ssr_offsets(cfg)
    want = {ssr_ops.k13_form(len(offsets), max(len(b) for b in offsets)):
            n_frames} if "ssr_march" in expect else {}
    log(f"# {name}: K13's launches by form {json.dumps(forms)}")
    if forms != want:
        raise AssertionError(f"path {name}: K13 launched in the forms "
                             f"{forms}, not {want}")
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


def march_work(args, hit_k, record=False):
    """K13's bytes and operations on a march's inputs (dq, colours, invz0,
    g, bins, valid, offsets, ...) and its hit record hit_k: 8 planes in and
    5 out (and the int32 hit record with RECORD); per valid pixel the taps
    of its own bin up to its first hit (hit_k + 1; every later tap adds
    +-0), all of them where it finds none, ~28 operations each (two 1/z
    lines and divides, the crossing and onscreen tests, the first-hit
    weight and five accumulators)."""
    hq, wq = args[0].shape
    offsets = args[6]
    counts = torch.tensor([len(b) for b in offsets], device=args[0].device)
    walked = torch.where(hit_k >= 0, hit_k + 1,
                         counts[args[4].long().clamp(0, len(offsets) - 1)])
    taps = int((walked * args[5]).sum())
    return 4 * (14 if record else 13) * hq * wq, 28 * taps


def k15_work(hq, wq, hit_k):
    """K15's: the three cotangents, the bins and the hit record in, three
    gradients out; per pixel with a hit, its source's index and three adds
    (the function's work: the kernel's tap tests find those pixels)."""
    return 4 * 8 * hq * wq, 8 * int((hit_k >= 0).sum())


def forms_that_fit(form_of, n_bins, max_taps, forms):
    """The forms of `forms` that can take a table of n_bins x max_taps rows
    (form_of: ops/ssr.k13_form or k15_form, which refuses the others)."""
    out = []
    for f in forms:
        try:
            out.append(form_of(n_bins, max_taps, f))
        except ValueError:
            pass
    return out


# The rows of K13's and K15's forms in the kernels line: (kernel, mode)
# -> (the march it runs on, the form, the paths that launch it in that
# form); the marches are the last frames' of post_ssr_hq and post_ssr_wide
# and a 128-bin, 96-step one on the 1080p G-buffer (ssr_128)
SSR_FORM_ROWS = {
    ("ssr_march", "gen_39_taps"): ("post_ssr_hq", "gen", ("post_ssr_hq",)),
    ("ssr_march", "gen_global_54_taps"): ("post_ssr_wide", "gen_global",
                                          ("post_ssr_wide",)),
    ("ssr_march", "gen_global_39_taps"): ("post_ssr_hq", "gen_global", ()),
    ("ssr_march", "record_gen_39_taps"): ("post_ssr_hq", "record_gen",
                                          ("train_ssr_hq",)),
    ("ssr_march_grad", "fixed_39_taps"): ("post_ssr_hq", "fixed",
                                          ("train_ssr_hq",)),
    ("ssr_march_grad", "optin_128_bins"): ("ssr_128", "optin", ()),
    ("ssr_march_grad", "global_wide_39_taps"): ("post_ssr_hq",
                                                "global_wide", ()),
    ("ssr_march_grad", "global_39_taps"): ("post_ssr_hq", "global", ()),
}


def ssr_form_holds(ssr_ops, post, march_by, scene_color, view_depth):
    """K13 and K15 in every form that can take each table, on real marches:
    post_showcase's (8 bins of <= 12 taps: the fixed instances), post_ssr_
    hq's (16 of <= 39: GEN), post_ssr_wide's (64 of <= 54: GEN, the table
    in device memory) and ssr_128 (the 1080p G-buffer marched with 128
    bins of <= 54 taps, K15's table opted in). Each K13 form without and with RECORD, each K15
    form on that RECORD's hit record and a seeded cotangent, is its twin
    bit for bit (and so every other form there), and is timed beside its
    twin and bound. Returns ({(kernel, mode): row} of SSR_FORM_ROWS,
    less the launches; max abs errors {kernel: largest})."""
    marches = {k: march_by[k] for k in ("post_showcase", "post_ssr_hq",
                                        "post_ssr_wide")}
    recorded, real = [], ssr_ops.ssr_march

    def recording(*args, **kw):
        recorded.append(args)
        return real(*args, **kw)

    ssr_ops.ssr_march = recording
    try:
        with torch.no_grad():
            post._ssr_p([scene_color[..., c] for c in range(3)], view_depth,
                        post.PostConfig(ssr_intensity=0.5, **SSR_128))
    finally:
        ssr_ops.ssr_march = real
    marches["ssr_128"] = recorded[-1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(29)
    timed, errs = {}, {"ssr_march": 0.0, "ssr_march_grad": 0.0}
    # the twins are timed on the marches of a row only
    rowed = {(k, label) for (k, _), (label, _, _) in SSR_FORM_ROWS.items()}
    twin_ms = lambda k, label, fn: cuda_time_ms(fn, 1) \
        if (k, label) in rowed else None
    for label, args in marches.items():
        offsets = args[6]
        n_bins, max_taps = len(offsets), max(len(b) for b in offsets)
        hq, wq = args[0].shape
        twin = ssr_ops.ssr_march_reference(*args, record=True)
        twin5 = torch.stack(twin[:5])
        k13_forms = forms_that_fit(ssr_ops.k13_form, n_bins, max_taps,
                                   ssr_ops.K13_FORMS)
        hit_share = float(twin5[3].mean())
        log(f"# ssr_form_holds, {label}: {hq}x{wq} planes, {n_bins} bins of "
            f"<= {max_taps} taps ({ssr_ops.k13_shared_bytes(n_bins, max_taps)}"
            f" B of K13 table, {ssr_ops.k15_shared_bytes(n_bins, max_taps)} "
            f"B of K15's), hit share {hit_share:.4f}; K13 forms {k13_forms} "
            f"(size rule {ssr_ops.k13_form(n_bins, max_taps)})")
        if not 0.0 < hit_share < 1.0:
            raise AssertionError(f"{label}: the SSR march finds no hits")
        plain = twin_ms("ssr_march", label,
                        lambda: ssr_ops.ssr_march_reference(*args))
        plain_rec = twin_ms("ssr_march", label,
                            lambda: ssr_ops.ssr_march_reference(
                                *args, record=True))
        for f in k13_forms:
            for record in (False, True):
                out = ssr_ops.ssr_march(*args, record=record, form=f)
                err = compare("ssr_march", torch.stack(out[:5]), twin5,
                              label=f"{label}, {'record_' * record}{f}")
                same = torch.equal(torch.stack(out[:5]), twin5) and (
                    not record or torch.equal(out[5], twin[5]))
                if not same:
                    raise AssertionError(f"K13 {f} (record {record}) on "
                                         f"{label} differs from its twin")
                errs["ssr_march"] = max(errs["ssr_march"], err)
                ms = kernel_time_ms(lambda f=f, r=record: ssr_ops.ssr_march(
                    *args, record=r, form=f), 20)
                mode = f"record_{f}" if record else f
                timed[("ssr_march", label, mode)] = dict(
                    max_abs_err=err, ms=ms,
                    plain_ms=plain_rec if record else plain,
                    work=march_work(args, twin[5], record))
                log(f"# ssr_march {mode} on {label}: {ms:.4f} ms/launch, "
                    f"= its twin bit for bit (hit record too)")
        hit_k = twin[5]
        cots = [torch.randn((hq, wq), generator=gen, device="cuda")
                for _ in range(3)]
        g_args = (cots, args[4], hit_k, offsets, args[8])
        g_twin = torch.stack(ssr_ops.ssr_march_grad_plain(*g_args[:4]))
        g_plain = twin_ms("ssr_march_grad", label,
                          lambda: ssr_ops.ssr_march_grad_plain(*g_args[:4]))
        k15_forms = forms_that_fit(ssr_ops.k15_form, n_bins, max_taps,
                                   ssr_ops.K15_FORMS)
        log(f"# ssr_form_holds, {label}: K15 forms {k15_forms} (size rule "
            f"{ssr_ops.k15_form(n_bins, max_taps)}), share of source pixels "
            f"fed {float((g_twin != 0).float().mean()):.4f}")
        for f in k15_forms:
            got = torch.stack(ssr_ops.ssr_march_grad(*g_args, form=f))
            err = compare("ssr_march_grad", got, g_twin, label=f"{label}, {f}")
            if not torch.equal(got, g_twin):
                raise AssertionError(f"K15 {f} on {label} differs from its "
                                     "twin")
            errs["ssr_march_grad"] = max(errs["ssr_march_grad"], err)
            ms = kernel_time_ms(lambda f=f: ssr_ops.ssr_march_grad(
                *g_args, form=f), 20)
            timed[("ssr_march_grad", label, f)] = dict(
                max_abs_err=err, ms=ms, plain_ms=g_plain,
                work=k15_work(hq, wq, hit_k))
            log(f"# ssr_march_grad {f} on {label}: {ms:.4f} ms/launch, = "
                "its twin bit for bit")
    rows = {}
    for (k, m), (label, f, _) in SSR_FORM_ROWS.items():
        row = dict(timed[(k, label, f)])
        b_ms, b_by = bound(*row.pop("work"))
        rows[(k, m)] = dict(row, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None, march=label)
    return rows, errs



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


def many_suns_scene(scene, n_suns: int, n_noise: int):
    """benchmark_scene `scene` with its sun and n_suns - 1 more, of distinct
    directions, colours and intensities (every third unshadowed, some of
    partial strength), and its media with n_noise - 1 additive procedural
    noise media after them, of distinct seeds (8, 9, ...), absorptions,
    scrolls and octaves (2 to 5: K1 bakes a channel of more than 4 octaves
    as one item), each of phase g 0: additive media add their g, and the
    sum must stay below 1 for the HG term to stay positive;
    tests/test_torch_many_suns.py builds the same scene for the JAX
    package. A scene of fewer suns or media is a prefix of one of more."""
    from volumetricrenderer_tpu_torch.models.lights import DirectionalLights
    from volumetricrenderer_tpu_torch.models.media import Medium

    def forward(pitch_deg, yaw_deg):
        p, y = math.radians(pitch_deg), math.radians(yaw_deg)
        return (math.cos(p) * math.sin(y), -math.sin(p),
                math.cos(p) * math.cos(y))

    dev = scene.camera.position.device
    sun = scene.dir_lights
    extra = DirectionalLights.create(
        direction=[forward(50.0 - 4.0 * i, -30.0 + 37.0 * i)
                   for i in range(1, n_suns)],
        color=[(0.9, 0.8 + 0.02 * i, 0.7) for i in range(1, n_suns)],
        intensity=[1.5 / (1.0 + 0.3 * i) for i in range(1, n_suns)],
        has_shadow=[i % 3 != 2 for i in range(1, n_suns)],
        shadow_strength=[1.0 - 0.1 * (i % 4) for i in range(1, n_suns)],
        device=dev)
    suns = dataclasses.replace(sun, **{
        f.name: torch.cat([getattr(sun, f.name), getattr(extra, f.name)])
        for f in dataclasses.fields(sun)})
    media = tuple(scene.media) + tuple(
        Medium.create(scattering_color=(0.2, 0.25, 0.3),
                      absorption=0.05 + 0.02 * j, phase_g=0.0,
                      noise_mode="procedural",
                      noise_scroll=(2.0 * j, 0.0, 1.0),
                      noise_tiling=(0.02, 0.015, 0.02),
                      noise_octaves=2 + j % 4, noise_period=4,
                      noise_seed=7 + j, blend_type="additive", device=dev)
        for j in range(1, n_noise))
    return dataclasses.replace(scene, dir_lights=suns, media=media)


def form_deltas(cuda, before) -> dict:
    """source -> launches of each of cuda.FORM_SOURCES' forms (fixed,
    general, then gen_global or chunked: cuda.FORM_NAMES) since `before`
    (their counts then)."""
    return {src: tuple(a - b for a, b in zip(cuda.form_launches(src),
                                             before[src]))
            for src in cuda.FORM_SOURCES}


def check_forms(name: str, before, launches, cuda) -> None:
    """Path `name` launched the general forms of K1, K2, K5, K6 and K7
    exactly where its scene has more suns or fBm channels than the fixed
    forms keep (MANY_PATHS, 9 of each) and the fixed forms on every other
    path: each source's launches split as (0, all) or (all, 0)."""
    deltas = form_deltas(cuda, before)
    for src, got in deltas.items():
        n = launches[src]
        want = ((0, n) if name in MANY_PATHS else (n, 0)) \
            + (0,) * (len(got) - 2)
        if got != want:
            raise AssertionError(f"path {name}: {src} launched (fixed, "
                                 f"general) forms {got}, not {want}")
    if name in MANY_PATHS:
        log(f"# {name}: (fixed, general) launches "
            f"{json.dumps({k: v for k, v in deltas.items() if any(v)})}")


# (suns, fBm channels) of the general forms' holds on many_suns' frame 4:
# (4, 4) the fixed forms everywhere; (4, 5) K1's general form and K2's and
# K6's for the fBm channels alone (their per-light modes have none: fixed),
# K5 and K7 fixed; (5, 5) and (9, 9) every general form. Timed at (9, 9).
MANY_COUNTS = ((4, 4), (4, 5), (5, 5), (9, 9))
# (kernel, mode) of a general form at (9, 9) -> the paths that launch it
GENERAL_PATHS = {
    ("bake_radiance", "general"): MANY_PATHS,
    ("shadow_scatter", "general_radiance"): ("many_suns",),
    ("shadow_scatter", "general_rays"): (),
    ("shadow_scatter", "general_baked"): (),
    ("shadow_blend", "general"): ("many_suns_staged",),
    ("dir_shadow", "general"): ("many_suns_no_shadow_blend",),
    ("scatter", "general_radiance_fused"): (
        "many_suns_staged", "many_suns_no_shadow_blend",
        "many_suns_map_dir"),
    ("scatter", "general_radiance_planes"): (),
    ("scatter", "general_rays_fused"): (),
    ("scatter", "general_rays_planes"): (),
    ("scatter", "general_baked_fused"): (),
    ("scatter", "general_baked_planes"): (),
    ("temporal_blend", "general_weight"): ("many_suns_map_dir",),
}


def many_suns_holds(renderers, runs, scene, cuda):
    """The general forms against their twins on the inputs of many_suns'
    frame 4 at each of MANY_COUNTS (the scene cut to that many suns and
    noise media, the history to that many channels): K1; K2 with the
    radiance bake, rays (fused_exact's tables) and K9's visibility
    (fused_vis's), each = K5 then K6 bit for bit; K5; K6 in its six modes
    (the three local sources x fused material or material volumes); K7;
    K10's weight mode on the suns' channels (the history against K7's
    volume). Checks at each count which form each launch took, and times
    the general forms at (9, 9) beside their twins on the card and their
    bounds (reckoned as main() reckons the fixed forms'). Returns
    ({kernel: largest difference}, {(kernel, mode): row})."""
    from volumetricrenderer_tpu_torch import pipeline
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import material as mtl
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    prev = runs["many_suns"][1][3]
    errs, calls, key_errs = {}, {}, {}
    worst = (-1.0,)  # K6's largest difference: (err, label, got, want, args)

    def hold(name, got, want, label, mode="general"):
        err = compare(name, got, want, label=label)
        errs[name] = max(errs.get(name, 0.0), err)
        if nd > 4:  # the general forms' own holds (every one at 5 and 9)
            key_errs[(name, mode)] = max(key_errs.get((name, mode), 0.0),
                                         err)

    for nd, nn in MANY_COUNTS:
        sc_c = many_suns_scene(scene, nd, nn)
        tag = f"{nd} suns, {nn} fBm channels"
        prev_sh = prev.prev_shadow[:nd].float().contiguous()
        r_f = renderers["many_suns"]
        t, params, w2v = r_f.frame_tables(prev, sc_c, 0.3)
        xt, _, _ = renderers["fused_exact"].frame_tables(prev, sc_c, 0.3)
        vt, _, _ = renderers["fused_vis"].frame_tables(prev, sc_c, 0.3)
        if (t.n_dir, t.n_noise, xt.n_noise, vt.n_noise) != (nd, nn, 0, 0):
            raise AssertionError(f"the {tag} tables: {t.n_dir} suns, "
                                 f"{t.n_noise} fBm channels")
        geo, scene_dev = r_f.frame_geometry(prev, sc_c, t, params, w2v)
        mat = tuple(v.contiguous() for v in pipeline.write_material_volumes(
            r_f.config, params, geo.view_to_world, geo.jitter, 0.3,
            scene_dev.media))
        torch.cuda.synchronize()
        before = {src: cuda.form_launches(src) for src in cuda.FORM_SOURCES}
        bake = ff.bake_radiance(t)
        hold("bake_radiance", bake, ff.bake_radiance_plain(t), tag)
        sources = {"radiance": (t, bake, None), "rays": (xt, None, None),
                   "baked": (vt, None, vis.bake_visibility(vt))}
        blended = {}
        for mode, (tm, b, v) in sources.items():
            got = ff.shadow_scatter(tm, prev_sh, b, v)
            want = ff.shadow_scatter_plain(tm, prev_sh, b, v)
            for g, w_, part in zip(got, want, ("history", "planes")):
                hold("shadow_scatter", g, w_, f"{mode}, {part}, {tag}",
                     f"general_{mode}")
            blended[mode] = sb.dir_shadow_blend(tm, prev_sh)
            same = torch.equal(got[0], blended[mode]) and torch.equal(
                got[1], sca.scatter_local(tm, blended[mode], b, v))
            log(f"# shadow_scatter, {mode}, {tag}: = shadow_blend then "
                f"scatter bit for bit: {same}")
            if not same:
                raise AssertionError(f"K2 ({mode}, {tag}) differs from K5 "
                                     "then K6")
            calls[("shadow_scatter", f"general_{mode}")] = (
                lambda a=(tm, prev_sh, b, v): ff.shadow_scatter(*a),
                lambda a=(tm, prev_sh, b, v): ff.shadow_scatter_plain(*a))
        hold("shadow_blend", blended["radiance"],
             sb.dir_shadow_blend_plain(t, prev_sh), tag)
        for mode, (tm, b, v) in sources.items():
            for form, m in (("fused", None), ("planes", mat)):
                b_ = None if b is None else (b if m is None
                                             else b[:3].contiguous())
                a = (tm, blended[mode], b_, v, m)
                got, want = sca.scatter_local(*a), sca.scatter_local_plain(*a)
                label = f"{mode} x {form}, {tag}"
                hold("scatter", got, want, label, f"general_{mode}_{form}")
                err = float((got - want).abs().max())
                if err > worst[0]:
                    worst = (err, label, got, want, a)
                del got, want
                calls[("scatter", f"general_{mode}_{form}")] = (
                    lambda a=a: sca.scatter_local(*a),
                    lambda a=a: sca.scatter_local_plain(*a))
        unblended = ds.dir_shadow(t)
        hold("dir_shadow", unblended, ds.dir_shadow_plain(t), tag)
        wa = (t.sbpar, prev_sh, unblended, t.grid_whd, t.h_glob, t.k,
              "weight")
        hold("temporal_blend", tmp.temporal_blend(*wa),
             tmp.temporal_blend_plain(*wa), f"weight, {nd} channels",
             "general_weight")
        torch.cuda.synchronize()
        deltas = form_deltas(cuda, before)
        log(f"# general forms, {tag}: (fixed, general) launches "
            f"{json.dumps(deltas)}")
        for src, (fixed, gen, *past) in deltas.items():
            suns_only = src in ("shadow_blend", "dir_shadow")
            if any(past):  # gen_global or chunked: not at these counts
                ok = False
            elif nd > 4:
                ok = fixed == 0 and gen > 0
            elif nn > 4 and not suns_only:
                # K1 has no per-light mode; K2's and K6's have no fBm
                # channels and keep the fixed form
                ok = gen > 0 and (fixed == 0) == (src == "bake_radiance")
            else:
                ok = gen == 0 and fixed > 0
            if not ok:
                raise AssertionError(f"{tag}: {src} took (fixed, general, "
                                     f"past) forms {(fixed, gen, *past)}")
    # an account of K6's largest difference: the twin's terms there and
    # the nearest flip of one light's shadow ray (ROADMAP C8's class)
    err, label, got, want, a = worst
    diff = (got - want).abs()
    at = tuple(int(i) for i in torch.unravel_index(diff.argmax(),
                                                   diff.shape))
    atol, rtol = CHECKS["scatter"][:2]
    frac = float((diff > atol + rtol * want.abs()).float().mean())
    log(scatter_terms(sca, vis, mtl, a, (err, label, at, frac,
                                         float(got[at]) - float(want[at])))
        + " (the general forms' holds; ROADMAP C8's any-hit flip class)")
    del worst, got, want, diff
    # time the general forms at (9, 9): the last count's inputs
    calls[("bake_radiance", "general")] = (
        lambda: ff.bake_radiance(t), lambda: ff.bake_radiance_plain(t))
    calls[("shadow_blend", "general")] = (
        lambda: sb.dir_shadow_blend(t, prev_sh),
        lambda: sb.dir_shadow_blend_plain(t, prev_sh))
    calls[("dir_shadow", "general")] = (lambda: ds.dir_shadow(t),
                                        lambda: ds.dir_shadow_plain(t))
    calls[("temporal_blend", "general_weight")] = (
        lambda: tmp.temporal_blend(*wa), lambda: tmp.temporal_blend_plain(*wa))
    # the work of each, counted as main() counts the fixed forms' (the
    # noise media's Perlin by their octaves, 320 operations each)
    w, h, d = t.grid_whd
    n_fro = w * h * d
    wl, hl, dl = t.low_dims
    n_low = wl * hl * dl
    n_lights = t.lights.shape[0]
    n_media = len(sc_c.media)
    perlin = sum(8 * 40 * st[1] for st in t.media_static if st[0])
    ops_ray = 14 * t.n_planes + 22 * t.n_spheres + 30 * t.n_boxes
    warp = lambda channels: 24 + 12 * channels
    ops_reproj = 45
    ops_shadow = ops_reproj + warp(nd) + nd * (30 + ops_ray)
    sun = 40 * nd + 40
    ops_scatter = (3 + nn) * 20 + 60 * n_media + sun
    material = 60 * n_media + perlin
    pairs = {"rays": int(xt.count.sum()) * h * w,
             "baked": int(vt.count.sum()) * h * w}
    per_pair = {"rays": 60 + ops_ray, "baked": 60 + 20}
    low_in = {"rays": 0, "baked": 4 * n_lights * n_low}
    work = {
        ("bake_radiance", "general"): (
            4 * (3 + nn) * n_low,
            n_low * (60 + perlin)
            + int(t.active.sum()) * hl * wl * (60 + ops_ray)),
        ("shadow_scatter", "general_radiance"): (
            4 * (2 * nd * n_fro + (3 + nn) * n_low + 4 * n_fro),
            n_fro * (ops_shadow + ops_scatter)),
        ("shadow_blend", "general"): (4 * 2 * nd * n_fro,
                                      n_fro * ops_shadow),
        ("dir_shadow", "general"): (4 * nd * n_fro,
                                    n_fro * nd * (30 + ops_ray)),
        ("scatter", "general_radiance_fused"): (
            4 * (nd * n_fro + (3 + nn) * n_low + 4 * n_fro),
            n_fro * ops_scatter),
        ("scatter", "general_radiance_planes"): (
            4 * (nd * n_fro + 3 * n_low + 4 * n_fro + 3 * n_fro),
            n_fro * (3 * 20 + sun)),
        ("temporal_blend", "general_weight"): (
            4 * 3 * nd * n_fro, n_fro * (ops_reproj + warp(nd) + 3 * nd)),
    }
    for m in ("rays", "baked"):
        work[("shadow_scatter", f"general_{m}")] = (
            4 * (2 * nd * n_fro + 4 * n_fro) + low_in[m],
            n_fro * (ops_shadow + material + sun)
            + pairs[m] * per_pair[m])
        work[("scatter", f"general_{m}_fused")] = (
            4 * (nd * n_fro + 4 * n_fro) + low_in[m],
            n_fro * (material + sun) + pairs[m] * per_pair[m])
        work[("scatter", f"general_{m}_planes")] = (
            4 * (nd * n_fro + 4 * n_fro + 3 * n_fro) + low_in[m],
            n_fro * sun + pairs[m] * per_pair[m])
    rows = {}
    for key in GENERAL_PATHS:
        fn, plain = calls[key]
        slow = "rays" in key[1]
        ms = kernel_time_ms(fn, 5 if slow else 20)
        plain_ms = cuda_time_ms(plain, 1)
        b_ms, b_by = bound(*work[key])
        rows[key] = {"max_abs_err": key_errs[key], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
        log(f"# {key[0]}, {key[1]} (9 suns, 9 fBm channels): {ms:.4f} "
            f"ms/call, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
            f"{b_by} ({work[key][0] / 1e6:.1f} MB, "
            f"{work[key][1] / 1e9:.3f} GFLOP)")
    return errs, rows


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
    # past one launch's shared memory: 2 chunks of 512 slices
    "pixels_720p_1024": ("pixels", (720, 1280), (160, 88, 1024),
                         "checked and timed only"),
}
# K14's chunked form forced on a grid one launch takes: form of K14_FORMS
# -> the chunk counts held against its one launch, the first of them timed
K14_FORCED = {"pixels_720p": (2, 3)}


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
    leaf: K4's log() ulps; K14 is its twin bit for bit, and the plain
    passes' autograd may sum in another order on the card), checks that
    every gradient is
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
    zg._k14 = lambda form, g, sc, vd, p, grid, chunks=None: \
        zg.composite_grad_plain(g, sc, vd, p, grid, form)
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


# train_ssr: DEMO_CONFIG (train_fog's frame, 1280x720) through
# render_frame_post with SSR on under grad, TRAIN_STEPS Adam steps of
# FogParams; each step launches K4 and K13 (its RECORD instance) forward,
# K15 and K14 backward, once each, and no other kernel
TRAIN_SSR_POST = dict(ssr_intensity=0.5)
TRAIN_SSR_KERNELS = ("composite", "composite_grad", "ssr_march",
                     "ssr_march_grad")


def train_ssr(renderer, scene, scene_color, view_depth, shadow_data,
              inverse, cuda, zg, ssr_ops, post, name="train_ssr",
              post_kw=None, steps=TRAIN_STEPS):
    """The train_ssr phase (`name`, its PostConfig post_kw, TRAIN_SSR_POST
    by default): `steps` Adam steps (lr TRAIN_LR) of the fog
    toward absorption 0.6, the loss the mean squared error of
    render_frame_post's display image, from a fresh state with the launch
    counters set to 0 just before and read just after. Each step must
    launch TRAIN_SSR_KERNELS once each and nothing else, and no plain march
    (ssr_march_reference, ssr_march_grad_plain) may run. Holds the first
    step's gradients against the same step with K4, K14, K13 and K15
    swapped for their twins (1e-4 max|g_twin| + 1e-12 a leaf: K4's log()
    ulps and the plain passes' autograd; K14 and K15 are their twins bit
    for bit), checks that they are finite and one is non-zero, times
    forward, backward and Adam with CUDA events and reports the peak device
    memory. Each step's K13 and K15 launches must take the forms their
    table takes (cuda.form_counts). Returns (launches, record)."""
    import copy
    cfg = post.PostConfig(**(post_kw or TRAIN_SSR_POST))
    offsets = post._ssr_offsets(cfg)
    table = (len(offsets), max(len(b) for b in offsets))
    want_forms = {"ssr_march": {"record_" + ssr_ops.k13_form(*table): steps},
                  "ssr_march_grad": {ssr_ops.k15_form(*table): steps}}
    params, apply_fn, target_scene = train_setup("fog", inverse, scene)
    state = renderer.init_state(scene.dir_lights.count)

    def display(p_scene):
        return renderer.render_frame_post(state, p_scene, cfg, 0.0,
                                          scene_color, view_depth,
                                          shadow_data)[0]

    def loss_of(p, target):
        return torch.mean((display(apply_fn(p, scene)) - target) ** 2)

    with torch.no_grad():
        target = display(target_scene).contiguous()
    # the first step's gradients with every kernel's twin
    twin_params = copy.deepcopy(params)
    real = (zg._k4, zg._k14, ssr_ops.ssr_march, ssr_ops.ssr_march_grad)
    zg._k4 = lambda form, *a: (zg.composite_plain if form == "cells"
                               else zg.composite_pixels_plain)(*a)
    zg._k14 = lambda form, g, sc, vd, p, grid, chunks=None: \
        zg.composite_grad_plain(g, sc, vd, p, grid, form)
    ssr_ops.ssr_march = lambda *a, record=False: \
        ssr_ops.ssr_march_reference(*a, record=record)
    ssr_ops.ssr_march_grad = lambda g, b, h, o, m: \
        ssr_ops.ssr_march_grad_plain(g, b, h, o)
    try:
        loss_of(twin_params, target).backward()
    finally:
        zg._k4, zg._k14, ssr_ops.ssr_march, ssr_ops.ssr_march_grad = real
    twin = leaf_grads(twin_params)

    # the plain marches, counted while the steps run
    plain = {"ssr_march_reference": 0, "ssr_march_grad_plain": 0}
    real_plain = (ssr_ops.ssr_march_reference, ssr_ops.ssr_march_grad_plain)

    def counted(name, fn):
        def run(*a, **kw):
            plain[name] += 1
            return fn(*a, **kw)
        return run

    opt = torch.optim.Adam(params.parameters(), lr=TRAIN_LR,
                           betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_of(params, target)
        loss.backward()
        opt.step()
        return loss.detach()

    ssr_ops.ssr_march_reference = counted("ssr_march_reference",
                                          real_plain[0])
    ssr_ops.ssr_march_grad_plain = counted("ssr_march_grad_plain",
                                           real_plain[1])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        forms_before = {k: cuda.form_counts(k) for k in want_forms}
        cuda.reset_launches()
        losses, first = [], None
        t0 = time.perf_counter()
        for i in range(steps):
            before = dict(cuda.LAUNCHES)
            losses.append(float(step()))
            delta = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.SOURCES}
            want = {k: int(k in TRAIN_SSR_KERNELS) for k in cuda.SOURCES}
            if delta != want:
                raise AssertionError(
                    f"{name}: step {i} launched "
                    f"{ {k: v for k, v in delta.items() if v} }, not "
                    f"{TRAIN_SSR_KERNELS} once each")
            if i == 0:
                first = leaf_grads(params)
        torch.cuda.synchronize()
        step_wall = 1e3 * (time.perf_counter() - t0) / steps
        launches = dict(cuda.LAUNCHES)
        forms = {k: {f: n - forms_before[k][f]
                     for f, n in cuda.form_counts(k).items()
                     if n != forms_before[k][f]} for k in want_forms}
        peak = torch.cuda.max_memory_allocated() - held
    finally:
        ssr_ops.ssr_march_reference, ssr_ops.ssr_march_grad_plain = \
            real_plain
    log(f"# {name}: launches in the {steps}-step run: "
        f"{json.dumps({k: v for k, v in launches.items() if v})}, by form "
        f"{json.dumps(forms)} ({table[0]} bins of <= {table[1]} taps); "
        f"plain marches {json.dumps(plain)}; losses "
        f"{[f'{v:.6e}' for v in losses]} (fell: {losses[-1] < losses[0]})")
    if forms != want_forms:
        raise AssertionError(f"{name}: K13 and K15 launched in the forms "
                             f"{forms}, not {want_forms}")
    if any(plain.values()):
        raise AssertionError(f"{name}: a plain SSR march ran")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    nonzero = False
    for n, g in first.items():
        w = twin[n]
        if not (bool(torch.isfinite(g).all())
                and bool(torch.isfinite(w).all())):
            raise AssertionError(f"{name}: non-finite gradient {n}")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        scale = float(w.abs().max()) if w.numel() else 0.0
        nonzero = nonzero or float(g.abs().max() if g.numel() else 0) > 0
        log(f"# {name}: gradient {n} {tuple(g.shape)} max |g| "
            f"{float(g.abs().max()) if g.numel() else 0.0:.4e}, max |g - "
            f"g_twin| {err:.3e} (allowed 1e-4 max|g_twin| + 1e-12 = "
            f"{1e-4 * scale + 1e-12:.3e})")
        if err > 1e-4 * scale + 1e-12:
            raise AssertionError(f"{name}: gradient {n} disagrees with "
                                 "the twins' step")
    if not nonzero:
        raise AssertionError(f"{name}: every gradient is zero")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    parts = {"forward": 0.0, "backward": 0.0, "adam": 0.0}
    n = 3
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = loss_of(params, target)
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        for k, (a, b) in zip(parts, ((0, 1), (1, 2), (2, 3))):
            parts[k] += ev[a].elapsed_time(ev[b]) / n
    with torch.no_grad():
        no_grad = cuda_time_ms(lambda: loss_of(params, target), n)
    profile_frames(step, 2)
    record = dict(parts, step_wall_ms=step_wall, peak_bytes=peak,
                  losses=losses, forward_no_grad_ms=no_grad)
    log(f"# {name} step: forward {parts['forward']:.3f} ms, backward "
        f"{parts['backward']:.3f} ms, Adam {parts['adam']:.3f} ms (CUDA "
        f"events, mean of {n}); the forward without grad {no_grad:.3f} ms; "
        f"{step_wall:.3f} ms host wall a step over the counted run; peak "
        f"device memory of the steps {peak / 2**20:.1f} MiB above the "
        f"{held / 2**20:.1f} MiB the run held before them")
    return launches, record


def k14_forms(zg, froxel, camera, sample_grid, bound, cuda):
    """K14 against composite_grad_plain in each of K14_FORMS on seeded random
    inputs (a torch.Generator): a gradient in [-1, 1], a scene in [0, 1],
    depths from the near plane to 140 (past the volume's far end); its
    time, the twin's, the bound and, as the library yardstick, the backward
    of grid_sample (3D, border) at the same sample points. K14 must equal
    its twin (CHECKS: 0) and a second launch on the same inputs bit for
    bit; where K14_FORCED names the form, its chunked form forced into
    those chunk counts equals the one launch bit for bit (the first timed,
    as form "<form>_<n>_chunks"). Each launch's form (one launch or
    chunked) must be the one k14_chunks plans (cuda.form_counts). Returns
    form -> (max abs err, ms, plain ms, library ms, (bytes,
    operations))."""
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
        n_chunks = zg.k14_chunks(d, zg.grad_footprint(ih, iw, grid,
                                                       k4_form)[1])[0]
        before = cuda.form_counts("composite_grad")
        got = zg.composite_grad(*args)
        form_of = {f: c - before[f] for f, c in
                   cuda.form_counts("composite_grad").items()
                   if c != before[f]}
        want = {"chunked" if n_chunks > 1 else "one": 1}
        if form_of != want:
            raise AssertionError(f"K14 ({form}) launched {form_of}, not "
                                 f"{want} ({n_chunks} chunks planned)")
        twin = zg.composite_grad_plain(*args)
        err = compare("composite_grad", got, twin, form)
        again = zg.composite_grad(*args)
        log(f"# composite_grad, {form}: = its twin bit for bit: "
            f"{torch.equal(got, twin)}; two launches bit for bit equal: "
            f"{torch.equal(got, again)}")
        if not torch.equal(got, twin) or not torch.equal(got, again):
            raise AssertionError(f"K14 ({form}) differs from its twin or "
                                 "from its own second launch")
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
            f"{w}x{h}x{d}, {n_chunks} chunk(s)): {ms:.4f} ms/launch, plain "
            f"{plain:.3f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({work[0] / 1e6:.1f} MB), grid_sample backward {lib:.4f} ms")
        out[form] = (err, ms, plain, lib, work)
        for i, n in enumerate(K14_FORCED.get(form, ())):
            chunked = zg.composite_grad(*args, chunks=n)
            same = torch.equal(chunked, got)
            log(f"# composite_grad, {form} forced into {n} chunks: = its "
                f"one launch bit for bit: {same}")
            if not same:
                raise AssertionError(f"K14 ({form}) in {n} chunks differs "
                                     "from its one launch")
            if i == 0:
                c_ms = kernel_time_ms(
                    lambda n=n: zg.composite_grad(*args, chunks=n), 20)
                log(f"# composite_grad, {form} in {n} chunks: {c_ms:.4f} "
                    f"ms/launch (one launch {ms:.4f})")
                out[f"{form}_{n}_chunks"] = (
                    compare("composite_grad", chunked, twin,
                            f"{form}_{n}_chunks"), c_ms, plain, lib, work)
    return out


def train_sharded(renderer, scene, scene_color, view_depth, inverse,
                  cuda):
    """make_sharded_train_step on a one-rank NCCL group over 2 views (the
    camera moved for the second) against one process's step over their
    mean loss, each from the same fog and a fresh Adam: the loss and the
    updated parameters to 1e-6 relative (two views' gradients summed by
    autograd against one mean loss's: another order of the same adds;
    K14 itself gives the same bits on every run)."""
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
        paths = K14_FORMS.get(form, (0, 0, 0, "checked and timed only"))[3]
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
    for form in k14:
        if form != "pixels_720p":
            entry[form] = fields(form)
    return entry


def demo_entry(cuda):
    """The demo_entry phase: the port's demo (volumetricrenderer_tpu_torch.
    demo) in this process through its main(argv), as a user runs it:
    --mesh-env for 2 frames, then --dump-scene of that scene, then --scene
    on the dumped file for 2 frames. Each run must exit 0 and write its
    PNGs; the loaded scene must render the built one's display checksums
    bit for bit."""
    import contextlib
    import io
    from volumetricrenderer_tpu_torch import demo

    def run(*argv):
        buf = io.StringIO()
        torch.cuda.synchronize()
        cuda.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = demo.main(list(argv))
        wall = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"# demo_entry: {line}")
        log(f"# demo_entry: {' '.join(argv[:3])}...: exit {rc} in "
            f"{wall:.2f} s, launches "
            f"{json.dumps({k: v for k, v in cuda.LAUNCHES.items() if v})}")
        if rc != 0:
            raise AssertionError(f"demo {argv} exited {rc}")
        return [line.split("checksum ")[1] for line in text.splitlines()
                if "checksum " in line]

    with tempfile.TemporaryDirectory() as tmp:
        built, loaded = os.path.join(tmp, "built"), os.path.join(tmp, "load")
        scene_file = os.path.join(tmp, "mesh_scene.json")
        sums = run("--mesh-env", "--frames", "2", "--out", built)
        run("--mesh-env", "--dump-scene", scene_file)
        sums_loaded = run("--scene", scene_file, "--frames", "2", "--out",
                          loaded)
        pngs = [os.path.join(d, f"frame_{i:03d}.png") for d in (built, loaded)
                for i in range(2)]
        missing = [p for p in pngs
                   if not (os.path.isfile(p) and os.path.getsize(p) > 0)]
        log(f"# demo_entry: {len(pngs) - len(missing)} of {len(pngs)} PNGs "
            f"written; checksums built {sums}, loaded {sums_loaded}")
        if missing or len(sums) != 2 or sums != sums_loaded:
            raise AssertionError("demo_entry: PNGs missing, or the scene "
                                 "file renders another image")


def raster_phase(renderers, mesh, cuda):
    """The raster phase on the card: the mesh scene's G-buffer (the analytic
    ray cast, the trees rasterized by ops/raster.py and shaded against the
    analytic occluders, composited by depth) at mesh_full's 1920x1080 and
    mesh_production's 1280x720, timed whole, the raster alone and the
    shading alone (CUDA events and the host clock); it launches none of the
    kernels. Returns {image height: (colour, depth)}."""
    from volumetricrenderer_tpu_torch.ops import raster, raycast

    def timed(label, fn, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
        log(f"# raster: {label}: {start.elapsed_time(end) / n:.3f} ms "
            f"device-event mean, {wall_ms:.3f} ms host wall mean over {n} "
            f"warm calls")

    out = {}
    cam = mesh.camera
    sun_dir = mesh.dir_lights.direction[0]
    sun_color = mesh.dir_lights.packed_color[0]
    torch.cuda.synchronize()
    cuda.reset_launches()
    for name in ("mesh_full", "mesh_production"):
        r = renderers[name]
        iw, ih = r.config.image_width, r.config.image_height
        t0 = time.perf_counter()
        out[ih] = r.render_scene_inputs(mesh)
        torch.cuda.synchronize()
        log(f"# raster: G-buffer {iw}x{ih} ({name}), first call "
            f"{1e3 * (time.perf_counter() - t0):.1f} ms host wall")
        timed(f"G-buffer {iw}x{ih} (ray cast + raster + shading)",
              lambda: r.render_scene_inputs(mesh), 1)
        rast = lambda: raster.rasterize_mesh(mesh.mesh, cam, iw, ih,
                                             raster.CUDA_CHUNK)
        malb, mnrm, mdepth = rast()
        timed(f"rasterize_mesh {iw}x{ih}, {mesh.mesh.num_tris} triangles "
              f"in chunks of {raster.CUDA_CHUNK}", rast, 5)
        dirs, _ = raycast.camera_rays(iw, ih, cam.fov_y, cam.aspect,
                                      cam.view_to_world())
        timed(f"shade_mesh_gbuffer {iw}x{ih}",
              lambda: raster.shade_mesh_gbuffer(
                  malb, mnrm, mdepth, cam.position, dirs, mesh.geometry,
                  sun_dir, sun_color, mesh.ambient), 1)
        color, depth = out[ih]
        on_mesh = float((mdepth <= depth).float().mean())
        log(f"# raster: {iw}x{ih}: the trees on {on_mesh:.4%} of the "
            f"pixels; colour checksum "
            f"{float(color.sum(dtype=torch.float32))!r}, depth checksum "
            f"{float(depth.sum(dtype=torch.float32))!r}")
        if not (bool(torch.isfinite(color).all())
                and bool(torch.isfinite(depth).all()) and on_mesh > 0.0):
            raise AssertionError(f"the mesh G-buffer at {iw}x{ih} is not "
                                 "finite or shows no tree")
    torch.cuda.synchronize()
    if any(cuda.LAUNCHES.values()):
        raise AssertionError("the G-buffer bake launched a kernel")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def nccl_probe(rank: int, device: str, init: str, out_dir: str) -> None:
    """One rank of shardmap3's NCCL probe (spawned): an NCCL group of
    SHARDMAP_RANKS ranks, an all_reduce and the neighbour send/recv that
    make_shardmap_render makes. On an error its text goes to
    out_dir/probe<rank>.txt and the rank exits 1."""
    import datetime
    import torch.distributed as dist
    try:
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init, rank=rank,
                                world_size=SHARDMAP_RANKS,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(4, device=device)
        dist.all_reduce(x)
        nxt, prv = (rank + 1) % SHARDMAP_RANKS, (rank - 1) % SHARDMAP_RANKS
        y = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, y, prv)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        torch.cuda.synchronize()
        if float(y.sum()) != 4.0 * SHARDMAP_RANKS:
            raise RuntimeError(f"NCCL probe: received {y.tolist()}")
        dist.destroy_process_group()
    except Exception as e:      # the text is the finding; the exit code says
        with open(os.path.join(out_dir, f"probe{rank}.txt"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        sys.exit(1)


def shardmap_rank(rank: int, backend: str, device: str, init: str,
                  n_frames: int, out_dir: str) -> None:
    """One rank of shardmap3 (spawned): slab3's configuration, scene and
    frames through make_shardmap_render on a `backend` group, this rank's
    G-buffer band bound as fixed_inputs, from fn.init_state. Saves to
    out_dir/rank<rank>.pt its G-buffer band, every frame's band and cropped
    state, its launches, its frame times (CUDA events and host wall over
    SHARDMAP_TIMED warm frames) and, over as many frames again with the
    device synchronized around each exchange, the exchange's host time;
    rank 0 also profiles 3 frames (the others render beside it)."""
    import datetime
    import torch.distributed as dist
    from volumetricrenderer_tpu_torch import (FULL_CONFIG, VolumetricRenderer,
                                              benchmark_scene)
    from volumetricrenderer_tpu_torch.ops import cuda
    from volumetricrenderer_tpu_torch.parallel import sharding
    from volumetricrenderer_tpu_torch.parallel import shard_render as shr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=SHARDMAP_RANKS,
                            timeout=datetime.timedelta(seconds=240))
    try:
        mesh = sharding.make_mesh(device)
        cfg = FULL_CONFIG
        r = VolumetricRenderer(cfg, device=device)
        scene = benchmark_scene(aspect=cfg.image_width / cfg.image_height,
                                num_local_lights=16, noise_mode="procedural",
                                device=device)
        sc, vd = r.render_scene_inputs(scene)
        ih = cfg.image_height // mesh.size
        band = (sc[rank * ih:(rank + 1) * ih], vd[rank * ih:(rank + 1) * ih])
        fn = shr.make_shardmap_render(r, mesh, fixed_inputs=band)
        state = fn.init_state(scene.dir_lights.count)
        torch.cuda.synchronize()
        cuda.reset_launches()
        bands, states = [], []
        for i in range(n_frames):
            img, state = fn(state, slab_scene(scene, i), 0.1 * i)
            bands.append(img.cpu())
            states.append({f: t.cpu()
                           for f, t in shr_crop(state, fn.halo).items()})
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        box = {"s": state}

        def one():
            _, box["s"] = fn(box["s"], scene, 0.5)

        ev_ms = cuda_time_ms(one, SHARDMAP_TIMED)
        t0 = time.perf_counter()
        for _ in range(SHARDMAP_TIMED):
            one()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / SHARDMAP_TIMED
        real, spent = shr._exchange, []

        def timed_exchange(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*args)
            torch.cuda.synchronize()
            spent.append(time.perf_counter() - t)
            return out

        shr._exchange = timed_exchange
        try:
            t0 = time.perf_counter()
            for _ in range(SHARDMAP_TIMED):
                one()
            torch.cuda.synchronize()
            sync_ms = 1e3 * (time.perf_counter() - t0) / SHARDMAP_TIMED
        finally:
            shr._exchange = real
        if rank == 0:
            log(f"# shardmap3 rank 0 ({backend}) under the profiler, the "
                "other ranks rendering beside it:")
            profile_frames(one, 3)
        else:
            for _ in range(3):      # the 3 frames rank 0 profiles
                one()
        torch.cuda.synchronize()
        torch.save({"band_gbuffer": (band[0].cpu(), band[1].cpu()),
                    "bands": bands, "states": states, "launches": launches,
                    "halo": fn.halo, "backend": mesh.backend,
                    "host_staged": mesh.host_staged, "event_ms": ev_ms,
                    "wall_ms": wall_ms, "synced_wall_ms": sync_ms,
                    "exchange_ms": 1e3 * sum(spent) / len(spent)},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, args_of, what: str) -> list:
    """Start SHARDMAP_RANKS spawned processes target(rank, *args_of(rank)),
    join each (at most SHARDMAP_JOIN_S in all), kill what is left; returns
    the exit codes."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, *args_of(rank)))
             for rank in range(SHARDMAP_RANKS)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + SHARDMAP_JOIN_S
    try:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.is_alive():
                log(f"# {what}: a rank still ran after {SHARDMAP_JOIN_S} s: "
                    "killed")
                p.kill()
                p.join()
    return [p.exitcode for p in procs]


def shardmap_phase(slab_run, halo: int, scene_color, view_depth):
    """shardmap3: make_shardmap_render on SHARDMAP_RANKS spawned ranks, each
    band and cropped state of slab3's frames held bit for bit against
    slab3's shard (make_multislab_render). With as many GPUs as ranks the
    group is NCCL, a rank a GPU; on fewer, NCCL is tried first with the
    ranks sharing the GPUs (a probe group), and where NCCL refuses that the
    group is gloo, with make_shardmap_render staging the edge rows through
    host memory. A rank that fails fails the phase."""
    n_gpu = torch.cuda.device_count()
    devices = [f"cuda:{r % n_gpu}" for r in range(SHARDMAP_RANKS)]
    tmp = tempfile.mkdtemp()
    backend = "nccl"
    if n_gpu < SHARDMAP_RANKS:
        init = f"tcp://localhost:{free_port()}"
        t0 = time.perf_counter()
        codes = spawn_ranks(nccl_probe, lambda r: (devices[r], init, tmp),
                            "the NCCL probe")
        refused = {}
        for r in range(SHARDMAP_RANKS):
            path = os.path.join(tmp, f"probe{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    refused[r] = f.read()
        log(f"# shardmap3: NCCL with {SHARDMAP_RANKS} ranks on {n_gpu} "
            f"GPU(s) {devices}: exit codes {codes} in "
            f"{time.perf_counter() - t0:.1f} s")
        for r, text in refused.items():
            log(f"# shardmap3: NCCL refused on rank {r}: {text!r}")
        if codes != [0] * SHARDMAP_RANKS:
            backend = "gloo"
    n_frames = len(slab_run[5])
    init = f"tcp://localhost:{free_port()}"
    t0 = time.perf_counter()
    codes = spawn_ranks(shardmap_rank, lambda r: (
        backend, devices[r], init, n_frames, tmp), "shardmap3")
    log(f"# shardmap3: backend {backend}"
        + (" (edge rows staged through host memory)" if backend == "gloo"
           else "") + f", ranks on {devices}, exit codes {codes}, "
        f"{time.perf_counter() - t0:.1f} s with the spawns")
    if codes != [0] * SHARDMAP_RANKS:
        raise AssertionError(f"shardmap3: a rank failed (exit codes {codes})")
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
             for r in range(SHARDMAP_RANKS)]
    shutil.rmtree(tmp)
    ih = scene_color.shape[0] // SHARDMAP_RANKS
    same = {"gbuffer": True, "bands": True, "states": True}
    for r, got in enumerate(ranks):
        g_sc, g_vd = got["band_gbuffer"]
        same["gbuffer"] &= (
            torch.equal(g_sc, scene_color[r * ih:(r + 1) * ih].cpu())
            and torch.equal(g_vd, view_depth[r * ih:(r + 1) * ih].cpu()))
        for i in range(n_frames):
            want = slab_run[5][i][r]
            same["bands"] &= torch.equal(got["bands"][i], want.cpu())
            st = shr_crop(slab_run[2][i + 1][0][r], halo)
            same["states"] &= st.keys() == got["states"][i].keys() and all(
                torch.equal(got["states"][i][f], t.cpu())
                for f, t in st.items())
        expect = {k: n_frames for k in FUSED_KERNELS}
        if got["launches"] != expect:
            raise AssertionError(f"shardmap3 rank {r}: launches "
                                 f"{got['launches']}, not {expect}")
        log(f"# shardmap3 rank {r}: frame {got['event_ms']:.3f} ms "
            f"device-event mean, {got['wall_ms']:.3f} ms host wall mean "
            f"over {SHARDMAP_TIMED} warm frames; exchange "
            f"{got['exchange_ms']:.3f} ms host time a frame, the device "
            f"synchronized around it (those frames {got['synced_wall_ms']:.3f}"
            f" ms wall, the exchange's share "
            f"{got['exchange_ms'] / got['synced_wall_ms']:.1%}); launches in "
            f"the {n_frames} held frames {json.dumps(got['launches'])}")
    log(f"# shardmap3 = slab3 bit for bit over {n_frames} frames: G-buffer "
        f"bands {same['gbuffer']}, image bands {same['bands']}, cropped "
        f"states {same['states']}")
    if not all(same.values()):
        raise AssertionError("shardmap3 differs from slab3")
    return backend


def shr_crop(state, halo: int) -> dict:
    """A shard's halo histories cropped to its own rows, by name."""
    from volumetricrenderer_tpu_torch.parallel import shard_render as shr
    st = shr.crop_sharded_state(state, 1, halo)
    return {f: getattr(st, f) for f in shr.HALO_FIELDS
            if getattr(st, f) is not None}


def start_cpu_gbuffer(tmp: str):
    """Start the CPU side of the raster phase: the mesh scene's 720p
    G-buffer by the same plain code on the CPU, in a process of its own
    (this script with --cpu-gbuffer) that runs beside the card's work.
    Returns (the process, its output file)."""
    import atexit
    out_file = os.path.join(tmp, "cpu_gbuffer.pt")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--cpu-gbuffer", out_file])
    atexit.register(proc.kill)
    return proc, out_file


def mesh_inputs(device: str):
    """The raster phase's inputs: mesh_production's config and the mesh
    scene, built on the CPU and moved to `device`, so that the card's
    scene and the CPU's hold the same floats."""
    from volumetricrenderer_tpu_torch import FULL_CONFIG, demo_scene
    cfg = dataclasses.replace(FULL_CONFIG, **PRODUCTION)
    mesh = demo_scene(aspect=FULL_CONFIG.image_width
                      / FULL_CONFIG.image_height, mesh_env=True,
                      device="cpu")
    return cfg, mesh.to(device)


def cpu_gbuffer(out_file: str) -> int:
    """--cpu-gbuffer: the mesh scene's 720p G-buffer and its raster's depth
    on the CPU (the plain code, CPU_CHUNK triangles a chunk), saved to
    out_file."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.ops import raster
    # the cores the main process, which drives the card, leaves idle
    torch.set_num_threads(max(1, (os.cpu_count() or 3) - 2))
    cfg, scene = mesh_inputs("cpu")
    r = VolumetricRenderer(cfg, device="cpu")
    t0 = time.perf_counter()
    color, depth = r.render_scene_inputs(scene)
    seconds = time.perf_counter() - t0
    m_depth = raster.rasterize_mesh(scene.mesh, scene.camera,
                                    cfg.image_width, cfg.image_height,
                                    raster.CPU_CHUNK)[2]
    torch.save({"color": color, "depth": depth, "mesh_depth": m_depth,
                "seconds": seconds}, out_file)
    return 0


def check_cpu_gbuffer(proc, out_file, gbuffer, mesh, config) -> None:
    """The end of the raster phase: the card's 720p G-buffer against the
    CPU's (start_cpu_gbuffer): the pixels that differ, the largest
    differences in depth and colour, and the share past ROADMAP C3's class
    (depth 1e-4 relative, colour 2e-3), which must stay below RASTER_PAST;
    and the raster's depth alone."""
    from volumetricrenderer_tpu_torch.ops import raster
    rc = proc.wait(timeout=900)
    if rc != 0:
        raise AssertionError(f"the CPU G-buffer process exited {rc}")
    d = torch.load(out_file, weights_only=False)
    c_cpu, d_cpu = d["color"], d["depth"]
    c_gpu, d_gpu = (a.cpu() for a in gbuffer)
    rel = (d_gpu - d_cpu).abs() / d_cpu.abs()
    err = (c_gpu - c_cpu).abs().amax(-1)
    past = float(((rel > 1e-4) | (err > 2e-3)).float().mean())
    m_gpu = raster.rasterize_mesh(mesh.mesh, mesh.camera, config.image_width,
                                  config.image_height,
                                  raster.CUDA_CHUNK)[2].cpu()
    m_cpu = d["mesh_depth"]
    both = (m_gpu < raster.BIG) & (m_cpu < raster.BIG)
    log(f"# raster: 720p G-buffer, card against the CPU "
        f"({d['seconds']:.1f} s there, in a process of its own): "
        f"{int(((rel > 0) | (err > 0)).sum())} of {rel.numel()} pixels "
        f"differ; largest depth difference {float(rel.max()):.3e} "
        f"relative, largest colour difference {float(err.max()):.3e}; "
        f"{past:.3e} of the pixels past depth 1e-4 relative or colour 2e-3 "
        f"(allowed {RASTER_PAST:g}: {RASTER_WHY}); the raster alone: "
        f"{int(((m_gpu < raster.BIG) != (m_cpu < raster.BIG)).sum())} "
        f"pixels covered on one side only, largest depth difference "
        f"{float(((m_gpu - m_cpu).abs() / m_cpu)[both].max()):.3e} relative")
    if past > RASTER_PAST:
        raise AssertionError("the mesh G-buffer on the card disagrees with "
                             "the CPU's")


# ---- the index forms: K2, K3, K5, K6, K7, K8 and K9 past 32-bit indices
# and 65535 slices ---------------------------------------------------------

class WideHolds:
    """Every hold (compare) of an output of K2, K3 or K5-K12 whose call
    took the narrow form (K10 and K11: every channel group's), repeated
    with the wide form forced on
    the same inputs: the wide outputs must equal the narrow ones bit for
    bit, and are held against the same twin at the same tolerance (the
    hold's label and ", wide form"). install() wraps the wrappers
    (wide_wrappers) so that each CUDA output remembers its call (until the
    output is freed); compare() calls check()."""

    def __init__(self):
        self.calls = {}      # id(output) -> (ref, kernel, fn, args, kw, i, n)
        self.last = (0, ())  # (call number, wide outputs) of the last repeat
        self.errs = {}       # (kernel, label) -> max abs err against the twin
        self.real = {}
        self.n = 0

    def install(self, wrappers) -> None:
        """wrappers: (module, attribute, kernel source) of each wrapper."""
        for mod, name, kernel in wrappers:
            self.real[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self._recorder(getattr(mod, name), kernel))

    def uninstall(self) -> None:
        for (mod, name), fn in self.real.items():
            setattr(mod, name, fn)
        self.real, self.last = {}, (0, ())
        self.calls.clear()

    def _recorder(self, fn, kernel):
        import weakref

        def run(*args, **kw):
            out = fn(*args, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            if kw.get("form") is None and outs[0].is_cuda:
                self.n += 1
                for i, o in enumerate(outs):
                    key = id(o)
                    ref = weakref.ref(o, lambda _, k=key: self.calls.pop(k,
                                                                        None))
                    self.calls[key] = (ref, kernel, fn, args, kw, i, self.n)
            return out
        return run

    @staticmethod
    def rule(kernel, fn, args, kw) -> str:
        """The form the size rule gave the recorded call."""
        import inspect
        from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
        from volumetricrenderer_tpu_torch.ops import frame_fused as ff
        from volumetricrenderer_tpu_torch.ops import integrate as integ
        from volumetricrenderer_tpu_torch.ops import pcf_shadow as pcf
        from volumetricrenderer_tpu_torch.ops import scatter as sca
        from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
        from volumetricrenderer_tpu_torch.ops import temporal as tmp
        from volumetricrenderer_tpu_torch.ops import visibility as vis
        from volumetricrenderer_tpu_torch.ops import warp as wp
        a = inspect.signature(fn).bind(*args, **kw)
        a.apply_defaults()
        a = a.arguments
        local = lambda: sca.local_mode(a["bake"], a["vis"])
        # K10 and K11: the largest channel group's form (narrow: every
        # group's)
        group = lambda v, n: (n, *v.shape[1:])
        return {"shadow_scatter": lambda: ff.k2_form(a["t"], local()),
                "integrate_blend": lambda: ff.k3_form(a["t"]),
                "shadow_blend": lambda: sb.k5_form(a["t"]),
                "scatter": lambda: sca.k6_form(a["t"], local()),
                "dir_shadow": lambda: ds.k7_form(a["t"]),
                "integrate": lambda: integ.k8_form(a["t"]),
                "bake_visibility": lambda: vis.k9_form(a["t"]),
                "temporal_blend": lambda: tmp.k10_form(group(
                    a["prev"], tmp.channel_groups(a["prev"].shape[0],
                                                  a["mode"])[0][1])),
                "windowed_warp": lambda: wp.k11_form(group(
                    a["vol"], wp.channel_groups(a["vol"].shape[0])[0][1])),
                "pcf_shadow": lambda: pcf.k12_form(a["t"], a["atlas"])
                }[kernel]()

    def check(self, name, got, want, mode, label) -> None:
        entry = self.calls.get(id(got))
        if entry is None or entry[0]() is not got:
            return
        _, kernel, fn, args, kw, i, n = entry
        if self.rule(kernel, fn, args, kw) != "narrow":
            return
        if self.last[0] != n:
            self.last = (0, ())  # the last repeat's outputs freed first
            out = fn(*args, **dict(kw, form="wide"))
            self.last = (n, out if isinstance(out, tuple) else (out,))
        wide = self.last[1][i]
        if not torch.equal(wide, got):
            diff = (wide - got).abs()
            raise AssertionError(
                f"{kernel} ({label}): the wide form differs from the narrow "
                f"form on {int((diff > 0).sum())} elements, max "
                f"{float(diff.max()):.3e}")
        self.errs[(kernel, label)] = compare(name, wide, want, mode,
                                             f"{label}, wide form")


WIDE = WideHolds()


def wide_wrappers(ff, vis, sb, sca, ds, integ, tmp, wp, pcf) -> tuple:
    """(module, attribute, kernel source) of every wrapper of a kernel with
    index forms, as the holds call them (K9's from ops/frame_fused too)."""
    return ((ff, "shadow_scatter", "shadow_scatter"),
            (ff, "integrate_blend", "integrate_blend"),
            (ff, "bake_visibility", "bake_visibility"),
            (vis, "bake_visibility", "bake_visibility"),
            (sb, "dir_shadow_blend", "shadow_blend"),
            (sca, "scatter_local", "scatter"),
            (ds, "dir_shadow", "dir_shadow"),
            (integ, "accumulate", "integrate"),
            (tmp, "temporal_blend", "temporal_blend"),
            (wp, "windowed_warp", "windowed_warp"),
            (pcf, "pcf_shadow", "pcf_shadow"))


def index_deltas(cuda, before) -> dict:
    """source -> (narrow, wide) launches of cuda.INDEX_SOURCES since
    `before` (their counts then)."""
    return {s: tuple(a - b for a, b in zip(cuda.index_form_launches(s),
                                           before[s]))
            for s in cuda.INDEX_SOURCES}


def fused_work(t, kernel: str, local: str = "radiance"):
    """(bytes, operations) of one launch of K1, K2 or K6 (local source
    `local`), K3, K5, K7, K8 or K9 on tables t, counted as main() counts
    the fixed forms' on the full grid: each input read once, each output
    written once; the rays and the reprojections by their operations, the
    per-light loops by the (froxel, light) pairs each slice's schedule
    keeps, K1's and K9's rays by the (low sample, light) pairs the cull
    keeps."""
    w, h, d = t.grid_whd
    n_fro = w * h * d
    wl, hl, dl = t.low_dims
    n_low = wl * hl * dl
    nd = t.n_dir
    n_lights = 0 if t.lights is None else t.lights.shape[0]
    n_media = len(t.media_static)
    noise_media = sum(1 for st in t.media_static if st[0])
    ops_perlin = 3 * 8 * 40
    ops_ray = 14 * t.n_planes + 22 * t.n_spheres + 30 * t.n_boxes
    ops_shadow = 45 + (24 + 12 * nd) + nd * (30 + ops_ray)
    sun = 40 * nd + 40
    if kernel in ("bake_radiance", "bake_visibility"):
        pairs = int(t.active.sum()) * hl * wl
        if kernel == "bake_visibility":
            return 4 * n_lights * n_low, pairs * (40 + ops_ray)
        return (4 * (3 + t.n_noise) * n_low,
                n_low * (60 + ops_perlin * t.n_noise) + pairs * (60 + ops_ray))
    if kernel == "integrate_blend":
        return 4 * 12 * n_fro, n_fro * ((4 * 20 + 30) + 45 + (24 + 48) + 12)
    if kernel == "integrate":
        return 4 * 8 * n_fro, n_fro * (4 * 20 + 30)
    if kernel == "shadow_blend":
        return 4 * 2 * nd * n_fro, n_fro * ops_shadow
    if kernel == "dir_shadow":
        return 4 * nd * n_fro, n_fro * nd * (30 + ops_ray)
    if kernel == "scatter":  # the shadow in, the planes out, no blend
        if local == "radiance":
            return (4 * (nd * n_fro + (3 + t.n_noise) * n_low + 4 * n_fro),
                    n_fro * ((3 + t.n_noise) * 20 + 60 * n_media + sun))
        pairs = int(t.count.sum()) * h * w
        return (4 * (nd * n_fro + 4 * n_fro
                     + (n_lights * n_low if local == "baked" else 0)),
                n_fro * (60 * n_media + ops_perlin * noise_media + sun)
                + pairs * (60 + (ops_ray if local == "rays" else 20)))
    if local == "radiance":
        return (4 * (2 * nd * n_fro + (3 + t.n_noise) * n_low + 4 * n_fro),
                n_fro * (ops_shadow + (3 + t.n_noise) * 20 + 60 * n_media
                         + sun))
    pairs = int(t.count.sum()) * h * w
    return (4 * (2 * nd * n_fro + 4 * n_fro
                 + (n_lights * n_low if local == "baked" else 0)),
            n_fro * (ops_shadow + 60 * n_media + ops_perlin * noise_media
                     + sun) + pairs * (60 + (ops_ray if local == "rays"
                                             else 20)))


def blend_work(shape, kernel: str):
    """(bytes, operations) of one launch of K10 ("temporal_blend") or K11
    ("windowed_warp") on a [C, D, H, W] volume, counted as main() counts
    them on the full grid: K10 reads the history and the current volume and
    writes the blend, a froxel one reprojection (45), the warp's tent
    weights (24) and taps (12 C) and the blend (3 C); K11 reads the volume
    and the three target volumes and writes the warp, a froxel its three
    offsets (12) and the warp."""
    c, d, h, w = shape
    n = d * h * w
    if kernel == "temporal_blend":
        return 4 * 3 * c * n, n * (45 + 24 + 12 * c + 3 * c)
    return 4 * (2 * c + 3) * n, n * (12 + 24 + 12 * c)


def k12_work(t, atlas):
    """(bytes, operations) of one K12 launch, counted as main() counts it:
    each sun's atlas read once and its volume written once; a froxel its
    world position (45), a (froxel, active cascade) pair the affine
    coordinates, 4 compares, the bilinear weights and the sphere tests
    (50)."""
    w, h, d = t.grid_whd
    nd, s2 = t.par.shape[0], atlas.shape[-1]
    n_out = nd * w * h * d
    pairs = int(t.count.sum()) * h * w
    return 4 * (nd * s2 * s2 + n_out), n_out * 45 + pairs * 50


def wide_forced_rows(calls) -> dict:
    """The wide forms forced at the main path's shapes: calls maps (kernel,
    mode) -> (fn(form), plain_ms, work, the WIDE holds' labels, launches a
    timing). Times the narrow and the wide form in turns (narrow, wide,
    wide, narrow; CUDA events behind a spin) and returns the rows of the
    kernels line: the wide form's ms, the narrow form's beside it, the
    largest wide hold against the twin, the bound."""
    rows = {}
    for (k, m), (fn, plain_ms, work, labels, n) in calls.items():
        nar = [kernel_time_ms(lambda: fn("narrow"), n)]
        wid = [kernel_time_ms(lambda: fn("wide"), n)]
        wid.append(kernel_time_ms(lambda: fn("wide"), n))
        nar.append(kernel_time_ms(lambda: fn("narrow"), n))
        b_ms, b_by = bound(*work)
        rows[(k, m)] = {
            "launches": 0, "paths": [],
            "max_abs_err": max(WIDE.errs[(k, lab)] for lab in labels),
            "ms": sum(wid) / 2, "narrow_ms": sum(nar) / 2,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}
        log(f"# {k}, {m}: wide {wid[0]:.4f} {wid[1]:.4f} ms, narrow "
            f"{nar[0]:.4f} {nar[1]:.4f} ms (in turns: narrow, wide, wide, "
            f"narrow; wide / narrow {sum(wid) / sum(nar):.3f}), bound "
            f"{b_ms:.4f} ms by {b_by}; holds {labels}")
    return rows


def index_form_mirrors(ff, vis, sca, cuda, tables) -> None:
    """The wrappers' form mirrors (ops/frame_fused.k2_form, k3_form,
    ops/shadow_blend.k5_form, ops/scatter.k6_form, ops/dir_shadow.k7_form,
    ops/integrate.k8_form, ops/visibility.k9_form, ops/temporal.k10_form,
    ops/warp.k11_form, ops/pcf_shadow.k12_form) against the launchers' own
    size rules (`vr_*_form_of`) at the edges: 2^31 - 1 and 2^31 floats,
    65535 and 65536 slices (K3: rows; K12: (sun, slice) pairs), 65535 row
    tiles, on FULL_CONFIG's tables at other grids and light counts, K10's
    and K11's launch volumes and K12's tables (meta tables: the rules read
    the dimensions alone)."""
    import ctypes
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import integrate as integ
    from volumetricrenderer_tpu_torch.ops import pcf_shadow as pcf
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import warp as wp

    def of(name, *args):
        buf = (ctypes.c_int * 2)()
        getattr(cuda.lib(name), f"vr_{name}_form_of")(
            *args, ctypes.cast(buf, ctypes.c_void_p))
        return tuple(buf)

    def mirror(fn, *args):
        try:
            return cuda.INDEX_FORMS.index(fn(*args))
        except ValueError:
            return -1

    meta = lambda n: torch.empty((n, 16), device="meta")
    rad, ray, baked = sca.LOCAL_RADIANCE, sca.LOCAL_RAY, sca.LOCAL_BAKED
    k2 = [((2048, 2047, 128), 1, 16, rad), ((2048, 2048, 128), 1, 16, rad),
          ((1024, 1024, 409), 5, 16, baked), ((1024, 1024, 410), 5, 16, ray),
          ((8, 8, 65535), 1, 16, rad), ((8, 8, 65536), 1, 16, ray),
          ((2048, 1024, 128), 1, 511, baked), ((2048, 1024, 128), 1, 512,
                                                baked),
          ((16, 15, 65535), 1, 32769, ray), ((16, 15, 65535), 1, 32769, rad),
          ((16, 16 * 65535 + 1, 1), 1, 16, rad)]
    k3 = [(1024, 1024, 511), (1024, 1024, 512), (8, 65535, 16),
          (8, 65536, 16), (16, 9, 65664), (8, 200000, 16)]
    k9 = [((240, 135, 128), 32896), ((240, 135, 128), 32897),
          ((8, 8, 65536), 16), ((16, 15, 16), 2 ** 27)]
    # K5 and K7: the [max(4, Nd), D, H, W] planes, the slices, the row tiles
    k5_k7 = [((2048, 2047, 128), 1), ((2048, 2048, 128), 1),
             ((240, 135, 128), 517), ((240, 135, 128), 518),
             ((8, 8, 65535), 1), ((8, 8, 65536), 1),
             ((16, 16 * 65535, 1), 1), ((16, 16 * 65535 + 1, 1), 1)]
    # K6: the planes and slices, each source's low channels, the schedule,
    # the baked tiles' rows, the runs' froxels of a slice
    k6 = [((2048, 2047, 128), 1, 16, rad), ((2048, 2048, 128), 1, 16, rad),
          ((8, 8, 65535), 1, 16, baked), ((8, 8, 65536), 1, 16, ray),
          ((240, 135, 128), 1, 32896, baked), ((240, 135, 128), 1, 32897,
                                              baked),
          ((240, 135, 128), 1, 32897, rad), ((16, 15, 65535), 1, 32769, ray),
          ((16, 15, 65535), 1, 32769, rad), ((16, 8 * 65535 + 1, 1), 1, 16,
                                             baked),
          ((16, 8 * 65535 + 1, 1), 1, 16, ray),
          ((2 ** 16, 2 ** 15 - 1, 1), 1, 16, rad),
          ((2 ** 16, 2 ** 15, 1), 1, 16, rad)]
    k8 = [(2048, 2047, 128), (2048, 2048, 128), (1024, 1024, 520),
          (8, 8, 65536), (2 ** 30, 2 ** 8, 1)]
    rows = []
    for grid, nd, nl, local in k2:
        t = dataclasses.replace(tables, grid_whd=grid, n_dir=nd,
                                lights=meta(nl))
        st = t.c_struct()
        got = of("shadow_scatter", ctypes.byref(st), local)
        want = mirror(ff.k2_form, t, local)
        rows.append(("K2", grid, nd, nl, local, got, want))
    for grid in k3:
        t = dataclasses.replace(tables, grid_whd=grid)
        st = t.c_struct()
        rows.append(("K3", grid, 0, 0, None,
                     of("integrate_blend", ctypes.byref(st)),
                     mirror(ff.k3_form, t)))
    for grid, nl in k9:
        t = dataclasses.replace(tables, grid_whd=grid, lights=meta(nl))
        st = t.c_struct()
        rows.append(("K9", grid, 0, nl, None,
                     of("bake_visibility", ctypes.byref(st)),
                     mirror(vis.k9_form, t)))
    for grid, nd in k5_k7:
        t = dataclasses.replace(tables, grid_whd=grid, n_dir=nd)
        st = t.c_struct()
        rows.append(("K5", grid, nd, 0, None,
                     of("shadow_blend", ctypes.byref(st)),
                     mirror(sb.k5_form, t)))
        rows.append(("K7", grid, nd, 0, None,
                     of("dir_shadow", ctypes.byref(st)),
                     mirror(ds.k7_form, t)))
    for grid, nd, nl, local in k6:
        t = dataclasses.replace(tables, grid_whd=grid, n_dir=nd,
                                lights=meta(nl))
        st = t.c_struct()
        rows.append(("K6", grid, nd, nl, local,
                     of("scatter", ctypes.byref(st), local),
                     mirror(sca.k6_form, t, local)))
    for grid in k8:
        t = dataclasses.replace(tables, grid_whd=grid)
        st = t.c_struct()
        rows.append(("K8", grid, 0, 0, None,
                     of("integrate", ctypes.byref(st)),
                     mirror(integ.k8_form, t)))
    # K10 and K11: one launch's [C, D, H, W] volume (2^31 - 1 is prime)
    k10_k11 = [(1, 1, 1, 2 ** 31 - 1), (2, 1, 1, 2 ** 30),
               (4, 128, 2048, 2047), (4, 128, 2048, 2048), (4, 65535, 8, 8),
               (4, 65536, 8, 8), (4, 65664, 9, 16), (4, 520, 1024, 1024),
               (1, 1, 16 * 65535, 16), (1, 1, 16 * 65535 + 1, 16)]
    for shape in k10_k11:
        c, d, h, w = shape
        rows.append(("K10", shape, 0, 0, None,
                     of("temporal_blend", c, w, h, d),
                     mirror(tmp.k10_form, shape)))
        rows.append(("K11", shape, 0, 0, None,
                     of("windowed_warp", c, d, h, w),
                     mirror(wp.k11_form, shape)))
    # K12: the volumes, the atlases, the (sun, slice) pairs, the row tiles
    # and a sun's cascade table [D, C, 8] (4 cascades)
    k12 = [((2 ** 31 - 1, 1, 1), 1, 64), ((2 ** 30, 2, 1), 1, 64),
           ((16, 15, 16), 1, 46340), ((16, 15, 16), 1, 46341),
           ((8, 8, 65535), 1, 64), ((8, 8, 65536), 1, 64),
           ((240, 135, 128), 511, 64), ((240, 135, 128), 512, 64),
           ((16, 9, 65664), 1, 1024), ((16, 16 * 65535 + 1, 1), 1, 64),
           ((1, 1, 2 ** 26 - 1), 1, 64), ((1, 1, 2 ** 26), 1, 64)]
    nc = 4
    for grid, nd, s2 in k12:
        w, h, d = grid
        m = lambda *shape: torch.empty(shape, device="meta")
        t = pcf.PcfTables(par=m(nd, 24), coef=m(nd, d, nc, 8),
                          order=m(nd, d, nc), count=m(nd, d),
                          spheres=m(nd, nc, 4), grid_whd=grid, h_glob=h)
        rows.append(("K12", f"{grid}, atlas {s2}", nd, 0, None,
                     of("pcf_shadow", w, h, d, s2, nc, nd),
                     mirror(pcf.k12_form, t, m(nd, s2, s2))))
    bad = [r for r in rows if r[5][0] != r[6]]
    for r in rows:
        log(f"# index form of {r[0]} at {r[1]}, {r[2]} suns, {r[3]} "
            f"lights, local {r[4]}: the launcher's rule {r[5][0]} (parts "
            f"{r[5][1]}), the wrapper's mirror {r[6]}")
    if bad:
        raise AssertionError(f"the index form mirrors disagree: {bad}")


def replicate(lights, copies: int, fade: bool = False):
    """A light table (DirectionalLights, PointLights, SpotLights) with its
    lights repeated `copies` times, copy c's light l at c * count + l.
    fade: copy c's intensity times 2^-(copies - 1 - c) (0 below float32's
    range), so that a sum over the copies is dominated by the last ones
    and rounds like a sum over a few lights."""
    out = dataclasses.replace(lights, **{
        f.name: torch.cat([getattr(lights, f.name)] * copies)
        for f in dataclasses.fields(lights)})
    if fade:
        scale = torch.tensor([2.0 ** -(copies - 1 - c) for c in range(copies)],
                             dtype=torch.float64).to(torch.float32)
        out = dataclasses.replace(out, intensity=out.intensity * scale.to(
            out.intensity.device).repeat_interleave(lights.count))
    return out


def band_tables(cfg, state, scene, time_x: float, y0: int, rows: int):
    """The frame tables of rows [y0, y0 + rows) of `cfg`'s grid, as the slab
    path packs a slab's (parallel/shard_render.Slab: the global grid, the
    band's first row)."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.parallel.shard_render import Slab
    r = VolumetricRenderer(dataclasses.replace(
        cfg, volume_height=rows, image_height=8 * rows))
    slab = Slab(y0=float(y0), halo=0, grid_global=cfg.grid,
                image_height_global=cfg.image_height)
    return r.frame_tables(state, scene, time_x, slab)[0]


# The band holds of the crossing paths: rows [WIDE_BAND[0], + WIDE_BAND[1])
# of the grid, a multiple of ss = 4 from row 0 (the band's low rows are the
# grid's), compared on its rows WIDE_BAND[2] or more from either edge (past
# the reprojection's +-4 rows and its tent, and the low tent's clamp)
WIDE_BAND = (64, 32, 10)
# The crossing paths: the grid of deep_fused and its image; many_suns_wide's
# 520 suns, 104 copies of many_suns_scene's 5; vis_wide's 32,912 local
# lights, 2057 copies of benchmark_scene's 16; k3_wide's two K3 grids
DEEP = dict(volume_width=16, volume_height=9, volume_depth=65664,
            image_width=128, image_height=72)
WIDE_SUN_COPIES = (5, 104)
WIDE_LIGHT_COPIES = 2057
K3_WIDE_GRIDS = {"planes": (1024, 1024, 520), "rows": (8, 65600, 16)}


def frame_hooks() -> tuple:
    """(module, attribute, kernel source) of each place a frame calls a
    kernel's wrapper: the fused frame's volume phase (ops/frame_fused) and
    the staged, history and shadow-map frames' passes (renderer, pipeline,
    which import the wrappers by name)."""
    import importlib
    from volumetricrenderer_tpu_torch import pipeline
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    rmod = importlib.import_module("volumetricrenderer_tpu_torch.renderer")
    return ((ff, "bake_radiance", "bake_radiance"),
            (ff, "bake_visibility", "bake_visibility"),
            (ff, "shadow_scatter", "shadow_scatter"),
            (ff, "integrate_blend", "integrate_blend"),
            (rmod, "dir_shadow_blend", "shadow_blend"),
            (rmod, "integrate_blend", "integrate_blend"),
            (pipeline, "bake_radiance", "bake_radiance"),
            (pipeline, "bake_visibility", "bake_visibility"),
            (pipeline, "scatter_local", "scatter"),
            (pipeline, "raycast_dir_shadow", "dir_shadow"),
            (pipeline, "accumulate_kernel", "integrate"),
            (pipeline, "temporal_blend", "temporal_blend"),
            (pipeline, "windowed_warp", "windowed_warp"),
            (pipeline, "pcf_shadow", "pcf_shadow"))


def drive_wide(name, renderer, scene, colour, depth, frames, expect,
               forms, cuda, shadow_data=None):
    """Render crossing path `name` from a fresh state, its launch counters
    set to 0 just before and read just after: exactly the kernels of
    `expect` ({kernel: launches per frame}) each frame, and the index forms
    `forms` ({source: (narrow, wide)} over the run). Records the last
    frame's call of each kernel of frame_hooks, and under "calls" every
    call of the last frame in order, (kernel, args, output). shadow_data:
    the shadow maps, baked once. Returns (image, the state before the last
    frame, {kernel: (args, output)}, seconds, peak GiB)."""
    hooks = frame_hooks()
    real = {(mod, attr): getattr(mod, attr) for mod, attr, _ in hooks}
    rec = {}

    def recorder(fn, kernel):
        def run(*args, **kw):
            out = fn(*args, **kw)
            rec[kernel] = (args, out)
            rec.setdefault("calls", []).append((kernel, args, out))
            return out
        return run

    state = renderer.init_state(scene.dir_lights.count)
    prev = None
    for mod, attr, kernel in hooks:
        setattr(mod, attr, recorder(real[(mod, attr)], kernel))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launches()
        before = {s: cuda.index_form_launches(s) for s in cuda.INDEX_SOURCES}
        t0 = time.perf_counter()
        for i in range(frames):
            prev = None  # the state before the last frame only
            rec.clear()  # the last frame's calls only
            img, _, new = renderer.render_frame(state, scene, 0.1 * i,
                                                colour, depth, shadow_data)
            prev, state = state, new
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    got_forms = {s: f for s, f in index_deltas(cuda, before).items()
                 if any(f)}
    std = float(img[..., :3].std())
    log(f"# {name}: {frames} frames in {secs:.1f} s (host wall, first "
        f"frames: the kernels' first launches at these shapes), peak device "
        f"memory {peak:.2f} GiB; launches {json.dumps(launches)}; index "
        f"forms (narrow, wide) {json.dumps(got_forms)}; image "
        f"{tuple(img.shape)} checksum {float(img.sum(dtype=torch.float32))!r}"
        f" std {std:.4g}")
    want = {k: frames * v for k, v in expect.items()}
    if launches != want or got_forms != forms:
        raise AssertionError(f"{name}: launches {launches} and index forms "
                             f"{got_forms}, not {want} and {forms}")
    if not bool(torch.isfinite(img).all()) or not std > 1e-4:
        raise AssertionError(f"{name}: a non-finite or flat image")
    return img, prev, rec, secs, peak


def wide_row(kernel, mode, fn, n, work, err, plain_ms, launches, hold):
    """A crossing path's row of the kernels line: fn timed (CUDA events
    behind a spin, n launches after a warm one), the bound of `work`, the
    largest difference of its holds, the plain time of what they held."""
    ms = kernel_time_ms(fn, n)
    b_ms, b_by = bound(*work)
    plain = "not timed" if plain_ms is None else f"{plain_ms:.3f} ms"
    log(f"# {kernel}, {mode}: {ms:.4f} ms/launch, bound {b_ms:.4f} ms by "
        f"{b_by} ({work[0] / 1e9:.2f} GB, {work[1] / 1e12:.3f} TFLOP), max "
        f"abs err {err:.3e} ({hold}), plain {plain}, launches {launches}")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "plain_on": hold, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def timed_plain(fn):
    """fn's result and its host time in ms, synchronised: a twin's time on
    a crossing path."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def forms_of(cuda, fn):
    """fn's result and the (narrow, wide) launches of each source of
    cuda.INDEX_SOURCES that it made."""
    before = {s: cuda.index_form_launches(s) for s in cuda.INDEX_SOURCES}
    out = fn()
    torch.cuda.synchronize()
    return out, {s: f for s, f in index_deltas(cuda, before).items()
                 if any(f)}


def band_hold(name, got, want, rows, label):
    """Hold band rows of a kernel's output [C, D, H, W] against the twin
    computed on the band alone [C, D, rows[1], W], on the band's rows
    rows[2] or more from its edges; returns the max abs error."""
    y0, hb, m = rows
    return compare(name, got[:, :, y0 + m:y0 + hb - m].contiguous(),
                   want[:, :, m:hb - m].contiguous(),
                   label=f"{label}, band rows {y0 + m}-{y0 + hb - m - 1}")


def wide_paths(cfg, scene, renderer, renderers, scene_color, view_depth,
               cuda) -> dict:
    """The crossing paths, each through the entry point past the narrow
    forms' limits, with every other kernel of the fused frame through to
    K4:
      deep_fused      FULL_CONFIG at 16x9x65664 froxels (ss=4), 128x72: K2
                      past 65535 slices (two parts of its launch grid), K1,
                      K3's 65664-slice walk and K4 narrow; 2 frames, each
                      kernel held against its twin on the whole grid;
      many_suns_wide  FULL_CONFIG on benchmark_scene with 520 suns, 104
                      copies of many_suns_scene's 5: K2's [520, 128, 135,
                      240] histories past 2^31 floats (its general wide
                      form); 2 frames; the history by replication (each
                      copy = the narrow form's on the 5-sun scene, bit for
                      bit), the scatter planes and the history on a band of
                      rows against the twin on the band's tables;
      vis_wide        fused_vis (K9 + K2's baked form) with 32,912 local
                      lights, 2057 faded copies of the 16 (replicate): the
                      [32912, 32, 34, 60] visibility volume past 2^31
                      floats (K9 and K2 wide); 2 frames; K9's volume by
                      replication, K2's scatter on a band of rows against
                      the twin (its per-light loop over the band, each
                      light's visibility upsampled in turn), its history
                      against the twin;
      k3_wide         K3 alone past both of its edges, on
                      many_suns_wide's scatter planes and accumulation
                      resampled to the grid: [4, 520, 1024, 1024] planes
                      past 2^31 floats (the twin on a band of rows) and
                      65600 froxel rows (two parts; the whole grid's twin);
                      each beside the narrow form on a band's tables, bit
                      for bit.
    The 1080p paths composite over benchmark_scene's G-buffer
    (scene_color, view_depth). Returns {(kernel, mode): row of the kernels
    line}."""
    from volumetricrenderer_tpu_torch import (VolumetricRenderer,
                                              benchmark_scene, froxel)
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import integrate as integ
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    from volumetricrenderer_tpu_torch.state import FrameState
    rows = {}
    t_phase = time.perf_counter()

    # deep_fused
    d_cfg = dataclasses.replace(cfg, **DEEP)
    d_r = VolumetricRenderer(d_cfg)
    d_scene = benchmark_scene(aspect=DEEP["image_width"]
                              / DEEP["image_height"], num_local_lights=16,
                              noise_mode="procedural")
    d_col, d_dep = d_r.render_scene_inputs(d_scene)
    img, prev, rec, _, _ = drive_wide(
        "deep_fused", d_r, d_scene, d_col, d_dep, 2,
        {"bake_radiance": 1, "shadow_scatter": 1, "integrate_blend": 1,
         "composite": 1},
        {"shadow_scatter": (0, 2), "integrate_blend": (2, 0)}, cuda)
    (t, p_sh, bake, _), (sh, sc) = rec["shadow_scatter"]
    parts = cuda.grid_parts(t.grid_whd[2])
    log(f"# deep_fused: K2's launch grid in {len(parts)} parts {parts}")
    t0 = time.perf_counter()
    want = ff.shadow_scatter_plain(t, p_sh, bake)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(compare("shadow_scatter", g, w_, label=f"deep_fused, {part}")
              for g, w_, part in zip((sh, sc), want, ("history", "planes")))
    del want
    compare("bake_radiance", rec["bake_radiance"][1],
            ff.bake_radiance_plain(rec["bake_radiance"][0][0]),
            label="deep_fused")
    (t3, sc3, acc3), out3 = rec["integrate_blend"]
    t0 = time.perf_counter()
    want = ff.integrate_blend_plain(t3, sc3, acc3)
    torch.cuda.synchronize()
    plain3_ms = 1e3 * (time.perf_counter() - t0)
    err3 = compare("integrate_blend", out3, want,
                   label="deep_fused (narrow: 65664 slices a block)")
    del want
    rows[("shadow_scatter", "wide_deep_fused")] = wide_row(
        "shadow_scatter", "wide_deep_fused",
        lambda: ff.shadow_scatter(t, p_sh, bake), 5,
        fused_work(t, "shadow_scatter"), err, plain_ms, 2,
        "the whole grid's twin")
    rows[("integrate_blend", "narrow_deep_fused")] = wide_row(
        "integrate_blend", "narrow_deep_fused",
        lambda: ff.integrate_blend(t3, sc3, acc3), 3,
        fused_work(t3, "integrate_blend"), err3, plain3_ms, 2,
        "the whole grid's twin")
    del img, prev, rec, t, p_sh, bake, sh, sc, t3, sc3, acc3, out3, d_col
    torch.cuda.empty_cache()
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: deep_fused")

    # many_suns_wide
    base, copies = WIDE_SUN_COPIES
    scn5 = many_suns_scene(scene, base, 1)
    scn = dataclasses.replace(scn5, dir_lights=replicate(scn5.dir_lights,
                                                         copies))
    img, prev, rec, _, _ = drive_wide(
        "many_suns_wide", renderer, scn, scene_color, view_depth, 2,
        {"bake_radiance": 1, "shadow_scatter": 1, "integrate_blend": 1,
         "composite": 1},
        {"shadow_scatter": (0, 2), "integrate_blend": (2, 0)}, cuda)
    (t, p_sh, bake, _), (sh, sc) = rec["shadow_scatter"]
    nd = t.n_dir
    log(f"# many_suns_wide: {nd} suns, [{nd}, 128, 135, 240] histories = "
        f"{sh.numel()} floats (past 2^31 - 1: {sh.numel() > 2 ** 31 - 1})")
    if sh.numel() <= 2 ** 31 - 1:
        raise AssertionError("many_suns_wide does not pass 2^31 floats")
    # replication: each copy's history = the narrow form's on the 5 suns
    t5 = renderer.frame_tables(prev, scn5, 0.1)[0]
    sh5, _ = ff.shadow_scatter(t5, p_sh[:base].contiguous(), bake,
                               form="narrow")
    same = all(torch.equal(sh[c * base:(c + 1) * base], sh5)
               for c in range(copies))
    log(f"# many_suns_wide, replication hold: each of the {copies} copies' "
        f"{base} histories = the narrow form's on the {base}-sun scene bit "
        f"for bit: {same}")
    if not same:
        raise AssertionError("many_suns_wide: a copy's history differs from "
                             "the narrow form's")
    del sh5
    tb = band_tables(cfg, prev, scn, 0.1, *WIDE_BAND[:2])
    y0, hb, _ = WIDE_BAND
    t0 = time.perf_counter()
    want = ff.shadow_scatter_plain(tb, p_sh[:, :, y0:y0 + hb].contiguous(),
                                   ff.bake_radiance_plain(tb))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(band_hold("shadow_scatter", g, w_, WIDE_BAND,
                        f"many_suns_wide {part}")
              for g, w_, part in zip((sh, sc), want, ("history", "planes")))
    del want
    (t3, sc3, acc3), out3 = rec["integrate_blend"]
    compare("integrate_blend", out3, ff.integrate_blend_plain(t3, sc3, acc3),
            label="many_suns_wide (narrow)")
    k3_src = (sc3, acc3)  # k3_wide's inputs, resampled
    rows[("shadow_scatter", "wide_many_suns")] = wide_row(
        "shadow_scatter", "wide_many_suns",
        lambda: ff.shadow_scatter(t, p_sh, bake), 3,
        fused_work(t, "shadow_scatter"), err, plain_ms, 2,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    del img, prev, rec, t, p_sh, bake, sh, sc, t3, sc3, acc3, out3, tb
    torch.cuda.empty_cache()
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: many_suns_wide")

    # vis_wide: the copies faded (replicate), as an fp32 sum of 32,912
    # equal terms drifts past the arm's tolerance between the kernel and its
    # twin in any order; the last copies, whose visibility planes lie past
    # 2^31 floats, dominate each froxel's sum
    v_r = renderers["fused_vis"]
    scn = dataclasses.replace(
        scene, point_lights=replicate(scene.point_lights, WIDE_LIGHT_COPIES,
                                      fade=True),
        spot_lights=replicate(scene.spot_lights, WIDE_LIGHT_COPIES,
                              fade=True))
    img, prev, rec, _, _ = drive_wide(
        "vis_wide", v_r, scn, scene_color, view_depth, 2,
        {"bake_visibility": 1, "shadow_scatter": 1, "integrate_blend": 1,
         "composite": 1},
        {"bake_visibility": (0, 2), "shadow_scatter": (0, 2),
         "integrate_blend": (2, 0)}, cuda)
    (t9,), v9 = rec["bake_visibility"]
    (t, p_sh, _, vol), (sh, sc) = rec["shadow_scatter"]
    n_l = t.lights.shape[0]
    log(f"# vis_wide: {n_l} lights, the [{n_l}, DL, HL, WL] visibility "
        f"volume {tuple(v9.shape)} = {v9.numel()} floats (past 2^31 - 1: "
        f"{v9.numel() > 2 ** 31 - 1})")
    if v9.numel() <= 2 ** 31 - 1 or vol is not v9:
        raise AssertionError("vis_wide does not pass 2^31 floats, or K2 "
                             "did not read K9's volume")
    # replication: each copy's visibility = the narrow form's on the 16
    t16 = v_r.frame_tables(prev, scene, 0.1)[0]
    v16 = vis.bake_visibility(t16, form="narrow")
    n_pt = scene.point_lights.count
    parts_ = ((v9[:n_pt * WIDE_LIGHT_COPIES], v16[:n_pt]),
              (v9[n_pt * WIDE_LIGHT_COPIES:], v16[n_pt:]))
    same = all(torch.equal(a.view(WIDE_LIGHT_COPIES, *b.shape),
                           b.expand(WIDE_LIGHT_COPIES, *b.shape))
               for a, b in parts_)
    log(f"# vis_wide, replication hold: each of the {WIDE_LIGHT_COPIES} "
        f"copies' 16 visibility planes = the narrow form's on the 16-light "
        f"scene bit for bit: {same}")
    if not same:
        raise AssertionError("vis_wide: a copy's visibility differs from the "
                             "narrow form's")
    # K2's history against the twin on the whole grid (one sun); its
    # scatter planes on a band of rows: the twin's own per-light loop
    # (scatter.scatter_slice, as scatter_local_plain runs it) over the
    # band's tables, each light's visibility upsampled when the loop reads
    # it (the twin upsamples all 32,912 at once: 97 GB at this band)
    err_sh = compare("shadow_scatter", sh,
                     sb.dir_shadow_blend_plain(t, p_sh),
                     label="vis_wide, history")
    tb = band_tables(v_r.config, prev, scn, 0.1, *WIDE_BAND[:2])
    y0, hb, _ = WIDE_BAND
    ly0, lhb = y0 // tb.ss, tb.low_dims[1]
    v_band = v9[:, :, ly0:ly0 + lhb]
    zs = torch.arange(tb.grid_whd[2], device="cuda")[:, None, None]

    # the lights of colour 0 (faded past float32's range) add +0 to every
    # sum: the loop leaves them out, and its result is the same
    keep = (tb.lights[:, 3:6] != 0).any(dim=1).nonzero()[:, 0]

    class Upsampled:
        def __getitem__(self, li):
            lj = int(keep[li])
            return vis.upsample_low(v_band[lj:lj + 1].contiguous(), zs,
                                    tb.ss, tb.tent_x, tb.tent_y)[0]

    t0 = time.perf_counter()
    blended = sb.dir_shadow_blend_plain(
        tb, p_sh[:, :, y0:y0 + hb].contiguous())
    active = sca.schedule_mask(tb.order, tb.count).T[:, :, None, None]
    local = (tb.lights[keep], active[keep], tb.planes, tb.spheres, tb.boxes,
             tb.occluders(local=True), Upsampled())
    want = torch.stack(sca.scatter_slice(
        tb.spar, tb.dirs, tb.med, tb.media_static, zs, list(blended), None,
        None, grid_whd=tb.grid_whd, n_dir=tb.n_dir, h_glob=tb.h_glob,
        jitter_dir=tb.jitter_dir, local=local))
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(err_sh, band_hold("shadow_scatter", sc, want, WIDE_BAND,
                                "vis_wide planes"))
    del want, blended
    # the narrow form on the band's tables (its [NL, DL, 8, WL] visibility
    # under 2^31 floats) beside the wide form's rows
    _, nb = ff.shadow_scatter(tb, p_sh[:, :, y0:y0 + hb].contiguous(),
                              vis=v_band.contiguous(), form="narrow")
    m = WIDE_BAND[2]
    d_nb = (nb[:, :, m:hb - m] - sc[:, :, y0 + m:y0 + hb - m]).abs()
    same = bool((d_nb == 0).all())
    log(f"# vis_wide planes, band rows {y0 + m}-{y0 + hb - m - 1}: the "
        f"narrow form on the band's tables = the wide form's rows bit for "
        f"bit: {same} (max |diff| {float(d_nb.max()):.3e}); the twin's loop "
        f"over the band's {len(keep)} lights of colour > 0 {plain_ms:.1f} ms")
    if not same:
        raise AssertionError("vis_wide: the wide form's rows differ from the "
                             "narrow form's on the band")
    del nb, d_nb
    rows[("bake_visibility", "wide_vis")] = wide_row(
        "bake_visibility", "wide_vis", lambda: vis.bake_visibility(t9), 3,
        fused_work(t9, "bake_visibility"), 0.0, None, 2,
        "replication: each copy = the narrow form's planes bit for bit; "
        "the twin's per-light loop over 32,912 lights not run")
    rows[("shadow_scatter", "wide_vis")] = wide_row(
        "shadow_scatter", "wide_vis",
        lambda: ff.shadow_scatter(t, p_sh, vis=vol), 1,
        fused_work(t, "shadow_scatter", "baked"), err, plain_ms, 2,
        f"the twin's loop on band rows {y0}-{y0 + hb - 1}")
    del img, prev, rec, t9, v9, t, p_sh, vol, sh, sc, v16, parts_, v_band, tb
    torch.cuda.empty_cache()
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: vis_wide")

    # k3_wide: K3 alone past each of its edges, on many_suns_wide's last
    # scatter planes and accumulation resampled (trilinear) to the grid: a
    # real frame's smooth volumes, whose reprojection taps cross cell
    # boundaries as a frame's do
    moved = froxel.invert_rigid(orbit(scene, 1).camera.view_to_world().cpu())
    for what, grid in K3_WIDE_GRIDS.items():
        w, h, d = grid
        k_cfg = dataclasses.replace(cfg, volume_width=w, volume_height=h,
                                    volume_depth=d)
        k_r = VolumetricRenderer(k_cfg)
        st = FrameState(prev_shadow=torch.empty(0),
                        prev_accumulation=torch.empty(0),
                        prev_world_to_view=moved, frame_count=1)
        t = k_r.frame_tables(st, scene, 0.1)[0]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sc, acc = (torch.nn.functional.interpolate(
            v[None], size=(d, h, w), mode="trilinear",
            align_corners=True)[0].contiguous() for v in k3_src)
        form = ff.k3_form(t)
        cuda.reset_launches()
        before = {s: cuda.index_form_launches(s) for s in cuda.INDEX_SOURCES}
        out = ff.integrate_blend(t, sc, acc)
        torch.cuda.synchronize()
        forms = {s: f for s, f in index_deltas(cuda, before).items()
                 if any(f)}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"# k3_wide, {what}: K3 on [4, {d}, {h}, {w}] = {sc.numel()} "
            f"floats a volume, {h} rows ({len(cuda.grid_parts(h))} parts of "
            f"the launch grid's y axis in the wide form), form {form}, "
            f"index forms (narrow, wide) {json.dumps(forms)}, peak device "
            f"memory {peak:.2f} GiB")
        if form != "wide" or forms != {"integrate_blend": (0, 1)}:
            raise AssertionError(f"k3_wide {what}: K3 took {forms}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"k3_wide {what}: non-finite output")
        # a band of rows (K3 reads rows +-1 and the warp's +-5): the narrow
        # form on the band's tables = the wide form's rows bit for bit, and
        # the twin, on the band ("planes") or on the whole grid ("rows")
        band = (h // 8 * 4, 32, 6)
        y0, hb, m = band
        tb = band_tables(k_cfg, st, scene, 0.1, y0, hb)
        b_in = [v[:, :, y0:y0 + hb].contiguous() for v in (sc, acc)]
        nb = ff.integrate_blend(tb, *b_in, form="narrow")
        same = torch.equal(nb[:, :, m:hb - m], out[:, :, y0 + m:y0 + hb - m])
        log(f"# k3_wide, {what}, band rows {y0 + m}-{y0 + hb - m - 1}: the "
            f"narrow form on the band's tables = the wide form's rows bit "
            f"for bit: {same}")
        if not same:
            raise AssertionError(f"k3_wide {what}: the wide form's rows differ "
                                 "from the narrow form's on the band")
        del nb
        t0 = time.perf_counter()
        if what == "rows":
            hold = "the whole grid's twin"
            err = compare("integrate_blend", out,
                          ff.integrate_blend_plain(t, sc, acc),
                          label=f"k3_wide {what}")
        else:
            hold = f"the twin on band rows {y0}-{y0 + hb - 1}"
            err = band_hold("integrate_blend", out,
                            ff.integrate_blend_plain(tb, *b_in), band,
                            f"k3_wide {what}")
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        del out, b_in
        rows[("integrate_blend", f"wide_{what}")] = wide_row(
            "integrate_blend", f"wide_{what}",
            lambda: ff.integrate_blend(t, sc, acc), 3,
            fused_work(t, "integrate_blend"), err, plain_ms, 1, hold)
        del sc, acc, t
        torch.cuda.empty_cache()
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: k3_wide")

    # k8_wide: K8 alone past 2^31 floats, on k3_wide's resampled planes
    t_path = time.perf_counter()
    w, h, d = K3_WIDE_GRIDS["planes"]
    k_cfg = dataclasses.replace(cfg, volume_width=w, volume_height=h,
                                volume_depth=d)
    st = FrameState(prev_shadow=torch.empty(0),
                    prev_accumulation=torch.empty(0),
                    prev_world_to_view=moved, frame_count=1)
    t = VolumetricRenderer(k_cfg).frame_tables(st, scene, 0.1)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc = torch.nn.functional.interpolate(
        k3_src[0][None], size=(d, h, w), mode="trilinear",
        align_corners=True)[0].contiguous()
    form = integ.k8_form(t)
    cuda.reset_launches()
    before = {s_: cuda.index_form_launches(s_) for s_ in cuda.INDEX_SOURCES}
    out = integ.accumulate(t, sc)
    torch.cuda.synchronize()
    forms = {s_: f for s_, f in index_deltas(cuda, before).items() if any(f)}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"# k8_wide: K8 on [4, {d}, {h}, {w}] = {sc.numel()} floats a "
        f"volume, form {form}, index forms (narrow, wide) "
        f"{json.dumps(forms)}, peak device memory {peak:.2f} GiB")
    if form != "wide" or forms != {"integrate": (0, 1)}:
        raise AssertionError(f"k8_wide: K8 took {forms}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("k8_wide: non-finite output")
    # a band of rows (K8 reads rows +-1): the narrow form on the band's
    # tables = the wide form's rows bit for bit, and the twin on the band
    band = (h // 8 * 4, 32, 6)
    y0, hb, m = band
    tb = band_tables(k_cfg, st, scene, 0.1, y0, hb)
    b_in = sc[:, :, y0:y0 + hb].contiguous()
    nb = integ.accumulate(tb, b_in, form="narrow")
    same = torch.equal(nb[:, :, m:hb - m], out[:, :, y0 + m:y0 + hb - m])
    log(f"# k8_wide, band rows {y0 + m}-{y0 + hb - m - 1}: the narrow form "
        f"on the band's tables = the wide form's rows bit for bit: {same}")
    if not same:
        raise AssertionError("k8_wide: the wide form's rows differ from the "
                             "narrow form's on the band")
    t0 = time.perf_counter()
    want = integ.accumulate_plain(tb, b_in)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = band_hold("integrate", out, want, band, "k8_wide")
    del out, nb, want, b_in
    rows[("integrate", "wide_planes")] = wide_row(
        "integrate", "wide_planes", lambda: integ.accumulate(t, sc), 3,
        fused_work(t, "integrate"), err, plain_ms, 1,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    del sc, t, tb
    torch.cuda.empty_cache()
    log(f"# k8_wide: {time.perf_counter() - t_path:.1f} s")
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: k8_wide")
    rows.update(k10_k11_wide(cfg, scene, k3_src, moved, cuda, t_phase))
    del k3_src
    rows.update(staged_wide_paths(cfg, scene, renderers, scene_color,
                                  view_depth, cuda, t_phase))
    rows.update(history_map_wide_paths(cfg, scene, scene_color, view_depth,
                                       cuda, t_phase))
    return rows


# The C12 hold's term count: u = 2^-24, the unit roundoff of float32
UNIT_ROUNDOFF = 2.0 ** -24


def gamma(k):
    """gamma_k = k u / (1 - k u) (Higham): an fp32 sum of k + 1 terms
    differs from the exact sum by at most gamma_k times the sum of the
    terms' magnitudes, in any order."""
    return k * UNIT_ROUNDOFF / (1.0 - k * UNIT_ROUNDOFF)


def c12_hold(tb, sh_band, v_band, held, m, sca, vis) -> tuple:
    """ROADMAP C12: the baked in-scatter over thousands of equal lights,
    held without fading against an fp64 reference on a band's tables tb
    (its blended shadow sh_band, its visibility v_band). The lights fall
    into classes of equal table rows and schedule columns (the copies of
    one light; a copy's packed colour may round differently by an ulp
    where the host packs it), each class's visibility equal (checked). The
    reference: the twin's own term t_k of each class's first light
    (scatter.scatter_slice over that light alone, no sun: 0 + t_k = t_k)
    and its sun terms s (no local light), summed in float64 as s + sum_k
    count_k t_k. The fp32 twin: the same terms added in float32 in the
    twin's order (ascending light index, then the sun), checked bit for bit
    against the twin's own loop over the first 32 lights. On the band's
    rows m or more from its edges, each of `held` ({label: planes [>= 3,
    D, hb - 2 m, W]}) and the fp32 twin must lie within, per element,
    gamma_(n-1) x (|s| + sum_k count_k |t_k|) + atol + rtol |s|: n the
    terms its slice sums (its scheduled lights and the suns), atol and
    rtol K6's CHECKS tolerance on the non-light (sun) terms. Returns
    ({label: worst ratio of |err| to the bound}, {label: largest |err|},
    seconds of the reference and the twin)."""
    t0 = time.perf_counter()
    w, hb, d = tb.grid_whd
    dev = sh_band.device
    zs = torch.arange(d, device=dev)[:, None, None]
    nl = tb.lights.shape[0]
    active = sca.schedule_mask(tb.order, tb.count).T           # [NL, D]
    key = torch.cat([tb.lights, active.to(tb.lights.dtype)], dim=1)
    _, cls = torch.unique(key, dim=0, return_inverse=True)
    n_cls = int(cls.max()) + 1
    first = torch.full((n_cls,), nl, dtype=torch.long, device=dev)
    first = first.scatter_reduce(0, cls, torch.arange(nl, device=dev),
                                 "amin")
    count = torch.bincount(cls, minlength=n_cls)
    for a in range(0, nl, 4096):  # each light sees its class's visibility
        b = min(nl, a + 4096)
        if not torch.equal(v_band[a:b], v_band[first[cls[a:b]]]):
            raise AssertionError("C12: one class's visibility differs")
    n_loop = min(32, nl)
    rows = torch.unique(torch.cat([first, torch.arange(n_loop, device=dev)]))
    at_row = {int(r): j for j, r in enumerate(rows.tolist())}
    up = vis.upsample_low(v_band[rows].contiguous(), zs, tb.ss, tb.tent_x,
                          tb.tent_y)
    act = active[:, :, None, None]

    def twin(lights, n_dir):
        ix = torch.tensor(lights, dtype=torch.long, device=dev)
        return torch.stack(sca.scatter_slice(
            tb.spar, tb.dirs, tb.med, tb.media_static, zs, list(sh_band),
            None, None, grid_whd=tb.grid_whd, n_dir=n_dir, h_glob=tb.h_glob,
            jitter_dir=tb.jitter_dir,
            local=(tb.lights[ix], act[ix], tb.planes, tb.spheres, tb.boxes,
                   tb.occluders(local=True),
                   up[[at_row[i] for i in lights]]))[:3])

    terms = [twin([int(f)], 0) for f in first.tolist()]
    sun = twin([], tb.n_dir)
    inner = lambda v: v[:, :, m:hb - m]
    tt = torch.stack(terms).double()
    cnt = count.double()[:, None, None, None, None]
    ref = inner(sun.double() + (cnt * tt).sum(0))
    mag = inner(sun.double().abs() + (cnt * tt.abs()).sum(0))
    del tt
    n_terms = (active.sum(0) + tb.n_dir).double()
    atol, rtol = CHECKS["scatter"][:2]
    bound = gamma((n_terms - 1).clamp(min=0))[None, :, None, None] * mag \
        + atol + rtol * inner(sun.double().abs())
    # the twin's fp32 sum: its own loop over the first lights, then every
    # light's class term in the table's order, the sun last
    acc = torch.zeros_like(sun)
    for i, c in enumerate(cls.tolist()):
        if i == n_loop and not torch.equal(twin(list(range(n_loop)), 0),
                                           acc):
            raise AssertionError("C12: the twin's loop over the first "
                                 "lights differs from their terms added "
                                 "in turn")
        acc = acc + terms[c]
    twin32 = inner(acc + sun)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ratios, errs = {}, {}
    for label, planes in {"the fp32 twin": twin32, **held}.items():
        err = (planes[:3].double() - ref).abs()
        ratio = err / bound
        ratios[label] = float(ratio.max())
        errs[label] = float(err.max())
        at = tuple(int(v) for v in torch.unravel_index(ratio.argmax(),
                                                       ratio.shape))
        rel = float((err / ref.abs().clamp(min=1e-30)).max())
        log(f"# C12, {label}: max |err| against the fp64 reference "
            f"{errs[label]:.4e}, relative {rel:.4e}; worst |err| / bound "
            f"{ratios[label]:.4e} at {at} (bound {float(bound[at]):.4e}, "
            f"|reference| {float(ref[at].abs()):.4e}, "
            f"{int(n_terms[at[1]])} terms)")
    log(f"# C12: the bound gamma_(n-1) x sum |t_i| + {atol:g} + {rtol:g} "
        f"|sun|, n from {int(n_terms.min())} to {int(n_terms.max())} terms "
        f"a froxel (gamma_(n-1) up to "
        f"{float(gamma(n_terms.max() - 1)):.4e}), median bound "
        f"{float(bound.median()):.4e}; {nl} lights in {n_cls} classes of "
        f"equal rows ({int(count.min())}-{int(count.max())} lights each), "
        f"{n_cls + 1} twin runs and {nl} fp32 adds, {secs:.2f} s")
    if max(ratios.values()) > 1.0:
        raise AssertionError(f"C12: past the gamma bound: {ratios}")
    return ratios, errs, secs


def staged_wide_paths(cfg, scene, renderers, scene_color, view_depth, cuda,
                      t_phase) -> dict:
    """The staged frame's crossing paths, each through the entry point past
    the narrow forms' limits, with every other kernel of its frame through
    to K4:
      deep_staged            STAGED at 16x9x65664 froxels (DEEP), 2
                             frames: K5 and K6 past 65535 slices (two
                             parts of their launch grids), K1, K3 and K4
                             narrow; then one no_shadow_blend frame at the
                             same grid, where K7 crosses; each kernel held
                             against its twin on the whole grid;
      many_suns_staged_wide  STAGED with 520 suns (104 copies of
                             many_suns_scene's 5), 2 frames: K5's [520,
                             128, 135, 240] histories past 2^31 floats, K6's
                             general wide form reading them; each copy's
                             history = the narrow form's on the 5-sun scene
                             bit for bit, the histories and the planes on a
                             band of rows against the twin on the band's
                             tables; K7 once on the same tables (the same
                             replication hold, the twin on the band);
      vis_bake_wide          VIS_BAKE with 32,912 local lights, 2057 equal
                             copies of the 16, unfaded, 2 frames: K9's and
                             K6's baked wide forms; K9 by replication, K5
                             against the twin; K6's planes = the narrow form
                             on a band's tables bit for bit; K2's baked wide
                             form once on the same tables (= K5 then K6 bit
                             for bit); and C12's fp64 hold (c12_hold) of
                             K6's and K2's planes and the fp32 twin.
    Returns {(kernel, mode): row of the kernels line}."""
    from volumetricrenderer_tpu_torch import (VolumetricRenderer,
                                              benchmark_scene)
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    rows = {}
    timed = timed_plain

    def done(name, t_path):
        log(f"# {name}: {time.perf_counter() - t_path:.1f} s")
        log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f}"
            f" s: {name}")

    # deep_staged
    t_path = time.perf_counter()
    d_cfg = dataclasses.replace(cfg, **STAGED, **DEEP)
    d_r = VolumetricRenderer(d_cfg)
    d_scene = benchmark_scene(aspect=DEEP["image_width"]
                              / DEEP["image_height"], num_local_lights=16,
                              noise_mode="procedural")
    d_col, d_dep = d_r.render_scene_inputs(d_scene)
    _, _, rec, _, _ = drive_wide(
        "deep_staged", d_r, d_scene, d_col, d_dep, 2,
        {k: 1 for k in STAGED_KERNELS},
        {"shadow_blend": (0, 2), "scatter": (0, 2),
         "integrate_blend": (2, 0)}, cuda)
    (t, p_sh), sh = rec["shadow_blend"]
    (t6, sh6, bake, vol, mat), sc = rec["scatter"]
    parts = cuda.grid_parts(t.grid_whd[2])
    log(f"# deep_staged: K5's and K6's launch grids in {len(parts)} parts "
        f"{parts}")
    want, plain5 = timed(lambda: sb.dir_shadow_blend_plain(t, p_sh))
    err5 = compare("shadow_blend", sh, want, label="deep_staged")
    want, plain6 = timed(lambda: sca.scatter_local_plain(t6, sh6, bake, vol,
                                                         mat))
    err6 = compare("scatter", sc, want, label="deep_staged")
    compare("bake_radiance", rec["bake_radiance"][1],
            ff.bake_radiance_plain(rec["bake_radiance"][0][0]),
            label="deep_staged")
    (t3, sc3, acc3), out3 = rec["integrate_blend"]
    compare("integrate_blend", out3, ff.integrate_blend_plain(t3, sc3, acc3),
            label="deep_staged (narrow: 65664 slices a block)")
    del want, out3, sc3, acc3
    rows[("shadow_blend", "wide_deep_staged")] = wide_row(
        "shadow_blend", "wide_deep_staged",
        lambda: sb.dir_shadow_blend(t, p_sh), 5, fused_work(t, "shadow_blend"),
        err5, plain5, 2, "the whole grid's twin")
    rows[("scatter", "wide_deep_staged")] = wide_row(
        "scatter", "wide_deep_staged",
        lambda: sca.scatter_local(t6, sh6, bake, vol, mat), 5,
        fused_work(t6, "scatter"), err6, plain6, 2, "the whole grid's twin")
    del rec, t, p_sh, sh, t6, sh6, bake, vol, mat, sc
    # one no_shadow_blend frame at the same grid: K7 in two parts
    n_r = VolumetricRenderer(dataclasses.replace(
        d_cfg, temporal_blend_shadow=False))
    _, _, rec, _, _ = drive_wide(
        "deep_staged, no_shadow_blend", n_r, d_scene, d_col, d_dep, 1,
        {k: 1 for k in NO_SHADOW_BLEND_KERNELS},
        {"dir_shadow": (0, 1), "scatter": (0, 1), "integrate_blend": (1, 0)},
        cuda)
    (t7,), un = rec["dir_shadow"]
    want, plain7 = timed(lambda: ds.dir_shadow_plain(t7))
    err7 = compare("dir_shadow", un, want, label="deep_staged")
    rows[("dir_shadow", "wide_deep_staged")] = wide_row(
        "dir_shadow", "wide_deep_staged", lambda: ds.dir_shadow(t7), 5,
        fused_work(t7, "dir_shadow"), err7, plain7, 1,
        "the whole grid's twin")
    del rec, want, un, t7, d_col, d_dep
    torch.cuda.empty_cache()
    done("deep_staged", t_path)

    # many_suns_staged_wide
    t_path = time.perf_counter()
    base, copies = WIDE_SUN_COPIES
    scn5 = many_suns_scene(scene, base, 1)
    scn = dataclasses.replace(scn5, dir_lights=replicate(scn5.dir_lights,
                                                         copies))
    s_r = renderers["staged"]
    _, prev, rec, _, _ = drive_wide(
        "many_suns_staged_wide", s_r, scn, scene_color, view_depth, 2,
        {k: 1 for k in STAGED_KERNELS},
        {"shadow_blend": (0, 2), "scatter": (0, 2),
         "integrate_blend": (2, 0)}, cuda)
    (t, p_sh), sh = rec["shadow_blend"]
    (t6, sh6, bake, _, _), sc = rec["scatter"]
    nd = t.n_dir
    log(f"# many_suns_staged_wide: {nd} suns, [{nd}, 128, 135, 240] "
        f"histories = {sh.numel()} floats (past 2^31 - 1: "
        f"{sh.numel() > 2 ** 31 - 1}); K6 read K5's: {sh6 is sh}")
    if sh.numel() <= 2 ** 31 - 1 or sh6 is not sh:
        raise AssertionError("many_suns_staged_wide does not pass 2^31 "
                             "floats, or K6 did not read K5's histories")
    del rec
    # replication: each copy's history = the narrow form's on the 5 suns
    t5 = s_r.frame_tables(prev, scn5, 0.1)[0]
    p_sh5 = p_sh[:base].contiguous()
    sh5 = sb.dir_shadow_blend(t5, p_sh5, form="narrow")
    same = all(torch.equal(sh[c * base:(c + 1) * base], sh5)
               for c in range(copies))
    log(f"# many_suns_staged_wide, replication hold: each of the {copies} "
        f"copies' {base} histories = the narrow form's on the {base}-sun "
        f"scene bit for bit: {same}")
    if not same:
        raise AssertionError("many_suns_staged_wide: a copy's history "
                             "differs from the narrow form's")
    del sh5
    # the histories and the planes on a band of rows against the twin on
    # the band's tables (K6's on K5's band rows)
    y0, hb, _ = WIDE_BAND
    tb = band_tables(s_r.config, prev, scn, 0.1, *WIDE_BAND[:2])
    want, plain5 = timed(lambda: sb.dir_shadow_blend_plain(
        tb, p_sh[:, :, y0:y0 + hb].contiguous()))
    err5 = band_hold("shadow_blend", sh, want, WIDE_BAND,
                     "many_suns_staged_wide history")
    del want
    sh_band = sh[:, :, y0:y0 + hb].contiguous()
    want, plain6 = timed(lambda: sca.scatter_local_plain(
        tb, sh_band, ff.bake_radiance_plain(tb)))
    err6 = band_hold("scatter", sc, want, WIDE_BAND,
                     "many_suns_staged_wide planes")
    del want, sh_band
    rows[("shadow_blend", "wide_many_suns_staged")] = wide_row(
        "shadow_blend", "wide_many_suns_staged",
        lambda: sb.dir_shadow_blend(t, p_sh), 3, fused_work(t, "shadow_blend"),
        err5, plain5, 2, f"the twin on band rows {y0}-{y0 + hb - 1}")
    rows[("scatter", "wide_many_suns_staged")] = wide_row(
        "scatter", "wide_many_suns_staged",
        lambda: sca.scatter_local(t6, sh, bake), 3, fused_work(t6, "scatter"),
        err6, plain6, 2, f"the twin on band rows {y0}-{y0 + hb - 1}")
    del sc, bake, t6
    # K7 once on the same tables: the wide form past 2^31 floats, each copy
    # = the narrow form's on the 5 suns, the twin on the band
    del sh
    torch.cuda.empty_cache()
    un, forms = forms_of(cuda, lambda: ds.dir_shadow(t))
    un5 = ds.dir_shadow(t5, form="narrow")
    same = all(torch.equal(un[c * base:(c + 1) * base], un5)
               for c in range(copies))
    log(f"# many_suns_staged_wide, K7: [{nd}, 128, 135, 240] = "
        f"{un.numel()} floats, index forms (narrow, wide) "
        f"{json.dumps(forms)}; each of the {copies} copies = the narrow "
        f"form's on the {base}-sun scene bit for bit: {same}")
    if forms != {"dir_shadow": (0, 1)} or not same:
        raise AssertionError("many_suns_staged_wide: K7 took the narrow "
                             "form, or a copy differs from the narrow form's")
    del un5
    want, plain7 = timed(lambda: ds.dir_shadow_plain(tb))
    err7 = band_hold("dir_shadow", un, want, WIDE_BAND,
                     "many_suns_staged_wide K7")
    del want, un
    rows[("dir_shadow", "wide_many_suns_staged")] = wide_row(
        "dir_shadow", "wide_many_suns_staged", lambda: ds.dir_shadow(t), 3,
        fused_work(t, "dir_shadow"), err7, plain7, 1,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    del prev, t, p_sh, p_sh5, t5, tb
    torch.cuda.empty_cache()
    done("many_suns_staged_wide", t_path)

    # vis_bake_wide: 2057 equal copies of the 16 lights, unfaded
    t_path = time.perf_counter()
    v_r = renderers["vis_bake"]
    scn = dataclasses.replace(
        scene, point_lights=replicate(scene.point_lights, WIDE_LIGHT_COPIES),
        spot_lights=replicate(scene.spot_lights, WIDE_LIGHT_COPIES))
    _, prev, rec, _, _ = drive_wide(
        "vis_bake_wide", v_r, scn, scene_color, view_depth, 2,
        {"shadow_blend": 1, "bake_visibility": 1, "scatter": 1,
         "integrate_blend": 1, "composite": 1},
        {"bake_visibility": (0, 2), "scatter": (0, 2), "shadow_blend": (2, 0),
         "integrate_blend": (2, 0)}, cuda)
    (t9,), v9 = rec["bake_visibility"]
    (t, p_sh), sh = rec["shadow_blend"]
    (t6, sh6, _, vol, _), sc = rec["scatter"]
    n_l = t6.lights.shape[0]
    log(f"# vis_bake_wide: {n_l} lights, the visibility volume "
        f"{tuple(v9.shape)} = {v9.numel()} floats (past 2^31 - 1: "
        f"{v9.numel() > 2 ** 31 - 1}); K6 read K9's and K5's: "
        f"{vol is v9 and sh6 is sh}")
    if v9.numel() <= 2 ** 31 - 1 or vol is not v9 or sh6 is not sh:
        raise AssertionError("vis_bake_wide does not pass 2^31 floats, or "
                             "K6 did not read K9's volume and K5's history")
    del rec
    # K9 by replication: each copy = the narrow form's on the 16 lights
    n16 = scene.point_lights.count + scene.spot_lights.count
    t16 = v_r.frame_tables(prev, scene, 0.1)[0]
    v16 = vis.bake_visibility(t16, form="narrow")
    n_pt = scene.point_lights.count
    same = all(torch.equal(a.view(WIDE_LIGHT_COPIES, *b.shape),
                           b.expand(WIDE_LIGHT_COPIES, *b.shape))
               for a, b in ((v9[:n_pt * WIDE_LIGHT_COPIES], v16[:n_pt]),
                            (v9[n_pt * WIDE_LIGHT_COPIES:], v16[n_pt:])))
    log(f"# vis_bake_wide, replication hold: each of the "
        f"{WIDE_LIGHT_COPIES} copies' {n16} visibility planes = the narrow "
        f"form's on the {n16}-light scene bit for bit: {same}")
    if not same:
        raise AssertionError("vis_bake_wide: a copy's visibility differs "
                             "from the narrow form's")
    del v16, t16
    compare("shadow_blend", sh, sb.dir_shadow_blend_plain(t, p_sh),
            label="vis_bake_wide (narrow)")
    # K2's baked wide form once on the same tables: = K5 then K6
    (sh2, sc2), forms = forms_of(cuda,
                                 lambda: ff.shadow_scatter(t, p_sh, vis=vol))
    same = torch.equal(sh2, sh) and torch.equal(sc2, sc)
    log(f"# vis_bake_wide, K2 on the same tables: index forms (narrow, "
        f"wide) {json.dumps(forms)}; = K5 then K6 bit for bit: {same}")
    if forms != {"shadow_scatter": (0, 1)} or not same:
        raise AssertionError("vis_bake_wide: K2 did not take its wide form, "
                             "or differs from K5 then K6")
    del sh2
    # a band of rows: K6's narrow form on the band's tables = the wide
    # form's rows bit for bit; C12's fp64 hold of K6's and K2's rows
    y0, hb, m = WIDE_BAND
    tb = band_tables(v_r.config, prev, scn, 0.1, *WIDE_BAND[:2])
    ly0, lhb = y0 // tb.ss, tb.low_dims[1]
    v_band = v9[:, :, ly0:ly0 + lhb].contiguous()
    sh_band = sh[:, :, y0:y0 + hb].contiguous()
    nb = sca.scatter_local(tb, sh_band, None, v_band, form="narrow")
    d_nb = (nb[:, :, m:hb - m] - sc[:, :, y0 + m:y0 + hb - m]).abs()
    same = bool((d_nb == 0).all())
    log(f"# vis_bake_wide planes, band rows {y0 + m}-{y0 + hb - m - 1}: the "
        f"narrow form on the band's tables = the wide form's rows bit for "
        f"bit: {same} (max |diff| {float(d_nb.max()):.3e})")
    if not same:
        raise AssertionError("vis_bake_wide: the wide form's rows differ "
                             "from the narrow form's on the band")
    del nb, d_nb
    band_rows = lambda v: v[:, :, y0 + m:y0 + hb - m]
    held = {"K6's baked wide planes": band_rows(sc),
            "K2's baked wide planes": band_rows(sc2)}
    ratios, c12_errs, c12_s = c12_hold(tb, sh_band, v_band, held, m, sca,
                                       vis)
    del held, sc2, v_band, sh_band
    rows[("scatter", "wide_vis_bake")] = wide_row(
        "scatter", "wide_vis_bake",
        lambda: sca.scatter_local(t6, sh, None, vol), 1,
        fused_work(t6, "scatter", "baked"), c12_errs["K6's baked wide planes"],
        1e3 * c12_s, 2,
        f"C12: against the fp64 reference on band rows {y0 + m}-"
        f"{y0 + hb - m - 1} (the plain time: the reference and the fp32 "
        f"twin); |err| / its gamma bound at most {json.dumps(ratios)}")
    rows[("scatter", "wide_vis_bake")]["c12_ratios"] = ratios
    del prev, t, p_sh, sh, t6, sh6, vol, sc, v9, t9, tb
    torch.cuda.empty_cache()
    done("vis_bake_wide", t_path)
    return rows


def k10_k11_wide(cfg, scene, k3_src, moved, cuda, t_phase) -> dict:
    """K10's alpha mode and K11 alone past 2^31 floats, on k3_wide's
    [4, 520, 1024, 1024] planes: many_suns_wide's scatter planes and
    accumulation resampled to the grid (a real frame's smooth volumes). K10
    blends the accumulation into the planes with the blend table of a camera
    move (k3_wide's); K11 warps the accumulation at smooth targets whose
    offsets reach 4.5 cells (past the +-4 window's clip in places), on a
    1/256-cell lattice so that a band's targets less its first row are
    exact. Each takes its wide form; each equals the narrow form on a band's
    tables bit for bit (K10 given the band's y0, as a slab's table; K11 the
    band's targets) on the band's rows past the taps' reach, and is held
    against its twin there. Returns {(kernel, mode): row of the kernels
    line}."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import warp as wp
    from volumetricrenderer_tpu_torch.state import FrameState
    rows = {}
    t_path = time.perf_counter()
    w, h, d = K3_WIDE_GRIDS["planes"]
    k_cfg = dataclasses.replace(cfg, volume_width=w, volume_height=h,
                                volume_depth=d)
    st = FrameState(prev_shadow=torch.empty(0),
                    prev_accumulation=torch.empty(0),
                    prev_world_to_view=moved, frame_count=1)
    t = VolumetricRenderer(k_cfg).frame_tables(st, scene, 0.1)[0]
    kk = t.k
    band = (h // 8 * 4, 32, 10)
    y0, hb, m = band
    tb = band_tables(k_cfg, st, scene, 0.1, y0, hb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cur, prev = (torch.nn.functional.interpolate(
        v[None], size=(d, h, w), mode="trilinear",
        align_corners=True)[0].contiguous() for v in k3_src)
    shape = tuple(prev.shape)
    in_band = lambda v: v[:, :, y0:y0 + hb].contiguous()
    interior = lambda v: v[:, :, y0 + m:y0 + hb - m]

    def crossing(kernel, run, narrow_band, twin_band, label):
        """run() on the whole grid: its form counts, the narrow form on the
        band's tables against its rows, the twin on the band."""
        out, forms = forms_of(cuda, run)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"# k10_k11_wide, {label}: {kernel} on {shape} = "
            f"{prev.numel()} floats a volume, index forms (narrow, wide) "
            f"{json.dumps(forms)}, peak device memory {peak:.2f} GiB")
        if forms != {kernel: (0, 1)} or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"k10_k11_wide {label}: {kernel} took "
                                 f"{forms}, or a non-finite output")
        nb = narrow_band()
        same = torch.equal(nb[:, :, m:hb - m], interior(out))
        log(f"# k10_k11_wide, {label}, band rows {y0 + m}-{y0 + hb - m - 1}:"
            f" the narrow form on the band's tables = the wide form's rows "
            f"bit for bit: {same}")
        if not same:
            raise AssertionError(f"k10_k11_wide {label}: the wide form's "
                                 "rows differ from the narrow form's")
        del nb
        want, plain_ms = timed_plain(twin_band)
        err = band_hold(kernel, out, want, band, f"k10_k11_wide {label}")
        return err, plain_ms

    # K10: the accumulation blended into the planes (alpha mode)
    b_prev, b_cur = in_band(prev), in_band(cur)
    k10 = lambda: tmp.temporal_blend(t.abpar, prev, cur, t.grid_whd,
                                     t.h_glob, kk, "alpha")
    err, plain_ms = crossing(
        "temporal_blend", k10,
        lambda: tmp.temporal_blend(tb.abpar, b_prev, b_cur, tb.grid_whd,
                                   tb.h_glob, kk, "alpha", form="narrow"),
        lambda: tmp.temporal_blend_plain(tb.abpar, b_prev, b_cur,
                                         tb.grid_whd, tb.h_glob, kk,
                                         "alpha"), "alpha")
    rows[("temporal_blend", "wide_k10_k11")] = wide_row(
        "temporal_blend", "wide_k10_k11", k10, 3,
        blend_work(shape, "temporal_blend"), err, plain_ms, 1,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    del cur, b_cur
    # K11: the accumulation at smooth targets x + ox(y, x), y + oy(z, y),
    # z + oz(z, x)
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=prev.device)
    lattice = lambda v: torch.round(v * 256.0) / 256.0
    zs, ys, xs = ar(d), ar(h), ar(w)
    ox = lattice(4.5 * torch.sin(0.031 * xs[None] + 0.017 * ys[:, None]))
    oy = lattice(3.0 * torch.cos(0.023 * ys[None] + 0.05 * zs[:, None]))
    oz = lattice(2.0 * torch.sin(0.041 * xs[None] - 0.07 * zs[:, None]))
    tx = (xs + ox)[None].expand(d, h, w).contiguous()
    ty = (ys[None] + oy)[:, :, None].expand(d, h, w).contiguous()
    tz = (zs[:, None] + oz)[:, None, :].expand(d, h, w).contiguous()
    del ox, oy, oz
    b_t = [v[:, y0:y0 + hb].contiguous() for v in (tx, ty, tz)]
    b_t[1] = b_t[1] - y0
    k11 = lambda: wp.windowed_warp(prev, tx, ty, tz, kk)
    err, plain_ms = crossing(
        "windowed_warp", k11,
        lambda: wp.windowed_warp(b_prev, *b_t, kk, form="narrow"),
        lambda: wp.windowed_warp_plain(b_prev, *b_t, kk), "warp")
    rows[("windowed_warp", "wide_k10_k11")] = wide_row(
        "windowed_warp", "wide_k10_k11", k11, 3,
        blend_work(shape, "windowed_warp"), err, plain_ms, 1,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    del prev, tx, ty, tz, b_t, b_prev, t, tb
    torch.cuda.empty_cache()
    log(f"# k10_k11_wide: {time.perf_counter() - t_path:.1f} s")
    log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f} "
        "s: k10_k11_wide")
    return rows


def band_pcf_tables(cfg, state, scene, dir_shadow, y0: int, rows: int):
    """K12's tables of rows [y0, y0 + rows) of `cfg`'s grid, as the slab
    path packs a slab's (band_tables)."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.parallel.shard_render import Slab
    r = VolumetricRenderer(dataclasses.replace(
        cfg, volume_height=rows, image_height=8 * rows))
    slab = Slab(y0=float(y0), halo=0, grid_global=cfg.grid,
                image_height_global=cfg.image_height)
    return r.pcf_tables(state, scene, dir_shadow, slab)


def history_map_wide_paths(cfg, scene, scene_color, view_depth, cuda,
                           t_phase) -> dict:
    """The history and shadow-map frames' crossing paths, each through the
    entry point past the narrow forms' limits, with every other kernel of
    its frame through to K4:
      deep_history        HISTORY at 16x9x65664 froxels (DEEP), 2 frames:
                          K11 (material and scatter blends) and K10 (the
                          accumulation blend, alpha mode) past 65535 slices
                          (two parts of their launch grids), K5 and K6 in
                          their wide forms, K9 and K4 narrow, the plain
                          blocked scan; each kernel held against its twin
                          on the whole grid;
      deep_map_full_rate  MAP_DIR with dir_shadow_subsample=1 at DEEP, 2
                          frames: K12 on one sun's 65664 slices and K10's
                          weight mode (the shadow blend) wide, K6 wide, K1,
                          K3 and K4 narrow; each held against its twin on
                          the whole grid;
      many_suns_map_wide  MAP_DIR at full rate with 520 suns (104 copies of
                          many_suns_scene's 5; the 5 suns' maps baked once
                          and repeated), 2 frames: K12 on 520 x 128 =
                          66,560 (sun, slice) pairs and [520, 128, 135, 240]
                          volumes past 2^31 floats, K10's weight mode in
                          130 narrow groups, K6's general wide form; K12 by
                          copies (each = the narrow form's on the 5 suns
                          bit for bit) and against the twin on a band of
                          rows, K10's copies equal and its 5 suns against
                          the twin, K6's planes against the twin on the
                          band's tables.
    Returns {(kernel, mode): row of the kernels line}."""
    from volumetricrenderer_tpu_torch import (VolumetricRenderer,
                                              benchmark_scene)
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import pcf_shadow as pcf
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    from volumetricrenderer_tpu_torch.ops import warp as wp
    rows = {}

    def done(name, t_path):
        log(f"# {name}: {time.perf_counter() - t_path:.1f} s")
        log(f"# elapsed in the wide phase {time.perf_counter() - t_phase:.1f}"
            f" s: {name}")

    def hold_twin(kernel, args, out, twin, label):
        """A recorded call's output against its twin on the same inputs:
        (max abs err, the twin's ms)."""
        want, plain_ms = timed_plain(lambda: twin(*args))
        return compare(kernel, out, want, label=label), plain_ms

    # deep_history
    t_path = time.perf_counter()
    d_scene = benchmark_scene(aspect=DEEP["image_width"]
                              / DEEP["image_height"], num_local_lights=16,
                              noise_mode="procedural")
    h_r = VolumetricRenderer(dataclasses.replace(cfg, **HISTORY, **DEEP))
    d_col, d_dep = h_r.render_scene_inputs(d_scene)
    _, _, rec, _, _ = drive_wide(
        "deep_history", h_r, d_scene, d_col, d_dep, 2,
        {"windowed_warp": 2, "shadow_blend": 1, "bake_visibility": 1,
         "scatter": 1, "temporal_blend": 1, "composite": 1},
        {"windowed_warp": (0, 4), "temporal_blend": (0, 2),
         "shadow_blend": (0, 2), "scatter": (0, 2),
         "bake_visibility": (2, 0)}, cuda)
    warps = [(a, o) for k_, a, o in rec["calls"] if k_ == "windowed_warp"]
    log(f"# deep_history: K10's and K11's launch grids in "
        f"{len(cuda.grid_parts(DEEP['volume_depth']))} parts "
        f"{cuda.grid_parts(DEEP['volume_depth'])}")
    errs11 = [hold_twin("windowed_warp", a, o, wp.windowed_warp_plain,
                        f"deep_history {blend} blend")[0]
              for (a, o), blend in zip(warps, ("material", "scatter"))]
    plain11 = timed_plain(lambda: wp.windowed_warp_plain(*warps[-1][0]))[1]
    a10, o10 = rec["temporal_blend"]
    err10, plain10 = hold_twin("temporal_blend", a10, o10,
                               tmp.temporal_blend_plain,
                               "deep_history, alpha mode")
    hold_twin("shadow_blend", *rec["shadow_blend"],
              sb.dir_shadow_blend_plain, "deep_history")
    hold_twin("scatter", *rec["scatter"], sca.scatter_local_plain,
              "deep_history (baked visibility, material planes)")
    hold_twin("bake_visibility", *rec["bake_visibility"],
              vis.bake_visibility_plain, "deep_history (narrow)")
    rows[("temporal_blend", "wide_deep_history")] = wide_row(
        "temporal_blend", "wide_deep_history",
        lambda: tmp.temporal_blend(*a10), 5,
        blend_work(tuple(a10[1].shape), "temporal_blend"), err10, plain10,
        2, "the whole grid's twin (alpha mode)")
    rows[("windowed_warp", "wide_deep_history")] = wide_row(
        "windowed_warp", "wide_deep_history",
        lambda: wp.windowed_warp(*warps[-1][0]), 5,
        blend_work(tuple(warps[-1][0][0].shape), "windowed_warp"),
        max(errs11), plain11, 4,
        "the whole grid's twin (material and scatter blends)")
    del rec, warps, a10, o10
    torch.cuda.empty_cache()
    done("deep_history", t_path)

    # deep_map_full_rate: one sun's 65664 slices on K12, K10 weight
    t_path = time.perf_counter()
    m_r = VolumetricRenderer(dataclasses.replace(
        cfg, **MAP_DIR, dir_shadow_subsample=1, **DEEP))
    m_col, m_dep = m_r.render_scene_inputs(d_scene)
    maps = m_r.bake_shadow_data(d_scene)
    _, _, rec, _, _ = drive_wide(
        "deep_map_full_rate", m_r, d_scene, m_col, m_dep, 2,
        {k: 1 for k in MAP_DIR_KERNELS},
        {"pcf_shadow": (0, 2), "temporal_blend": (0, 2), "scatter": (0, 2),
         "integrate_blend": (2, 0)}, cuda, maps)
    a12, o12 = rec["pcf_shadow"]
    log(f"# deep_map_full_rate: K12 on {a12[0].par.shape[0]} sun x "
        f"{a12[0].grid_whd[2]} slices, its launch grid in "
        f"{len(cuda.grid_parts(a12[0].grid_whd[2]))} parts")
    err12, plain12 = hold_twin("pcf_shadow", a12, o12, pcf.pcf_shadow_plain,
                               "deep_map_full_rate")
    a10, o10 = rec["temporal_blend"]
    err10, plain10 = hold_twin("temporal_blend", a10, o10,
                               tmp.temporal_blend_plain,
                               "deep_map_full_rate, weight mode")
    hold_twin("scatter", *rec["scatter"], sca.scatter_local_plain,
              "deep_map_full_rate")
    hold_twin("bake_radiance", *rec["bake_radiance"], ff.bake_radiance_plain,
              "deep_map_full_rate")
    hold_twin("integrate_blend", *rec["integrate_blend"],
              ff.integrate_blend_plain,
              "deep_map_full_rate (narrow: 65664 slices a block)")
    rows[("pcf_shadow", "wide_deep_map_full_rate")] = wide_row(
        "pcf_shadow", "wide_deep_map_full_rate", lambda: pcf.pcf_shadow(*a12),
        5, k12_work(*a12), err12, plain12, 2, "the whole grid's twin")
    rows[("temporal_blend", "wide_deep_map_full_rate")] = wide_row(
        "temporal_blend", "wide_deep_map_full_rate",
        lambda: tmp.temporal_blend(*a10), 5,
        blend_work(tuple(a10[1].shape), "temporal_blend"), err10, plain10,
        2, "the whole grid's twin (weight mode)")
    del rec, a12, o12, a10, o10, maps
    torch.cuda.empty_cache()
    done("deep_map_full_rate", t_path)

    # many_suns_map_wide: 520 suns at full rate, the 5 suns' maps repeated
    t_path = time.perf_counter()
    base, copies = WIDE_SUN_COPIES
    scn5 = many_suns_scene(scene, base, 1)
    scn = dataclasses.replace(scn5, dir_lights=replicate(scn5.dir_lights,
                                                         copies))
    w_r = VolumetricRenderer(dataclasses.replace(
        cfg, **MAP_DIR, dir_shadow_subsample=1))
    dir5 = w_r.bake_shadow_data(scn5)[0]
    per_sun = ("atlas", "world_to_uv", "split_spheres", "split_sq_radii",
               "strength_r", "bias")
    repeat = lambda n: dataclasses.replace(dir5, **{
        f: torch.cat([getattr(dir5, f)] * n) for f in per_sun})
    dir10 = w_r.bake_shadow_data(dataclasses.replace(
        scn5, dir_lights=replicate(scn5.dir_lights, 2)))[0]
    same = all(torch.equal(getattr(dir10, f), getattr(repeat(2), f))
               for f in per_sun)
    log(f"# many_suns_map_wide: the {base} suns' maps repeated twice = the "
        f"bake of 2 copies' {2 * base} suns bit for bit: {same}")
    if not same:
        raise AssertionError("many_suns_map_wide: repeated maps differ from "
                             "a bake of the copied suns")
    del dir10
    dir520 = repeat(copies)
    _, prev, rec, _, _ = drive_wide(
        "many_suns_map_wide", w_r, scn, scene_color, view_depth, 2,
        {"pcf_shadow": 1, "temporal_blend": copies * base // 4,
         "bake_radiance": 1, "scatter": 1, "integrate_blend": 1,
         "composite": 1},
        {"pcf_shadow": (0, 2), "temporal_blend": (copies * base // 2, 0),
         "scatter": (0, 2), "integrate_blend": (2, 0)}, cuda,
        (dir520, None, None))
    (t12, atlas), vol = rec["pcf_shadow"]
    a10, bl = rec["temporal_blend"]
    (t6, sh6, bake6, *_), sc = rec["scatter"]
    nd, (w, h, d) = t12.par.shape[0], t12.grid_whd
    log(f"# many_suns_map_wide: K12 on {nd} suns x {d} slices = {nd * d} "
        f"(sun, slice) pairs ({len(cuda.grid_parts(nd * d))} parts), "
        f"[{nd}, {d}, {h}, {w}] = {vol.numel()} floats (past 2^31 - 1: "
        f"{vol.numel() > cuda.INT32_MAX}); K10 blended it in "
        f"{len(tmp.channel_groups(nd, 'weight'))} groups; K6 read K10's: "
        f"{sh6 is bl}")
    if nd * d <= cuda.MAX_GRID_Z or vol.numel() <= cuda.INT32_MAX \
            or sh6 is not bl:
        raise AssertionError("many_suns_map_wide passes neither edge, or K6 "
                             "did not read K10's blend")
    del rec
    # K12 by copies: each = the narrow form's on the 5 suns' tables
    t5 = w_r.pcf_tables(prev, scn5, dir5)
    v5 = pcf.pcf_shadow(t5, dir5.atlas, form="narrow")
    same = all(torch.equal(vol[c * base:(c + 1) * base], v5)
               for c in range(copies))
    # K10: the copies' blends equal (their inputs are), the 5 suns against
    # the twin on the whole grid
    same10 = all(torch.equal(bl[c * base:(c + 1) * base], bl[:base])
                 for c in range(1, copies))
    log(f"# many_suns_map_wide, replication holds: each of the {copies} "
        f"copies' K12 volumes = the narrow form's on the {base}-sun "
        f"tables bit for bit: {same}; each copy's K10 blend = the first's: "
        f"{same10}")
    if not (same and same10):
        raise AssertionError("many_suns_map_wide: a copy differs")
    del v5, t5
    bpar, p_sh, cur = a10[:3]
    want, plain10 = timed_plain(lambda: tmp.temporal_blend_plain(
        bpar, p_sh[:base].contiguous(), cur[:base].contiguous(), *a10[3:]))
    err10 = compare("temporal_blend", bl[:base].contiguous(), want,
                    label=f"many_suns_map_wide, the first {base} suns")
    del want
    rows[("temporal_blend", "narrow_many_suns_map")] = wide_row(
        "temporal_blend", "narrow_many_suns_map",
        lambda: tmp.temporal_blend(*a10), 3,
        blend_work(tuple(p_sh.shape), "temporal_blend"), err10, plain10,
        2 * len(tmp.channel_groups(nd, "weight")),
        f"copies equal; the twin on the first {base} suns (its time)")
    del a10, bpar, p_sh, cur
    # K12 and K6 on a band of rows against the twin on the band's tables
    y0, hb, _ = WIDE_BAND
    tb12 = band_pcf_tables(w_r.config, prev, scn, dir520, y0, hb)
    want, plain12 = timed_plain(lambda: pcf.pcf_shadow_plain(tb12, atlas))
    err12 = band_hold("pcf_shadow", vol, want, WIDE_BAND,
                      "many_suns_map_wide")
    del want, tb12
    rows[("pcf_shadow", "wide_many_suns_map")] = wide_row(
        "pcf_shadow", "wide_many_suns_map", lambda: pcf.pcf_shadow(t12, atlas),
        3, k12_work(t12, atlas), err12, plain12, 2,
        f"the twin on band rows {y0}-{y0 + hb - 1}; each copy = the narrow "
        f"form on the {base} suns")
    del vol
    tb = band_tables(w_r.config, prev, scn, 0.1, *WIDE_BAND[:2])
    sh_band = bl[:, :, y0:y0 + hb].contiguous()
    want, plain6 = timed_plain(lambda: sca.scatter_local_plain(
        tb, sh_band, ff.bake_radiance_plain(tb)))
    err6 = band_hold("scatter", sc, want, WIDE_BAND,
                     "many_suns_map_wide planes")
    del want, sh_band, tb
    rows[("scatter", "wide_many_suns_map")] = wide_row(
        "scatter", "wide_many_suns_map",
        lambda: sca.scatter_local(t6, sh6, bake6), 3,
        fused_work(t6, "scatter"), err6, plain6, 2,
        f"the twin on band rows {y0}-{y0 + hb - 1}")
    log(f"# many_suns_map_wide: K10's {base} distinct suns against the "
        f"twin, max abs err {err10:.3e}")
    del prev, t12, atlas, bl, t6, sh6, bake6, sc, dir520, dir5
    torch.cuda.empty_cache()
    done("many_suns_map_wide", t_path)
    return rows


# The crossings past a block's shared memory (shared_edge_paths):
# many_suns_shared's 19,460 suns, 3,892 copies of many_suns_scene's 5, on a
# grid whose histories pass 2^31 floats (K2's and K5's wide index form) and
# on the --small grid (narrow); many_noise_shared's 432 procedural noise
# media at FULL_CONFIG, of which K1's chunked form stages 425 at 16 lights
SHARED_SUN_COPIES = (5, 3892)
SHARED_GRIDS = {
    "wide": dict(volume_width=80, volume_height=45, volume_depth=32),
    "narrow": dict(volume_width=40, volume_height=24, volume_depth=16,
                   image_width=160, image_height=90)}
SHARED_NOISE = 432
# the general form's rows (many_suns_holds) whose work, twin error and
# plain time a forced gen_global or chunked row shares (bit for bit)
SHARED_GEN_ROWS = {"bake_radiance": "general", "shadow_blend": "general",
                   "dir_shadow": "general"}


def shared_form_mirrors(ff, sca, cuda, tables) -> None:
    """The wrappers' mirrors of the forms past a block's shared memory
    against the launchers' own rules: ops/scatter.sun_form against
    vr_shadow_scatter_sun_form_of, vr_shadow_blend_sun_form_of and
    vr_dir_shadow_sun_form_of at each edge (18,435 / 18,436 suns at k = 4,
    19,285 / 19,286 for K7, other windows, K2's fBm channels);
    ops/frame_fused.k1_plan and k1_geometry's bytes against
    vr_bake_radiance_plan at 421-430 channels and 0-40 lights (past K2's
    and K5's region edge, k = 52, their region_global form reads the suns
    from device memory: gen_global); K3's window (k3_window_form): its
    region_shared form's bytes with its static ones (cudaFuncGetAttributes)
    pass the card's opt-in limit at k = 159, where the mirror names the
    region_global form and a forced region_shared is refused."""
    import ctypes

    def of(name, entry, *args, n=1):
        buf = (ctypes.c_int * n)()
        getattr(cuda.lib(name), entry)(*args, ctypes.cast(buf,
                                                          ctypes.c_void_p))
        return tuple(buf)

    def mirror(kernel, nd, nn, k):
        try:
            return cuda.SUN_FORMS.index(sca.sun_form(kernel, nd, nn, k))
        except ValueError:
            return -1

    def region_of(kernel, k):
        name = {"K2": "shadow_scatter", "K5": "shadow_blend"}[kernel]
        return of(name, f"vr_{name}_region_form_of", k)[0]

    bad, n_rows = [], 0
    rule_of = {0: "shared", 1: "gen_global", -1: "refused"}
    for k in (4, 0, 8, 25, 51, 52):
        for nd, nn in ((18435, 1), (18436, 1), (19285, 0), (19286, 0),
                       (4, 5), (9, 9), (1, 1)):
            for kernel, got in (
                    ("K2", of("shadow_scatter",
                              "vr_shadow_scatter_sun_form_of", k, nd, nn)),
                    ("K5", of("shadow_blend", "vr_shadow_blend_sun_form_of",
                              k, nd)),
                    ("K7", of("dir_shadow", "vr_dir_shadow_sun_form_of",
                              nd))):
                want = mirror(kernel, nd, nn, k)
                # the launcher names shared (fixed or general) or global;
                # past K2's and K5's region edge their region_global form,
                # whose suns are in device memory
                if kernel != "K7" and region_of(kernel, k) == 1:
                    got = (1,)
                same = got[0] == (-1 if want < 0 else int(want == 2))
                n_rows += 1
                if not same:
                    bad.append((kernel, k, nd, nn, got[0], want))
    for nl in (0, 1, 4, 16, 32, 40):
        for nn in (0, 1, 4, 5, 9, 421, 422, 425, 426, 429, 430, 2000):
            got = of("bake_radiance", "vr_bake_radiance_plan", nl, nn, n=3)
            form, chunk = ff.k1_plan(nl, nn)
            want = (cuda.FORM_NAMES["bake_radiance"].index(form), chunk,
                    ff.k1_geometry(nl, nn, (60, 34, 32)).shared_bytes)
            n_rows += 1
            if got != want:
                bad.append(("K1", nl, nn, got, want))
    log(f"# the forms past a block's shared memory: {n_rows} cases of "
        f"sun_form (K2, K5, K7) and k1_plan (K1) against the launchers' "
        f"rules ({rule_of}), disagreeing: {bad}")
    if bad:
        raise AssertionError(f"the shared-memory form mirrors disagree: "
                             f"{bad}")
    # K3's window: at k = 159 its region_shared form's dynamic shared
    # memory and its static arrays (cudaFuncGetAttributes) pass the card's
    # opt-in limit, where its launcher's cudaFuncSetAttribute would fail
    # (not provoked here: the library would keep that error as its last):
    # the mirror names the region_global form there, as the launcher's
    # rule does, and refuses a forced region_shared before any launch;
    # forced_shared_holds launches k = 158
    w, h, d = 40, 24, 16
    t = dataclasses.replace(tables, grid_whd=(w, h, d), h_glob=h, k=159)
    sc = torch.zeros((4, d, h, w), device="cuda")
    acc = torch.zeros((4, d, h, w), device="cuda")
    before = cuda.LAUNCHES["integrate_blend"]
    try:
        ff.integrate_blend(t, sc, acc, form="region_shared")
        refused = ""
    except ValueError as e:
        refused = str(e)
    refused = refused if cuda.LAUNCHES["integrate_blend"] == before else ""
    rules = {k: (ff.k3_window_form(k), of("integrate_blend",
                                          "vr_integrate_blend_region_form_of",
                                          k)[0]) for k in (158, 159)}
    attrs = cuda.kernel_attrs("integrate_blend")
    static = {attrs[n]["shared_bytes"] for n in
              cuda.ATTR_KERNELS["integrate_blend"][:2]}
    optin = getattr(torch.cuda.get_device_properties(0),
                    "shared_memory_per_block_optin", None)
    log(f"# K3's window: at k = 158 {ff.k3_shared_bytes(158)} dynamic + "
        f"{ff.K3_STATIC_SHARED} static bytes; at k = 159 "
        f"({ff.k3_shared_bytes(159)} dynamic) the wrapper refuses a forced "
        f"region_shared ({refused!r}); the mirror's and the launcher's "
        f"region forms {json.dumps(rules)}; the region_shared kernels' "
        f"static bytes {sorted(static)}, the card's opt-in limit {optin}")
    if not refused or static != {ff.K3_STATIC_SHARED} \
            or optin not in (None, MAX_SHARED_BYTES) \
            or rules != {158: ("region_shared", 0),
                         159: ("region_global", 1)}:
        raise AssertionError("K3's window mirror disagrees with the kernel "
                             "or the card at k = 159")


def in_turns(a, b, n: int) -> tuple:
    """CUDA-event times (ms a call) of a and b in the order a, b, b, a."""
    a1 = kernel_time_ms(a, n)
    b1, b2 = kernel_time_ms(b, n), kernel_time_ms(b, n)
    a2 = kernel_time_ms(a, n)
    return [a1, a2], [b1, b2]


def forced_shared_holds(renderers, runs, scene, many_rows, cuda) -> dict:
    """K2 (radiance, rays, baked), K5 and K7 forced into gen_global in both
    index forms, and K1 forced into its chunked form (4 and 0 of its 9
    channels staged, and the most that fit), on the inputs of many_suns'
    frame 4 at 9 suns and 9 fBm channels (240x135x128): each = the general
    form bit for bit, its launch counted under its form, timed in turns
    against the general form (general, forced, forced, general); and K3 at
    k = 158, the widest window of its region_shared form, against its
    twin. Returns
    {(kernel, mode): row}; each row shares the general form's work, twin
    error and plain time (many_suns_holds), the two being equal."""
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    prev = runs["many_suns"][1][3]
    sc_c = many_suns_scene(scene, 9, 9)
    t = renderers["many_suns"].frame_tables(prev, sc_c, 0.3)[0]
    xt = renderers["fused_exact"].frame_tables(prev, sc_c, 0.3)[0]
    vt = renderers["fused_vis"].frame_tables(prev, sc_c, 0.3)[0]
    prev_sh = prev.prev_shadow[:9].float().contiguous()
    bake = ff.bake_radiance(t)
    cases = {("shadow_scatter", "radiance"): lambda f: ff.shadow_scatter(
                 t, prev_sh, bake, form=f),
             ("shadow_scatter", "rays"): lambda f: ff.shadow_scatter(
                 xt, prev_sh, form=f),
             ("shadow_scatter", "baked"): lambda f, v=vis.bake_visibility(
                 vt): ff.shadow_scatter(vt, prev_sh, None, v, form=f),
             ("shadow_blend", ""): lambda f: sb.dir_shadow_blend(
                 t, prev_sh, form=f),
             ("dir_shadow", ""): lambda f: ds.dir_shadow(t, form=f)}
    rows = {}

    def row(kernel, mode, gen_key, ms, gen_ms, label):
        g = many_rows[(kernel, gen_key)]
        rows[(kernel, mode)] = {
            "launches": 0, "paths": [], "max_abs_err": g["max_abs_err"],
            "ms": sum(ms) / 2, "ms_turns": ms, "general_ms": sum(gen_ms) / 2,
            "general_ms_turns": gen_ms, "plain_ms": g["plain_ms"],
            "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
            "library_ms": None, "held": label}
        log(f"# {kernel}, {mode} (forced, 9 suns, 9 fBm channels): "
            f"{ms[0]:.4f} {ms[1]:.4f} ms/call, the general form "
            f"{gen_ms[0]:.4f} {gen_ms[1]:.4f} ({sum(ms) / sum(gen_ms):.3f}x"
            f"), bound {g['bound_ms']:.4f} ms; = the general form bit for "
            f"bit")

    for (kernel, mode), fn in cases.items():
        for index in cuda.INDEX_FORMS:
            torch.cuda.synchronize()
            before = cuda.form_counts(kernel)
            want = fn(index)
            got = fn((index, "gen_global"))
            torch.cuda.synchronize()
            after = cuda.form_counts(kernel)
            moved = {f: after[f] - before[f] for f in after
                     if after[f] != before[f]}
            same = all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                want if isinstance(want, tuple) else (want,)))
            label = f"{kernel} {mode} {index}".replace("  ", " ")
            log(f"# {label}: gen_global forced = the general form bit for "
                f"bit: {same}; launches by form {json.dumps(moved)}")
            want_moved = {"general": 1, "gen_global": 1, index: 2}
            if kernel in cuda.REGION_SOURCES:
                want_moved["region_shared"] = 2
            if not same or moved != want_moved:
                raise AssertionError(f"{label}: gen_global differs from the "
                                     f"general form, or the forms {moved}")
            del got, want
            slow = mode in ("rays", "baked")
            gen_ms, glob_ms = in_turns(lambda: fn(index),
                                       lambda: fn((index, "gen_global")),
                                       3 if slow else 10)
            row(kernel, "_".join(x for x in ("gen_global", mode, index) if x),
                SHARED_GEN_ROWS.get(kernel, f"general_{mode}"), glob_ms,
                gen_ms, "the general form, bit for bit")
    # K3 at the widest window its region_shared form takes (k = 158,
    # k3_window_form), on the same frame's scatter planes and history
    acc = prev.prev_accumulation.float().contiguous()
    sc = ff.shadow_scatter(t, prev_sh, bake)[1]
    t158 = dataclasses.replace(t, k=158)
    compare("integrate_blend", ff.integrate_blend(t158, sc, acc),
            ff.integrate_blend_plain(t158, sc, acc),
            label="k = 158, the widest window of K3's region_shared form, "
                  "many_suns' frame 4")
    del sc, acc
    # K1: its chunked form forced with 4, 0 and the most that fit staged
    want = ff.bake_radiance(t)
    for chunk in (4, 0, None):
        before = cuda.form_counts("bake_radiance")
        got = ff.bake_radiance(t, form="chunked", chunk=chunk)
        torch.cuda.synchronize()
        moved = {f: n - before[f] for f, n in
                 cuda.form_counts("bake_radiance").items() if n != before[f]}
        same = torch.equal(got, want)
        log(f"# bake_radiance chunked, {chunk} of 9 channels staged: = the "
            f"general form bit for bit: {same}; launches by form "
            f"{json.dumps(moved)}")
        if not same or moved != {"chunked": 1}:
            raise AssertionError(f"K1's chunked form ({chunk} staged) "
                                 "differs from the general form")
        gen_ms, ch_ms = in_turns(
            lambda: ff.bake_radiance(t),
            lambda c=chunk: ff.bake_radiance(t, form="chunked", chunk=c), 20)
        row("bake_radiance", f"chunked_{'most' if chunk is None else chunk}"
            "_of_9", "general", ch_ms, gen_ms,
            "the general form, bit for bit")
    return rows



def fbm_ulp_hold(name: str, t, bake, want) -> float:
    """K1's bake `bake` against its twin's `want` where the fBm coordinates
    are large (many_noise_shared: medium j scrolls by 2j, so its noise
    coordinates reach ~90 at frame 2, and 64x that at its fifth octave,
    where one float's step is 4.9e-4 of a lattice cell): the radiance
    channels at CHECKS; each fBm channel against the twin's fBm at the
    sample's noise coordinates and at the neighbouring float of each, below
    and above (27 points), the kernel's value within CHECKS' tolerance of
    the range they span on all but CHECKS' share of the samples -- the
    twin's value at coordinates one rounding away, as a last-ulp difference
    of a sample's position reaches them. Logs the plain hold's share past
    the tolerance by groups of channels. Returns the largest |kernel -
    twin|."""
    from volumetricrenderer_tpu_torch.ops import material as mtl
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    atol, rtol, frac_ok, _ = CHECKS["bake_radiance"]
    err = compare("bake_radiance", bake[:3].contiguous(),
                  want[:3].contiguous(), label=f"{name}, radiance channels")
    wl, hl, dl = t.low_dims
    ms = torch.arange(dl, device=bake.device)[:, None, None]
    wx, wy, wz = vis.bake_world_planes(t.spar, ms, t.grid_whd, t.ss,
                                       t.h_glob)
    inf = torch.full_like(wx, float("inf"))
    plain, past, worst, big, c = [], 0, 0.0, 0.0, 0
    for mi, (src, octaves, period, seed, *_) in enumerate(t.media_static):
        if not src:
            continue
        coords = []
        for axis, (w_, sc_, of_) in enumerate(((wx, 5, 8), (wy, 6, 9),
                                               (wz, 7, 10))):
            u = w_ * t.med[mi, sc_] + t.med[mi, of_]
            big = max(big, float(u.abs().max()))
            v = torch.stack([torch.nextafter(u, -inf), u,
                             torch.nextafter(u, inf)])
            coords.append(v.view(*(3 if a == axis else 1 for a in range(3)),
                                 *u.shape))
        n = mtl.perlin_planes(*coords, octaves, period, seed)
        k, w_c = bake[3 + c], want[3 + c]
        if not torch.equal(n[1, 1, 1], w_c):
            raise AssertionError(f"{name}: the fBm at the noise coordinates "
                                 f"is not the twin's (channel {c})")
        tol = atol + rtol * w_c.abs()
        lo, hi = n.amin(dim=(0, 1, 2)), n.amax(dim=(0, 1, 2))
        past += int(((k < lo - tol) | (k > hi + tol)).sum())
        d = (k - w_c).abs()
        worst = max(worst, float(d.max()))
        plain.append(float((d > tol).float().mean()))
        c += 1
    share = past / (c * wl * hl * dl)
    groups = {f"{c0}-{min(c0 + 47, c - 1)}": sum(plain[c0:c0 + 48])
              / len(plain[c0:c0 + 48]) for c0 in range(0, c, 48)}
    log(f"# check bake_radiance ({name}, {c} fBm channels at their "
        f"coordinates' neighbouring floats): largest |coordinate| {big:.2f}"
        f", max_abs_err against the twin {worst:.3e}, share past atol "
        f"{atol:g} + rtol {rtol:g} of the range at the 27 points {share:.2e} "
        f"(allowed {frac_ok:g}); the plain hold's share past it by channels "
        + json.dumps({k_: f"{v:.1e}" for k_, v in groups.items()}))
    if share > frac_ok:
        raise AssertionError(f"bake_radiance ({name}): the fBm channels "
                             "disagree with the twin past a rounding of "
                             "their coordinates")
    return max(err, worst)

def shared_edge_paths(cfg, scene, renderers, runs, scene_color, view_depth,
                      many_rows, tables, cuda) -> dict:
    """The forms past a block's shared memory: the mirrors
    (shared_form_mirrors), the forced holds at 240x135x128
    (forced_shared_holds), then the crossings many_suns_shared (fused,
    staged and no_shadow_blend frames with 19,460 suns on SHARED_GRIDS'
    two grids) and many_noise_shared (the fused frame with 432 fBm
    channels), each from a fresh state through to K4 with its launches by
    form counted. Returns {(kernel, mode): row of the kernels line}."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.ops import dir_shadow as ds
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    t_phase = time.perf_counter()

    def done(name):
        log(f"# elapsed in the shared-memory phase "
            f"{time.perf_counter() - t_phase:.1f} s: {name}")

    shared_form_mirrors(ff, sca, cuda, tables)
    rows = forced_shared_holds(renderers, runs, scene, many_rows, cuda)
    done("mirrors and forced holds")

    def by_form(name, run, want):
        """run(), its launches by form (FORM_SOURCES) checked: `want`
        {source: {form: launches}} for every source that launched."""
        before = {s_: cuda.form_counts(s_) for s_ in cuda.FORM_SOURCES}
        out = run()
        got = {}
        for s_ in cuda.FORM_SOURCES:
            moved = {f: n - before[s_][f] for f, n in
                     cuda.form_counts(s_).items()
                     if f in cuda.FORM_NAMES[s_] and n != before[s_][f]}
            if moved:
                got[s_] = moved
        log(f"# {name}: launches by form {json.dumps(got)}")
        if got != want:
            raise AssertionError(f"{name}: launches by form {got}, not "
                                 f"{want}")
        return out

    # many_suns_shared
    base, copies = SHARED_SUN_COPIES
    scn5 = many_suns_scene(scene, base, 1)
    scn = dataclasses.replace(scn5, dir_lights=replicate(scn5.dir_lights,
                                                         copies))
    nd = base * copies

    def by_copies(name, vol, first):
        v = vol.view(copies, base, -1)
        same = bool((v == v[:1]).all()) and torch.equal(vol[:base], first)
        log(f"# {name}: each of the {copies} copies' {base} channels = the "
            f"first copy's, and the first = the general form's on the "
            f"{base}-sun scene, bit for bit: {same}")
        if not same:
            raise AssertionError(f"{name}: a copy differs from the first, "
                                 "or the first from the general form")

    for grid, dims in SHARED_GRIDS.items():
        g_cfg = dataclasses.replace(cfg, **dims)
        wide = grid == "wide"
        ix = (0, 2) if wide else (2, 0)
        # the fused frame
        r = VolumetricRenderer(g_cfg)
        if g_cfg.image_width == cfg.image_width:
            col, dep = scene_color, view_depth
        else:
            col, dep = r.render_scene_inputs(scn)
        name = f"many_suns_shared_{grid}"
        _, prev, rec, secs, _ = by_form(name, lambda: drive_wide(
            name, r, scn, col, dep, 2,
            {"bake_radiance": 1, "shadow_scatter": 1, "integrate_blend": 1,
             "composite": 1},
            {"shadow_scatter": ix, "integrate_blend": (2, 0)}, cuda),
            {"bake_radiance": {"fixed": 2},
             "shadow_scatter": {"gen_global": 2}})
        (t, p_sh, bake, _), (sh, sc) = rec["shadow_scatter"]
        del rec
        log(f"# {name}: {t.n_dir} suns, {tuple(sh.shape)} histories = "
            f"{sh.numel()} floats (past 2^31 - 1: {sh.numel() > 2 ** 31 - 1})"
            f", {sca.sun_inv_bytes(nd)} bytes of inverse directions past "
            f"{ff.k2_shared_bytes(t.k)} of region")
        if t.n_dir != nd or (sh.numel() > 2 ** 31 - 1) != wide:
            raise AssertionError(f"{name}: {t.n_dir} suns, "
                                 f"{sh.numel()} floats")
        t5 = r.frame_tables(prev, scn5, 0.1)[0]
        p5 = p_sh[:base].contiguous()
        sh5, _ = ff.shadow_scatter(t5, p5, bake)
        by_copies(name, sh, sh5)
        want, plain_ms = timed_plain(lambda: ff.shadow_scatter_plain(
            t5, p5, ff.bake_radiance_plain(t5)))
        err = compare("shadow_scatter", sh[:base], want[0],
                      label=f"{name}, the first copy's history")
        del want, sh5
        # the planes: K2 = K5 then K6 bit for bit (both gen_global's K5)
        sh_b = sb.dir_shadow_blend(t, p_sh)
        same = torch.equal(sh_b, sh) and torch.equal(
            sca.scatter_local(t, sh_b, bake), sc)
        log(f"# {name}: K2's history and planes = K5 (gen_global) then K6 "
            f"bit for bit: {same}")
        if not same:
            raise AssertionError(f"{name}: K2 differs from K5 then K6")
        del sh_b, sh, sc
        torch.cuda.empty_cache()
        rows[("shadow_scatter", f"gen_global_{name}")] = wide_row(
            "shadow_scatter", f"gen_global_{name}",
            lambda: ff.shadow_scatter(t, p_sh, bake), 3,
            fused_work(t, "shadow_scatter"), err, plain_ms, 2,
            "the twin on the first copy's 5 suns, whole grid")
        del prev, t, p_sh, bake, t5, p5
        torch.cuda.empty_cache()
        done(name)
        # the staged frame: K5 gen_global
        s_r = VolumetricRenderer(dataclasses.replace(g_cfg, **STAGED))
        name = f"many_suns_shared_staged_{grid}"
        _, prev, rec, _, _ = by_form(name, lambda: drive_wide(
            name, s_r, scn, col, dep, 2, {k: 1 for k in STAGED_KERNELS},
            {"shadow_blend": ix, "scatter": ix,
             "integrate_blend": (2, 0)}, cuda),
            {"bake_radiance": {"fixed": 2}, "shadow_blend": {"gen_global": 2},
             "scatter": {"general": 2}})
        (t, p_sh), sh = rec["shadow_blend"]
        del rec
        t5 = s_r.frame_tables(prev, scn5, 0.1)[0]
        p5 = p_sh[:base].contiguous()
        by_copies(name, sh, sb.dir_shadow_blend(t5, p5))
        want, plain_ms = timed_plain(lambda: sb.dir_shadow_blend_plain(t5,
                                                                       p5))
        err = compare("shadow_blend", sh[:base], want,
                      label=f"{name}, the first copy's history")
        del want, sh
        torch.cuda.empty_cache()
        rows[("shadow_blend", f"gen_global_{name}")] = wide_row(
            "shadow_blend", f"gen_global_{name}",
            lambda: sb.dir_shadow_blend(t, p_sh), 3,
            fused_work(t, "shadow_blend"), err, plain_ms, 2,
            "the twin on the first copy's 5 suns, whole grid")
        del prev, t, p_sh, t5, p5
        torch.cuda.empty_cache()
        done(name)
        # no_shadow_blend: K7 gen_global
        n_r = VolumetricRenderer(dataclasses.replace(
            g_cfg, **STAGED, temporal_blend_shadow=False))
        name = f"many_suns_shared_no_shadow_blend_{grid}"
        _, prev, rec, _, _ = by_form(name, lambda: drive_wide(
            name, n_r, scn, col, dep, 1,
            {k: 1 for k in NO_SHADOW_BLEND_KERNELS},
            {"dir_shadow": (0, 1) if wide else (1, 0),
             "scatter": (0, 1) if wide else (1, 0),
             "integrate_blend": (1, 0)}, cuda),
            {"bake_radiance": {"fixed": 1}, "dir_shadow": {"gen_global": 1},
             "scatter": {"general": 1}})
        (t,), un = rec["dir_shadow"]
        del rec
        t5 = n_r.frame_tables(prev, scn5, 0.0)[0]
        by_copies(name, un, ds.dir_shadow(t5))
        want, plain_ms = timed_plain(lambda: ds.dir_shadow_plain(t5))
        err = compare("dir_shadow", un[:base], want,
                      label=f"{name}, the first copy's volume")
        del want, un
        torch.cuda.empty_cache()
        rows[("dir_shadow", f"gen_global_{name}")] = wide_row(
            "dir_shadow", f"gen_global_{name}", lambda: ds.dir_shadow(t), 3,
            fused_work(t, "dir_shadow"), err, plain_ms, 1,
            "the twin on the first copy's 5 suns, whole grid")
        del prev, t, t5, col, dep
        torch.cuda.empty_cache()
        done(name)

    # many_noise_shared
    name = "many_noise_shared"
    scn = many_suns_scene(scene, 1, SHARED_NOISE)
    r = renderers["fused"]
    _, prev, rec, _, _ = by_form(name, lambda: drive_wide(
        name, r, scn, scene_color, view_depth, 2,
        {"bake_radiance": 1, "shadow_scatter": 1, "integrate_blend": 1,
         "composite": 1},
        {"shadow_scatter": (2, 0), "integrate_blend": (2, 0)}, cuda),
        {"bake_radiance": {"chunked": 2}, "shadow_scatter": {"general": 2}})
    (t, *_), bake = rec["bake_radiance"]
    (t2, p_sh, bake2, _), (sh, sc) = rec["shadow_scatter"]
    del rec
    n_l = t.lights.shape[0]
    form, staged = ff.k1_plan(n_l, t.n_noise)
    log(f"# {name}: {t.n_noise} fBm channels at {n_l} lights, K1's {form} "
        f"form: {ff.k1_chunks(n_l, t.n_noise)} (staged, whole), "
        f"{ff.k1_geometry(n_l, t.n_noise, t.low_dims).shared_bytes} bytes "
        f"of shared memory; the bake {tuple(bake.shape)}, K2 read it: "
        f"{bake2 is bake}")
    if form != "chunked" or bake2 is not bake:
        raise AssertionError(f"{name}: K1 took its {form} form")
    # the channels against the general form on scenes that fit: the
    # prefix of `staged` channels, and the base scene's media (channel 0)
    # with the noise media of the channels past them (the extra medium of
    # channel c >= 1 is media[nb + c - 1])
    nb = len(scene.media)
    pre = dataclasses.replace(scn, media=scn.media[:nb + staged - 1])
    t_pre = r.frame_tables(prev, pre, 0.1)[0]
    b_pre = ff.bake_radiance(t_pre)
    suf = dataclasses.replace(scn, media=scn.media[:nb]
                              + scn.media[nb + staged - 1:])
    t_suf = r.frame_tables(prev, suf, 0.1)[0]
    b_suf = ff.bake_radiance(t_suf)
    forms = (ff.k1_plan(n_l, t_pre.n_noise)[0],
             ff.k1_plan(n_l, t_suf.n_noise)[0])
    same = torch.equal(bake[:3 + staged], b_pre) \
        and torch.equal(bake[3 + staged:], b_suf[4:]) \
        and torch.equal(bake[:4], b_suf[:4])
    log(f"# {name}: channels 0-{2 + staged} = the general form on the "
        f"{staged}-media prefix, channels {3 + staged}-{2 + t.n_noise} = "
        f"the general form on the base medium and the last "
        f"{t.n_noise - staged} (forms {forms}), bit for bit: {same}")
    if not same or forms != ("general", "general"):
        raise AssertionError(f"{name}: K1's chunked form differs from the "
                             "general form")
    del b_pre, b_suf
    want, plain_ms = timed_plain(lambda: ff.bake_radiance_plain(t))
    err = fbm_ulp_hold(name, t, bake, want)
    del want
    sh_b = sb.dir_shadow_blend(t2, p_sh)
    same = torch.equal(sh_b, sh) and torch.equal(
        sca.scatter_local(t2, sh_b, bake), sc)
    log(f"# {name}: K2 (general, {t2.n_noise} fBm channels) = K5 then K6 "
        f"bit for bit: {same}")
    if not same:
        raise AssertionError(f"{name}: K2 differs from K5 then K6")
    del sh_b, sh, sc
    rows[("bake_radiance", f"chunked_{name}")] = wide_row(
        "bake_radiance", f"chunked_{name}", lambda: ff.bake_radiance(t), 10,
        fused_work(t, "bake_radiance"), err, plain_ms, 2,
        "the twin on the whole low grid; fBm within a rounding of its "
        "coordinates")
    del prev, t, t2, p_sh, bake, bake2
    torch.cuda.empty_cache()
    done(name)
    return rows


# The region forms past a block's shared memory (region_edge_paths): the
# first window at which each source's launcher takes its region_global
# form (the reprojection offsets in device memory); K11's, which refuses
# it; and the crossing paths through VolumetricRenderer: (config changes
# from FULL_CONFIG, reproj_window, frames, kernels of the path)
REGION_EDGE = {"shadow_scatter": 52, "shadow_blend": 52, "temporal_blend": 52,
               "integrate_blend": 159}
K11_EDGE = 108
REGION_PATHS = {
    "fused_k52": ({}, 52, 2, FUSED_KERNELS),
    "fused_k159": ({}, 159, 2, FUSED_KERNELS),
    "staged_k52": (STAGED, 52, 2, STAGED_KERNELS),
    "map_dir_k52": (MAP_DIR, 52, 2, MAP_DIR_KERNELS),
    "history_k107": (HISTORY, K11_EDGE - 1, 2, PATHS["history"][2]),
}


def region_form_mirrors(ff, tmp, wp, cuda) -> None:
    """The region-form mirrors against the launchers' own rules
    (vr_<source>_region_form_of) at windows around each edge:
    ops/temporal.region_form for K2, K5 and K10 (52), ops/frame_fused.
    k3_window_form for K3 (159); and K11, which has no region_global form:
    its region's bytes (vr_windowed_warp_geometry = ops/warp.
    k11_shared_bytes) within a block's shared memory at k = 107 and past it
    at 108, where the wrapper refuses by name before any launch."""
    import ctypes

    def of(name, entry, *args, n=1):
        buf = (ctypes.c_int * n)()
        getattr(cuda.lib(name), entry)(*args, ctypes.cast(buf,
                                                          ctypes.c_void_p))
        return tuple(buf)

    mirror = {"shadow_scatter": lambda k: tmp.region_form("K2", k),
              "shadow_blend": lambda k: tmp.region_form("K5", k),
              "temporal_blend": lambda k: tmp.region_form("K10", k),
              "integrate_blend": ff.k3_window_form}
    bad, n_rows = [], 0
    for src, fn in mirror.items():
        for k in (0, 4, 25, 51, 52, 53, 107, 158, 159, 160, 400):
            got = of(src, f"vr_{src}_region_form_of", k)[0]
            want = cuda.REGION_FORMS.index(fn(k))
            n_rows += 1
            if got != want or (want == 1) != (k >= REGION_EDGE[src]):
                bad.append((src, k, got, want))
    log(f"# the region forms: {n_rows} cases of region_form (K2, K5, K10) "
        f"and k3_window_form (K3) against the launchers' rules (0 "
        f"region_shared, 1 region_global), disagreeing: {bad}")
    if bad:
        raise AssertionError(f"the region-form mirrors disagree: {bad}")
    geo = {k: of("windowed_warp", "vr_windowed_warp_geometry", k, n=3)[2]
           for k in (K11_EDGE - 1, K11_EDGE)}
    vol = torch.zeros((4, 16, 15, 16), device="cuda")
    tgt = torch.zeros((16, 15, 16), device="cuda")
    before = cuda.LAUNCHES["windowed_warp"]
    try:
        wp.windowed_warp(vol, tgt, tgt, tgt, K11_EDGE)
        refused = ""
    except ValueError as e:
        refused = str(e)
    launched = cuda.LAUNCHES["windowed_warp"] - before
    fits = {k: b + tmp.TILE_STATIC_SHARED <= MAX_SHARED_BYTES
            for k, b in geo.items()}
    log(f"# K11 at k = {K11_EDGE - 1} and {K11_EDGE}: {json.dumps(geo)} "
        f"bytes of region (fits beside its static terms: "
        f"{json.dumps(fits)}); at {K11_EDGE} the wrapper refuses "
        f"({refused!r}), launches {launched}")
    if "K11's region does not fit" not in refused or launched \
            or fits != {K11_EDGE - 1: True, K11_EDGE: False} \
            or any(b != wp.k11_shared_bytes(k) for k, b in geo.items()):
        raise AssertionError("K11's window mirror disagrees with the "
                             "launcher at k = 108")


def forced_region_holds(renderers, runs, scene, demo, arm_work,
                        cuda) -> dict:
    """K2 (radiance, rays, baked), K5 and K10 (weight, alpha) forced into
    their region_global form at k = 4 and 51, K3 at k = 4 and 158 (the
    region_shared forms' widest windows), on the inputs of the fused
    path's frame 4 at 240x135x128 (the rays and baked modes on
    fused_exact's and fused_vis's tables of that frame; K10 blending the
    shadow and accumulation histories into half of each), and K2
    (radiance) on demo_full's frame 4 and K5 on demo_exact_hf's frame 2
    (demo_scene: the terrain arm's instantiations; their bounds main()'s
    terrain rows', arm_work): each = the region_shared form bit for bit, its
    launches counted under its region form and the pre-pass, held against
    its twin at that window and timed in turns against the region_shared
    form (shared, global, global, shared). Returns {(kernel, mode): row of
    the kernels line}."""
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import visibility as vis
    prev = runs["fused"][1][3]
    t4 = renderers["fused"].frame_tables(prev, scene, 0.3)[0]
    xt4 = renderers["fused_exact"].frame_tables(prev, scene, 0.3)[0]
    vt4 = renderers["fused_vis"].frame_tables(prev, scene, 0.3)[0]
    p_sh = prev.prev_shadow.float().contiguous()
    acc = prev.prev_accumulation.float().contiguous()
    bake = ff.bake_radiance(t4)
    vvol = vis.bake_visibility(vt4)
    sc = ff.shadow_scatter(t4, p_sh, bake)[1]
    cur_sh, cur_acc = 0.5 * p_sh, 0.5 * acc
    d_prev = runs["demo_full"][1][3]
    td = renderers["demo_full"].frame_tables(d_prev, demo, 0.3)[0]
    d_sh = d_prev.prev_shadow.float().contiguous()
    d_bake = ff.bake_radiance(td)
    x_prev = runs["demo_exact_hf"][1][1]
    tx = renderers["demo_exact_hf"].frame_tables(x_prev, demo, 0.1)[0]
    x_sh = x_prev.prev_shadow.float().contiguous()
    blend = lambda t, prv, cur, mode, f: tmp.temporal_blend(
        t.sbpar if mode == "weight" else t.abpar, prv, cur, t.grid_whd,
        t.h_glob, t.k, mode, form=f)
    blend_plain = lambda t, prv, cur, mode: tmp.temporal_blend_plain(
        t.sbpar if mode == "weight" else t.abpar, prv, cur, t.grid_whd,
        t.h_glob, t.k, mode)
    # (kernel, mode) -> (fn(tables, form), twin(tables), tables, work)
    cases = {
        ("shadow_scatter", "radiance"): (
            lambda t, f: ff.shadow_scatter(t, p_sh, bake, form=f),
            lambda t: ff.shadow_scatter_plain(t, p_sh, bake), t4,
            fused_work(t4, "shadow_scatter")),
        ("shadow_scatter", "rays"): (
            lambda t, f: ff.shadow_scatter(t, p_sh, form=f),
            lambda t: ff.shadow_scatter_plain(t, p_sh), xt4,
            fused_work(xt4, "shadow_scatter", "rays")),
        ("shadow_scatter", "baked"): (
            lambda t, f: ff.shadow_scatter(t, p_sh, None, vvol, form=f),
            lambda t: ff.shadow_scatter_plain(t, p_sh, None, vvol), vt4,
            fused_work(vt4, "shadow_scatter", "baked")),
        ("shadow_blend", ""): (
            lambda t, f: sb.dir_shadow_blend(t, p_sh, form=f),
            lambda t: sb.dir_shadow_blend_plain(t, p_sh), t4,
            fused_work(t4, "shadow_blend")),
        ("temporal_blend", "weight"): (
            lambda t, f: blend(t, p_sh, cur_sh, "weight", f),
            lambda t: blend_plain(t, p_sh, cur_sh, "weight"), t4,
            blend_work(tuple(p_sh.shape), "temporal_blend")),
        ("temporal_blend", "alpha"): (
            lambda t, f: blend(t, acc, cur_acc, "alpha", f),
            lambda t: blend_plain(t, acc, cur_acc, "alpha"), t4,
            blend_work(tuple(acc.shape), "temporal_blend")),
        ("integrate_blend", ""): (
            lambda t, f: ff.integrate_blend(t, sc, acc, form=f),
            lambda t: ff.integrate_blend_plain(t, sc, acc), t4,
            fused_work(t4, "integrate_blend")),
        ("shadow_scatter", "terrain"): (
            lambda t, f: ff.shadow_scatter(t, d_sh, d_bake, form=f),
            lambda t: ff.shadow_scatter_plain(t, d_sh, d_bake), td,
            arm_work[("shadow_scatter", "terrain")]),
        ("shadow_blend", "terrain"): (
            lambda t, f: sb.dir_shadow_blend(t, x_sh, form=f),
            lambda t: sb.dir_shadow_blend_plain(t, x_sh), tx,
            arm_work[("shadow_blend", "terrain")]),
    }
    as_tuple = lambda v: v if isinstance(v, tuple) else (v,)
    rows = {}
    for (kernel, mode), (fn, twin, t0, work) in cases.items():
        for k in (4, REGION_EDGE[kernel] - 1):
            t = dataclasses.replace(t0, k=k)
            label = f"{kernel} {mode} k = {k}".replace("  ", " ")
            torch.cuda.synchronize()
            before = cuda.region_launches(kernel)
            want = as_tuple(fn(t, None))
            got = as_tuple(fn(t, "region_global"))
            torch.cuda.synchronize()
            moved = tuple(a - b for a, b in
                          zip(cuda.region_launches(kernel), before))
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            log(f"# {label}: region_global forced = the region_shared form "
                f"bit for bit: {same}; launches (region_shared, "
                f"region_global, pre-pass) {moved}")
            if not same or moved != (1, 1, 1):
                raise AssertionError(f"{label}: region_global differs from "
                                     f"the region_shared form, or the forms "
                                     f"{moved}")
            del want
            plain, plain_ms = timed_plain(lambda: as_tuple(twin(t)))
            err = max(compare(kernel, g, p_,
                              label=f"{label}, region_global forced")
                      for g, p_ in zip(got, plain))
            del got, plain
            slow = mode in ("rays", "baked")
            sh_ms, gl_ms = in_turns(lambda: fn(t, None),
                                    lambda: fn(t, "region_global"),
                                    3 if slow else 10)
            b_ms, b_by = bound(*work)
            m = "_".join(x for x in ("region_global", f"k{k}", mode) if x)
            rows[(kernel, m)] = {
                "launches": 0, "paths": [], "max_abs_err": err,
                "ms": sum(gl_ms) / 2, "ms_turns": gl_ms,
                "shared_ms": sum(sh_ms) / 2, "shared_ms_turns": sh_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None,
                "held": "the region_shared form, bit for bit; the twin"}
            log(f"# {kernel}, {m}: {gl_ms[0]:.4f} {gl_ms[1]:.4f} ms/call, "
                f"the region_shared form {sh_ms[0]:.4f} {sh_ms[1]:.4f} "
                f"({sum(gl_ms) / sum(sh_ms):.3f}x), bound {b_ms:.4f} ms by "
                f"{b_by}, twin {plain_ms:.1f} ms, max abs err {err:.3e}")
    return rows


def region_crossings(cfg, scene, scene_color, view_depth, bakes,
                     cuda) -> dict:
    """REGION_PATHS through VolumetricRenderer, each from a fresh state
    through to K4 with its launches, index forms and region forms counted
    (every source past its REGION_EDGE in its region_global form, wide,
    with one pre-pass a launch; every other launch narrow), then the last
    frame's region_global launches held against their twins on the whole
    grid: K2 (fused_k52, fused_k159; = K5 then K6 bit for bit, both in
    their region_global form), K3 (fused_k159; fused_k52's region_shared
    launch too), K5 (staged_k52, history_k107), K10's weight mode
    (map_dir_k52) and alpha mode (history_k107, where K11's two launches
    take their region_shared form at its widest window, also held).
    Returns {(kernel, mode): row of the kernels line}."""
    from volumetricrenderer_tpu_torch import VolumetricRenderer
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import scatter as sca
    from volumetricrenderer_tpu_torch.ops import shadow_blend as sb
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import warp as wp
    rows = {}
    for name, (kw, k, frames, kernels) in REGION_PATHS.items():
        expect = dict(x if isinstance(x, tuple) else (x, 1) for x in kernels)
        past = {s for s, edge in REGION_EDGE.items() if k >= edge}
        forms = {s: (0, frames * e) if s in past else (frames * e, 0)
                 for s, e in expect.items() if s in cuda.INDEX_SOURCES}
        want_region = {
            s: {"region_global": frames * e, "region_pass": frames * e}
            if s in past else {"region_shared": frames * e}
            for s, e in expect.items() if s in cuda.REGION_SOURCES}
        r = VolumetricRenderer(dataclasses.replace(cfg, reproj_window=k,
                                                   **kw))
        before = {s: cuda.region_launches(s) for s in cuda.REGION_SOURCES}
        _, _, rec, _, _ = drive_wide(
            name, r, scene, scene_color, view_depth, frames, expect, forms,
            cuda, shadow_data=bakes["map_dir"] if kw is MAP_DIR else None)
        got_region = {}
        for s in cuda.REGION_SOURCES:
            moved = {f: a - b for f, a, b in zip(
                cuda.REGION_COUNTS, cuda.region_launches(s), before[s])
                if a != b}
            if moved:
                got_region[s] = moved
        log(f"# {name}: k = {k}, launches by region form "
            f"{json.dumps(got_region)}")
        if got_region != want_region:
            raise AssertionError(f"{name}: launches by region form "
                                 f"{got_region}, not {want_region}")

        def row(kernel, fn, work, err, plain_ms, n=10):
            rows[(kernel, f"region_global_{name}")] = wide_row(
                kernel, f"region_global_{name}", fn, n, work, err, plain_ms,
                frames, "the twin, whole grid")

        if "shadow_scatter" in rec:
            (t, p_sh, bake, vis_), (sh, sc) = rec["shadow_scatter"]
            want, plain_ms = timed_plain(lambda: ff.shadow_scatter_plain(
                t, p_sh, bake, vis_))
            err = max(compare("shadow_scatter", a, b, label=f"{name}, {lab}")
                      for a, b, lab in zip((sh, sc), want,
                                           ("history", "planes")))
            del want
            sh_b = sb.dir_shadow_blend(t, p_sh)
            same = torch.equal(sh_b, sh) and torch.equal(
                sca.scatter_local(t, sh_b, bake, vis_), sc)
            log(f"# {name}: K2's history and planes = K5 then K6 bit for "
                f"bit (K5 region_global): {same}")
            if not same:
                raise AssertionError(f"{name}: K2 differs from K5 then K6")
            del sh_b, sh, sc
            row("shadow_scatter", lambda: ff.shadow_scatter(t, p_sh, bake,
                                                            vis_),
                fused_work(t, "shadow_scatter"), err, plain_ms)
        if "integrate_blend" in rec and name.startswith("fused"):
            (t, sc, acc), out = rec["integrate_blend"]
            want, plain_ms = timed_plain(
                lambda: ff.integrate_blend_plain(t, sc, acc))
            err = compare("integrate_blend", out, want,
                          label=f"{name}, k = {k}")
            del want, out
            if "integrate_blend" in past:
                row("integrate_blend",
                    lambda: ff.integrate_blend(t, sc, acc),
                    fused_work(t, "integrate_blend"), err, plain_ms)
        if "shadow_blend" in rec:
            (t, p_sh), sh = rec["shadow_blend"]
            want, plain_ms = timed_plain(
                lambda: sb.dir_shadow_blend_plain(t, p_sh))
            err = compare("shadow_blend", sh, want, label=f"{name}, k = {k}")
            del want, sh
            row("shadow_blend", lambda: sb.dir_shadow_blend(t, p_sh),
                fused_work(t, "shadow_blend"), err, plain_ms)
        if "temporal_blend" in rec:
            args, out = rec["temporal_blend"]
            want, plain_ms = timed_plain(
                lambda: tmp.temporal_blend_plain(*args))
            err = compare("temporal_blend", out, want,
                          label=f"{name}, {args[6]} mode, k = {k}")
            del want, out
            row("temporal_blend", lambda: tmp.temporal_blend(*args),
                blend_work(tuple(args[1].shape), "temporal_blend"), err,
                plain_ms)
        if "windowed_warp" in rec:
            args, out = rec["windowed_warp"]
            compare("windowed_warp", out, wp.windowed_warp_plain(*args),
                    label=f"{name}, k = {k}, K11's widest window")
            del out
        del rec
        torch.cuda.empty_cache()
    return rows


def region_edge_paths(cfg, scene, demo, renderers, runs, scene_color,
                      view_depth, bakes, arm_work, cuda) -> dict:
    """The region forms past a block's shared memory: the mirrors
    (region_form_mirrors), the forced holds at 240x135x128
    (forced_region_holds), then the crossings (region_crossings). Returns
    {(kernel, mode): row of the kernels line}."""
    from volumetricrenderer_tpu_torch.ops import frame_fused as ff
    from volumetricrenderer_tpu_torch.ops import temporal as tmp
    from volumetricrenderer_tpu_torch.ops import warp as wp
    t_phase = time.perf_counter()

    def done(name):
        log(f"# elapsed in the region phase "
            f"{time.perf_counter() - t_phase:.1f} s: {name}")

    region_form_mirrors(ff, tmp, wp, cuda)
    rows = forced_region_holds(renderers, runs, scene, demo, arm_work,
                               cuda)
    done("mirrors and forced holds")
    rows.update(region_crossings(cfg, scene, scene_color, view_depth, bakes,
                                 cuda))
    done("crossings")
    return rows


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
    done = lambda what: log(f"# elapsed {time.perf_counter() - t_start:.1f} "
                            f"s: {what} done")
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
    # the raster phase's CPU side starts now and is joined after the holds
    gbuf_tmp = tempfile.mkdtemp()
    gbuf_proc = start_cpu_gbuffer(gbuf_tmp)

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
    # the mesh environment: demo_scene(mesh_env=True), the tree meshes
    # (procedural without the reference checkout) and 20 proxy boxes
    mesh_cfg, mesh = mesh_inputs("cuda")
    if mesh_cfg != renderers["mesh_production"].config:
        raise AssertionError("the raster phase's config is not "
                             "mesh_production's")
    log(f"# mesh scene: {mesh.mesh.num_tris} triangles, "
        f"{mesh.geometry.box_min.shape[0]} boxes of which "
        f"{mesh.geometry.n_proxy_boxes} shadow proxies, "
        f"{int((mesh.geometry.box_opacity < 1.0).sum())} fractional")
    # benchmark_scene with 9 suns and 9 procedural noise media
    many = many_suns_scene(scene, 9, 9)
    scenes = {"demo": demo, "fractional": frac, "tex": tex_scene,
              "sunless": sunless, "no_media": no_media,
              "demo_noise": demo_noise, "mesh": mesh, "many": many}
    scene_key = {name: v[0] for name, v in {**DEMO_PATHS,
                                             **SCENE_PATHS}.items()}
    scene_of = lambda name: scenes[scene_key[name]] \
        if name in scene_key else scene
    slab_scene_of = lambda name: scenes[SLAB_SCENES[name]] \
        if name in SLAB_SCENES else scene
    t0 = time.perf_counter()
    sunless_gbuf = renderer.render_scene_inputs(sunless)
    torch.cuda.synchronize()
    log(f"# gbuffer without the sun: "
        f"{1e3 * (time.perf_counter() - t0):.1f} ms")
    t0 = time.perf_counter()
    many_gbuf = renderer.render_scene_inputs(many)
    torch.cuda.synchronize()
    log(f"# gbuffer with 9 suns: {1e3 * (time.perf_counter() - t0):.1f} ms")
    demo_gbuf = {}
    for size, name in ((1080, "demo_full"), (720, "demo_production")):
        t0 = time.perf_counter()
        demo_gbuf[size] = renderers[name].render_scene_inputs(demo)
        torch.cuda.synchronize()
        log(f"# gbuffer demo_scene {size}p: "
            f"{1e3 * (time.perf_counter() - t0):.1f} ms "
            f"{tuple(demo_gbuf[size][0].shape)}")
    mesh_gbuf = raster_phase(renderers, mesh, cuda)

    def gbuf(name):
        if name.startswith("uhd"):
            return color_4k, depth_4k
        if scene_key.get(name) == "mesh":
            return mesh_gbuf[renderers[name].config.image_height]
        if name in DEMO_PATHS or name == "demo_noise":
            return demo_gbuf[renderers[name].config.image_height]
        if name == "sunless":
            return sunless_gbuf
        if scene_key.get(name) == "many":
            return many_gbuf
        return scene_color, view_depth

    done("the G-buffers and the raster phase")
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
            before = {src: cuda.form_launches(src)
                      for src in cuda.FORM_SOURCES}
            before_ix = {src: cuda.index_form_launches(src)
                         for src in cuda.INDEX_SOURCES}
            runs[name] = drive(name, renderers[name], scene_of(name),
                               *gbuf(name), cuda, bakes[name])
            check_forms(name, before, runs[name][2], cuda)
            # the narrow forms wherever they fit: every main path's
            for src, (narrow, wide) in index_deltas(cuda, before_ix).items():
                if (narrow, wide) != (runs[name][2][src], 0):
                    raise AssertionError(
                        f"path {name}: {src} launched (narrow, wide) forms "
                        f"{narrow, wide}")
    finally:
        pipeline.write_scatter_xla = real_xla
    if sorted(xla_args) != sorted(XLA_SCATTER_PATHS):
        raise AssertionError(f"the XLA scatter ran on {sorted(xla_args)}, "
                             f"not on {sorted(XLA_SCATTER_PATHS)}")
    # the post stack on the fused frame; the SSR march's inputs of each
    # post path's last frame are kept for K13's checks
    march_by, marching = {}, [None]
    real_march = ssr_ops.ssr_march

    def recording_march(*args):
        march_by[marching[0]] = args
        return real_march(*args)

    ssr_ops.ssr_march = recording_march
    try:
        for name in POST_PATHS:
            marching[0] = name
            runs[name] = drive_post(name, renderers["fused"], post, scene,
                                    scene_color, view_depth, cuda)
    finally:
        ssr_ops.ssr_march = real_march
    march_args = [march_by["post_showcase"]]
    # the slab paths through make_multislab_render, each shard's G-buffer
    # band bound as fixed_inputs (bench.py's run_slabn)
    slab_fns, slab_runs = {}, {}
    for name, (kw, n_sh, _, _) in SLAB_PATHS.items():
        s_r = VolumetricRenderer(dataclasses.replace(cfg, **kw))
        slab_fns[name] = (s_r, shr.make_multislab_render(
            s_r, n_sh, fixed_inputs=(list(scene_color.chunk(n_sh)),
                                     list(view_depth.chunk(n_sh)))))
        slab_runs[name] = drive_slab(name, slab_fns[name][1],
                                     slab_scene_of(name), cuda)
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

    done("the main paths")
    # from here to the end of the holds every hold of K2, K3 and K5-K12 is
    # repeated in the wide form (WideHolds)
    WIDE.install(wide_wrappers(ff, vis, sb, sca, ds, integ, tmp, wp, pcf))
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
        "integrate_blend", acc, ff.integrate_blend_plain(tables, sc, prev_acc),
        label="fused frame 4")
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
    # the general forms' dynamic shared memory (the suns' inverse
    # directions; K2's also where 4 suns take it for 5 fBm channels)
    gen_buf = (cuda.ctypes.c_int * 1)()
    gen_p = cuda.ctypes.cast(gen_buf, cuda.ctypes.c_void_p)
    for kw in (0, cfg.reproj_window, 25):
        for nd_, nn_ in ((4, 5), (5, 0), (9, 9), (1000, 0)):
            cuda.lib("shadow_scatter").vr_shadow_scatter_general_shared(
                kw, nd_, gen_p)
            if gen_buf[0] != ff.k2_shared_bytes(kw, nd_, nn_):
                raise AssertionError(
                    f"K2's general shared bytes at k={kw}, {nd_} suns: "
                    f"{gen_buf[0]} in the kernel, "
                    f"{ff.k2_shared_bytes(kw, nd_, nn_)} in ops/frame_fused")
            if nd_ <= sca.MAX_DIR:
                continue
            cuda.lib("shadow_blend").vr_shadow_blend_general_shared(
                kw, nd_, gen_p)
            if gen_buf[0] != sb.k5_shared_bytes(kw, nd_):
                raise AssertionError(
                    f"K5's general shared bytes at k={kw}, {nd_} suns: "
                    f"{gen_buf[0]} in the kernel, "
                    f"{sb.k5_shared_bytes(kw, nd_)} in ops/shadow_blend")
            cuda.lib("dir_shadow").vr_dir_shadow_general_shared(nd_, gen_p)
            if gen_buf[0] != ds.k7_shared_bytes(nd_):
                raise AssertionError(
                    f"K7's general shared bytes at {nd_} suns: "
                    f"{gen_buf[0]} in the kernel, "
                    f"{ds.k7_shared_bytes(nd_)} in ops/dir_shadow")
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
                 (40, 1, (60, 34, 32)), (16, 9, (60, 34, 32)),
                 (0, 5, (13, 5, 3)), (40, 300, (60, 34, 32)))
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
    # K15's tile, shared bytes and code plane at the same tables, on
    # post_showcase's planes with offsets over its 2 x 56 pixels on each
    # axis, none, and an odd span on a ragged plane
    k15_geo = (cuda.ctypes.c_int * 5)()
    for nb, nt in ((8, 12), (16, 24), (1, 1), (4, 32)):
        for hq_, wq_, sy, sx in ((270, 480, 112, 112), (270, 480, 0, 0),
                                 (33, 65, 37, 5)):
            cuda.lib("ssr_march_grad").vr_ssr_march_grad_geometry(
                nb, nt, hq_, wq_, sy, sx,
                cuda.ctypes.cast(k15_geo, cuda.ctypes.c_void_p))
            want = (*ssr_ops.K15_TILE, ssr_ops.k15_shared_bytes(nb, nt),
                    *ssr_ops.k15_code_shape(hq_, wq_, sy, sx))
            if tuple(k15_geo) != want:
                raise AssertionError(
                    f"K15's tile, shared bytes and code plane at {nb} bins "
                    f"of {nt} taps, {hq_}x{wq_} over a {sy}x{sx} span: "
                    f"{tuple(k15_geo)} in the kernel, {want} in ops/ssr")
    # K13's and K15's forms by the size rule at (bins, taps a bin): the
    # tables of ssr_steps / ssr_dirs 12 / 8, 24 / 16, 48 / 8, 64 / 16,
    # 96 / 64 and 96 / 128, and the edges of each placement and code width
    form_of = (cuda.ctypes.c_int * 1)()
    for nb, nt in ((8, 12), (16, 24), (8, 33), (16, 39), (64, 54),
                   (128, 54), (96, 32), (450, 32), (451, 32), (268, 54),
                   (500, 65), (600, 56), (1, 1)):
        for src, mirror, names in (
                ("ssr_march", ssr_ops.k13_form, ssr_ops.K13_FORMS),
                ("ssr_march_grad", ssr_ops.k15_form, ssr_ops.K15_FORMS)):
            getattr(cuda.lib(src), f"vr_{src}_form_of")(
                nb, nt, cuda.ctypes.cast(form_of, cuda.ctypes.c_void_p))
            if names[form_of[0]] != mirror(nb, nt):
                raise AssertionError(
                    f"{src}'s form at {nb} bins of {nt} taps: "
                    f"{names[form_of[0]]} in the kernel, {mirror(nb, nt)} "
                    "in ops/ssr")
    # K14's chunk plan (chunks, slices a chunk, shared bytes) at the
    # training footprints, one launch up to 851 slices and chunks past
    k14_plan = (cuda.ctypes.c_int * 3)()
    for d_ in (64, 128, 830, 851, 852, 1024, 4096):
        fw_ = zg.grad_footprint(720, 1280, (160, 88, d_), "pixels")[1]
        cuda.lib("composite_grad").vr_composite_grad_plan(
            d_, fw_, cuda.ctypes.cast(k14_plan, cuda.ctypes.c_void_p))
        n_, zc_ = zg.k14_chunks(d_, fw_)
        want = (n_, zc_, zg.k14_shared_bytes(zc_, fw_))
        if tuple(k14_plan) != want:
            raise AssertionError(f"K14's chunk plan at {d_} slices: "
                                 f"{tuple(k14_plan)} in the kernel, {want} "
                                 "in ops/zg_composite")
    # K14's tile, threads, rows a chunk and shared bytes at the training
    # grids' slices and their widest footprints (zg_composite.
    # grad_footprint)
    k14_geo = (cuda.ctypes.c_int * 5)()
    for form_, (k4_form, (ih_, iw_), grid_, _) in K14_FORMS.items():
        fw_ = zg.grad_footprint(ih_, iw_, grid_, k4_form)[1]
        for d_ in (grid_[2], 1):
            cuda.lib("composite_grad").vr_composite_grad_geometry(
                d_, fw_, cuda.ctypes.cast(k14_geo, cuda.ctypes.c_void_p))
            want = (*zg.K14_TILE, zg.K14_THREADS, zg.K14_ROWS,
                    zg.k14_shared_bytes(d_, fw_))
            if tuple(k14_geo) != want:
                raise AssertionError(
                    f"K14's tile, threads, rows and shared bytes at {d_} "
                    f"slices and footprints {fw_} wide ({form_}): "
                    f"{tuple(k14_geo)} in the kernel, {want} in "
                    "ops/zg_composite")
    k14_720 = zg.k14_shared_bytes(64, zg.grad_footprint(
        720, 1280, (160, 88, 64), "pixels")[1])
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
        f"{ssr_ops.k13_shared_bytes(8, 12)} B at 8 bins of 12 taps, K15 "
        f"{ssr_ops.K15_TILE} with {ssr_ops.k15_shared_bytes(8, 12)} B and "
        f"a {ssr_ops.k15_code_shape(270, 480, 112, 112)} code plane at 8 "
        f"bins of 12 taps over 112 x 112 pixels, K14 {zg.K14_TILE} "
        f"with {k14_720} B at 720p on 160x88x64 (per pixel)")

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
        tables.sbpar, prev_sh, unblended, whd, hg, kk, "weight"),
        label="weight mode")
    errs["temporal_blend"] = compare(
        "temporal_blend", blend_a(), tmp.temporal_blend_plain(
            tables.abpar, prev_acc, acc_un, whd, hg, kk, "alpha"),
        label="alpha mode")
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
                                      vis.bake_visibility_plain(h_tables),
                                      label="history frame")
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
                                 pcf.pcf_shadow_plain(pcf_low, m_dir.atlas),
                                 label="low rate")
    full_err = compare("pcf_shadow", pcf.pcf_shadow(pcf_full, f_dir.atlas),
                       pcf.pcf_shadow_plain(pcf_full, f_dir.atlas),
                       label="full rate")
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
    # K12 on many_suns_map_dir's frame 2: its 9 suns in one launch
    md_r = renderers["many_suns_map_dir"]
    pcf9 = md_r.pcf_tables(runs["many_suns_map_dir"][1][1], many,
                           bakes["many_suns_map_dir"][0])
    atlas9 = bakes["many_suns_map_dir"][0].atlas
    k12_nine = pcf.pcf_shadow(pcf9, atlas9)
    if k12_nine.shape[0] != 9:
        raise AssertionError(f"K12 on 9 suns: {tuple(k12_nine.shape)}")
    errs["pcf_shadow"] = max(errs["pcf_shadow"], compare(
        "pcf_shadow", k12_nine, pcf.pcf_shadow_plain(pcf9, atlas9),
        label="nine suns"))
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
    # K13's RECORD instance (SsrMarchFn's forward) on the same inputs: its
    # five outputs = the no-grad instance's bit for bit, its hit record =
    # the twin's; then K15 (the march's backward) on that record and a
    # seeded random cotangent against ssr_march_grad_plain: max abs err 0
    k13_rec = ssr_ops.ssr_march(*m_args, record=True)
    k13_rec_p = ssr_ops.ssr_march_reference(*m_args, record=True)
    rec_same = torch.equal(torch.stack(k13_rec[:5]), k13)
    rec_err = compare("ssr_march", torch.stack(k13_rec[:5]),
                      torch.stack(k13_rec_p[:5]), "record")
    rec_hits = float((k13_rec[5] >= 0).float().mean())
    log(f"# ssr_march, record instance: outputs = the no-grad instance's "
        f"bit for bit: {rec_same}; hit record = the twin's: "
        f"{torch.equal(k13_rec[5], k13_rec_p[5])} (dtype "
        f"{k13_rec[5].dtype}, share of pixels with a hit {rec_hits:.4f})")
    if not rec_same or not torch.equal(k13_rec[5], k13_rec_p[5]) \
            or abs(rec_hits - hit_share) > 1e-6:
        raise AssertionError("K13's record instance differs from the "
                             "no-grad instance or its hit record from the "
                             "twin's")
    k15_gen = torch.Generator(device="cuda")
    k15_gen.manual_seed(23)
    k15_args = ([torch.randn((hq, wq), generator=k15_gen, device="cuda")
                 for _ in range(3)], m_args[4], k13_rec[5], m_args[6],
                m_args[8])
    k15 = torch.stack(ssr_ops.ssr_march_grad(*k15_args))
    k15_p = torch.stack(ssr_ops.ssr_march_grad_plain(*k15_args[:4]))
    errs["ssr_march_grad"] = compare("ssr_march_grad", k15, k15_p)
    k15_again = torch.stack(ssr_ops.ssr_march_grad(*k15_args))
    k15_fed = float((k15 != 0).float().mean())
    log(f"# ssr_march_grad: {hq}x{wq} planes on post_showcase's march, "
        f"offsets over {ssr_ops.tap_extent(m_args[6])}, share of source "
        f"pixels fed {k15_fed:.4f}, equal to its twin bit for bit: "
        f"{torch.equal(k15, k15_p)}; two launches bit for bit equal: "
        f"{torch.equal(k15, k15_again)}")
    if not torch.equal(k15, k15_p) or not k15_fed > 0.0 \
            or not torch.equal(k15, k15_again):
        raise AssertionError("K15 differs from its twin or from its own "
                             "second launch, or feeds no pixel")
    # K13 and K15 in every form that can take each table
    ssr_rows, ssr_errs = ssr_form_holds(ssr_ops, post, march_by, scene_color,
                                        view_depth)
    for k, e in ssr_errs.items():
        errs[k] = max(errs[k], e)

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
    # the mesh scene (23 boxes in the any-hit loops, 20 of them
    # fractional): K1 and K2 on mesh_full's frame 4
    ms_tables, ms_params, ms_sh = path_tables("mesh_full", 3)
    ms_bake = ff.bake_radiance(ms_tables)
    arm_calls["bake_radiance"]["mesh"] = (
        lambda: ff.bake_radiance(ms_tables),
        lambda: ff.bake_radiance_plain(ms_tables))
    arm_calls["shadow_scatter"]["mesh"] = (
        lambda: ff.shadow_scatter(ms_tables, ms_sh, ms_bake),
        lambda: ff.shadow_scatter_plain(ms_tables, ms_sh, ms_bake))
    log(f"# mesh_full's tables: {ms_tables.n_boxes} boxes, fractional "
        f"{bool(ms_tables.fractional)}")
    if ms_tables.n_boxes != 23 or not ms_tables.fractional:
        raise AssertionError("mesh_full's tables lack the proxy boxes")
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
    # the mesh scene: on mesh_full's frame 4 K3 and K4 after K1 and K2, and
    # on mesh_production's frame 2 K1-K4 at the demo grid (K4's per-pixel
    # form), each chain reproducing its path's image bit for bit
    for name, i, gb in (("mesh_full", 3, mesh_gbuf[1080]),
                        ("mesh_production", 1, mesh_gbuf[720])):
        m_tables, m_params, m_sh = path_tables(name, i)
        m_prev_acc = runs[name][1][i].prev_accumulation.float().contiguous()
        m_grid = renderers[name].config.grid
        label = f"{name} frame {i + 1}"
        m_bake = ms_bake if name == "mesh_full" \
            else ff.bake_radiance(m_tables)
        m_sc = ff.shadow_scatter(m_tables, m_sh, m_bake)[1]
        m_acc = ff.integrate_blend(m_tables, m_sc, m_prev_acc)
        if name == "mesh_full":
            m_out = zg.composite(m_acc, *gb, m_params, m_grid)
            m_twin = zg.composite_plain(m_acc, *gb, m_params, m_grid)
        else:
            m_out = zg.composite_pixels(m_acc, *gb, m_params, m_grid)
            m_twin = zg.composite_pixels_plain(m_acc, *gb, m_params, m_grid)
            errs["bake_radiance"] = max(errs["bake_radiance"], compare(
                "bake_radiance", m_bake, ff.bake_radiance_plain(m_tables),
                label=label))
            errs["shadow_scatter"] = max(errs["shadow_scatter"], *(
                compare("shadow_scatter", g, w_, label=f"{label}, {part}")
                for g, w_, part in zip(
                    ff.shadow_scatter(m_tables, m_sh, m_bake),
                    ff.shadow_scatter_plain(m_tables, m_sh, m_bake),
                    ("history", "planes"))))
        errs["integrate_blend"] = max(errs["integrate_blend"], compare(
            "integrate_blend", m_acc,
            ff.integrate_blend_plain(m_tables, m_sc, m_prev_acc),
            label=label))
        errs["composite"] = max(errs["composite"], compare(
            "composite", m_out, m_twin, label=label))
        same = torch.equal(m_out, runs[name][0])
        log(f"# {label}: K1-K4 reproduce the path's image bit for bit: "
            f"{same}")
        if not same:
            raise AssertionError(f"K1-K4 on {label}'s inputs differ from "
                                 "the path's image")
    del m_sc, m_acc, m_out, m_twin

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
    # K12's slab form on slab3_map_dir's middle shard at its frame 2: the
    # shard's own maps (every shard bakes them in its frame), its tables
    # with the global grid's rows and the slab's y0
    r_loc, slab, st_i, _ = slab_shard("slab3_map_dir", 1, 1)
    scene_1 = slab_scene(scene, 1)
    md_dir = r_loc.bake_shadow_data(scene_1)[0]
    t_md = r_loc.pcf_tables(st_i, scene_1, md_dir, slab)
    log(f"# pcf_shadow, slab3_map_dir shard 1: grid {t_md.grid_whd}, global "
        f"rows {t_md.h_glob}, y0 {float(t_md.par[0, 21]):g}, active "
        f"cascades per slice {t_md.count[0].tolist()}")
    if t_md.h_glob != cfg.volume_height or float(t_md.par[0, 21]) != \
            slab.y0:
        raise AssertionError("K12's slab tables miss the global rows")
    slab_err[("pcf_shadow", "slab_map_dir")] = compare(
        "pcf_shadow", pcf.pcf_shadow(t_md, md_dir.atlas),
        pcf.pcf_shadow_plain(t_md, md_dir.atlas),
        label="slab3_map_dir shard 1")
    slab_in["slab_map_dir"] = (t_md, md_dir.atlas)
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
    new_slabs = ("slab3_map_dir", "slab3_xla", "slab3_tex")
    for name in ("slab3", "slab3_staged") + new_slabs:
        s_r = slab_fns[name][0]     # slab5 renders slab3's frames
        s_scene = slab_scene_of(name)
        s_st = s_r.init_state(s_scene.dir_lights.count)
        for i in range(SLAB_PATHS[name][2]):
            refs[name], _, s_st = s_r.render_frame(
                s_st, slab_scene(s_scene, i), 0.1 * i, scene_color,
                view_depth)
    refs["slab5"] = refs["slab3"]
    h_g, ih_g = cfg.volume_height, cfg.image_height
    fy = (torch.arange(ih_g, device="cuda") + 0.5) * h_g / ih_g - 0.5
    inner = (fy.floor() >= SLAB_EDGE) & (fy.ceil() <= h_g - 1 - SLAB_EDGE)
    for name in new_slabs:
        img, ref = runs[name][0], refs[name]
        err = (img - ref).abs()
        past = err > 1e-5 + 1e-4 * ref.abs()
        rel = err / ref.abs().max()
        n_in, n_edge = int(past[inner].sum()), int(past[~inner].sum())
        log(f"# {name} against the whole grid's frame {SLAB_PATHS[name][2]}:"
            f" {n_in} elements past rtol 1e-4 / atol 1e-5 on the "
            f"{int(inner.sum())} rows reading froxel rows {SLAB_EDGE}.."
            f"{h_g - 1 - SLAB_EDGE} (max |diff| {float(err[inner].max()):.3e}"
            f"), {n_edge} on the {int((~inner).sum())} edge rows (max "
            f"relative to the image maximum {float(rel.max()):.3e}, bound "
            f"0.02); whole grid checksum "
            f"{float(ref.sum(dtype=torch.float32))!r}")
        if n_in or not float(rel.max()) < 0.02:
            raise AssertionError(f"{name} differs from the whole grid's "
                                 "image")
    for name in ("slab3", "slab5", "slab3_staged"):
        ref = refs[name]
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

    # the general forms at 4, 5 and 9 suns and fBm channels on many_suns'
    # frame 4, and their times at 9
    many_errs, many_rows = many_suns_holds(renderers, runs, scene, cuda)
    for k_, v_ in many_errs.items():
        errs[k_] = max(errs.get(k_, 0.0), v_)

    n_wide = len(WIDE.errs)
    WIDE.uninstall()
    log(f"# the wide forms forced in every hold of K2, K3 and K5-K12: "
        f"{n_wide} "
        f"holds, each = the narrow form bit for bit; the largest against the "
        f"twins: " + json.dumps({k: max(e for (k_, _), e in WIDE.errs.items()
                                        if k_ == k)
                                 for k in sorted({k for k, _ in WIDE.errs})}))
    index_form_mirrors(ff, vis, sca, cuda, tables)
    done("the holds")
    # the raster phase's CPU side, joined before the timings
    check_cpu_gbuffer(*gbuf_proc, mesh_gbuf[720], mesh,
                      renderers["mesh_production"].config)
    shutil.rmtree(gbuf_tmp)

    done("the CPU G-buffer's join")
    shardmap_phase(slab_runs["slab3"], slab_fns["slab3"][1].halo,
                   scene_color, view_depth)
    done("shardmap3")
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
                      ("xla_scatter", 5), ("mesh_full", 20),
                      ("mesh_production", 5), ("mesh_demo", 3)):
        one, _ = frame_times(name, renderers[name], scene_of(name),
                             *gbuf(name), runs[name][1][-1], n_f,
                             bakes[name])
        if name in ("demo_full", "demo_production",
                    "mesh_full") + XLA_SCATTER_PATHS:
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
                      ("demo_noise", 5), ("sunless", 10), ("no_media", 10),
                      ("many_suns", 20), ("many_suns_staged", 10),
                      ("many_suns_no_shadow_blend", 10),
                      ("many_suns_map_dir", 10)):
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
        s_scene = slab_scene_of(name)

        def one_slab(fn=fn, box=box, s_scene=s_scene):
            _, box["c"] = fn(box["c"], s_scene, 0.5)

        few = name in ("slab3_staged", "slab3_map_dir", "slab3_xla")
        n_f = 3 if few else 10
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
        profile_frames(one_slab, 2 if few else 3)
        r_loc, slab, st_i, _ = slab_shard(name, 1, 0)
        t0 = time.perf_counter()
        for _ in range(20):
            r_loc.frame_tables(st_i, s_scene, 0.5, slab)
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
        "ssr_march_grad": kernel_time_ms(
            lambda: ssr_ops.ssr_march_grad(*k15_args), n),
    }
    rec_ms = kernel_time_ms(lambda: ssr_ops.ssr_march(*m_args, record=True),
                            n)
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
        "ssr_march_grad": cuda_time_ms(
            lambda: ssr_ops.ssr_march_grad_plain(*k15_args[:4]), n_p),
    }
    rec_plain_ms = cuda_time_ms(
        lambda: ssr_ops.ssr_march_reference(*m_args, record=True), n_p)
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
        ("pcf_shadow", "slab_map_dir"): (
            lambda a=slab_in["slab_map_dir"]: pcf.pcf_shadow(*a),
            lambda a=slab_in["slab_map_dir"]: pcf.pcf_shadow_plain(*a)),
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
    # K13 and its RECORD instance (march_work), K15 (k15_work)
    work["ssr_march"] = march_work(m_args, k13_rec[5])
    rec_work = march_work(m_args, k13_rec[5], record=True)
    work["ssr_march_grad"] = k15_work(hq, wq, k13_rec[5])
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
    # the wide forms forced at the main path's shapes (240x135x128), timed
    # in turns with the narrow ones on the inputs of the holds above
    wide_forced = {
        ("shadow_scatter", "wide_forced_radiance"): (
            lambda f: ff.shadow_scatter(tables, prev_sh, bake, form=f),
            plain_ms["shadow_scatter"], work["shadow_scatter"],
            ("radiance, history", "radiance, planes"), 20),
        ("integrate_blend", "wide_forced"): (
            lambda f: ff.integrate_blend(tables, sc, prev_acc, form=f),
            plain_ms["integrate_blend"], work["integrate_blend"],
            ("fused frame 4",), 20),
        ("bake_visibility", "wide_forced"): (
            lambda f: vis.bake_visibility(h_tables, form=f),
            plain_ms["bake_visibility"], work["bake_visibility"],
            ("history frame",), 20)}
    for m, a in k2_in.items():
        wide_forced[("shadow_scatter", f"wide_forced_{m}")] = (
            lambda f, a=a: ff.shadow_scatter(a[0], a[1], vis=a[2], form=f),
            k2_plain_ms[m], k2_work[m], (f"{m}, history", f"{m}, planes"),
            5 if m == "rays" else 20)
    # the staged frame's K5, K6 (each mode held above), K7 and K8
    wide_forced.update({
        ("shadow_blend", "wide_forced"): (
            lambda f: sb.dir_shadow_blend(tables, prev_sh, form=f),
            plain_ms["shadow_blend"], work["shadow_blend"],
            ("fused frame 4",), 20),
        ("scatter", "wide_forced_radiance"): (
            lambda f: sca.scatter_local(tables, sh, bake, form=f),
            plain_ms["scatter"], work["scatter"], ("radiance x fused",), 20),
        ("scatter", "wide_forced_rays"): (
            lambda f: sca.scatter_local(x_tables, x_sh, form=f),
            per_light_plain_ms, per_light_work, ("rays x fused",), 5),
        ("dir_shadow", "wide_forced"): (
            lambda f: ds.dir_shadow(tables, form=f), plain_ms["dir_shadow"],
            work["dir_shadow"], ("main",), 20),
        ("integrate", "wide_forced"): (
            lambda f: integ.accumulate(tables, sc, form=f),
            plain_ms["integrate"], work["integrate"], ("main",), 20)})
    for m, a in k6_modes.items():
        wide_forced[("scatter", f"wide_forced_{m}")] = (
            lambda f, a=a: sca.scatter_local(*a, form=f), mode_plain_ms[m],
            mode_work[m], (m.replace("_", " x "),), 20)
    # the history and shadow-map frames' K10 (both modes), K11 and K12 (low
    # and full rate)
    wide_forced.update({
        ("temporal_blend", "wide_forced_weight"): (
            lambda f: tmp.temporal_blend(tables.sbpar, prev_sh, unblended,
                                         whd, hg, kk, "weight", form=f),
            weight_plain_ms, weight_work, ("weight mode",), 20),
        ("temporal_blend", "wide_forced_alpha"): (
            lambda f: tmp.temporal_blend(tables.abpar, prev_acc, acc_un, whd,
                                         hg, kk, "alpha", form=f),
            plain_ms["temporal_blend"], work["temporal_blend"],
            ("alpha mode",), 20),
        ("windowed_warp", "wide_forced"): (
            lambda f: wp.windowed_warp(h_prev_sc, tx, ty, tz, kk, form=f),
            plain_ms["windowed_warp"], work["windowed_warp"], ("main",), 20),
        ("pcf_shadow", "wide_forced_low"): (
            lambda f: pcf.pcf_shadow(pcf_low, m_dir.atlas, form=f),
            plain_ms["pcf_shadow"], work["pcf_shadow"], ("low rate",), 20),
        ("pcf_shadow", "wide_forced_full"): (
            lambda f: pcf.pcf_shadow(pcf_full, f_dir.atlas, form=f),
            pcf_full_plain_ms, pcf_work(pcf_full), ("full rate",), 20)})
    forced_rows = wide_forced_rows(wide_forced)
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
                      ("demo_production", dp_tables),
                      ("mesh_full", ms_tables)):
        samples["sun"][t_name] = sun_samples(t)
    samples["low"]["demo_hf_local"] = local_samples(hl_tables, True)
    samples["low"]["demo_vis_hf"] = local_samples(dv_tables, True)
    samples["full"]["demo_exact_hf"] = local_samples(dx_tables, False)
    log(f"# terrain samples marched per launch: {json.dumps(samples)}")
    arm_work = {}
    for m, t, n_s in (
            ("terrain_local", hl_tables, samples["low"]["demo_hf_local"]),
            ("demo_grid", dp_tables, 0), ("fractional", fr_tables, 0),
            ("mesh", ms_tables, 0)):
        arm_work[("bake_radiance", m)] = (
            4 * (3 + t.n_noise) * n_low_of(t),
            n_low_of(t) * (60 + ops_perlin * t.n_noise)
            + int(t.active.sum()) * plane_of(t) * (60 + geo_ops(t))
            + n_s * ops_hf(t))
    for m, t_name, t in (("terrain", "demo_full", d_tables),
                         ("demo_grid", "demo_production", dp_tables),
                         ("fractional", "fractional", fr_tables),
                         ("mesh", "mesh_full", ms_tables)):
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
    slab_work[("pcf_shadow", "slab_map_dir")] = pcf_work(
        slab_in["slab_map_dir"][0])
    # launches of each slab form in the slab paths' runs: K1 and K2 as the
    # shards' steps counted them, summed by the shards' y phase (K2's tent
    # is phased where the phase is not 0), K4 per path
    slab_launch = {}
    for name in SLAB_PATHS:
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
        launches["composite"].get(p_, 0) for p_ in SLAB_PATHS
        if p_ != "slab3_staged")
    slab_launch[("composite", "slab_pixels")] = \
        launches["composite"].get("slab3_staged", 0)
    slab_launch[("pcf_shadow", "slab_map_dir")] = \
        launches["pcf_shadow"].get("slab3_map_dir", 0)
    log(f"# y phases of the shards: {json.dumps(slab_phases)}")
    log(f"# bound inputs: {prims} primitives, {active_pairs} active "
        f"(low sample, light) pairs, {n_noise} noise channel(s), "
        f"{full_pairs} scheduled (froxel, light) pairs on the exact path, "
        f"{h_pairs} on the history path, {h_active_pairs} active (low "
        f"sample, light) pairs in its visibility bake, {k2_pairs} on K2's "
        f"frames")

    # the renderer's pass ranges with no profiler recording: host time of a
    # utils/profiling.scope (a no-op then) and of the record_function it
    # opens under a profiler
    from volumetricrenderer_tpu_torch.utils import profiling
    n_ranges = 20000
    range_us = {}
    for label, open_range in (("scope", profiling.scope),
                              ("record_function",
                               torch.profiler.record_function)):
        t0 = time.perf_counter()
        for _ in range(n_ranges):
            with open_range("composite"):
                pass
        range_us[label] = 1e6 * (time.perf_counter() - t0) / n_ranges
    log(f"# pass ranges, host time a range with no profiler recording (mean "
        f"of {n_ranges}): scope {range_us['scope']:.3f} us, "
        f"record_function {range_us['record_function']:.3f} us; a fused "
        "frame enters 2, a staged frame up to 9")
    done("the timings and bounds")
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
    # train_ssr: train_fog's frame (DEMO_CONFIG on demo_scene at 720p, its
    # maps baked once) through render_frame_post with SSR on
    train_launches["train_ssr"], train_rec["train_ssr"] = train_ssr(
        renderers["demo_xla"], demo, *demo_gbuf[720], bakes["demo_xla"],
        inverse, cuda, zg, ssr_ops, post)
    # train_ssr_hq: the same past 32 taps a bin (K13's RECORD GEN instance)
    train_launches["train_ssr_hq"], train_rec["train_ssr_hq"] = train_ssr(
        renderers["demo_xla"], demo, *demo_gbuf[720], bakes["demo_xla"],
        inverse, cuda, zg, ssr_ops, post, name="train_ssr_hq",
        post_kw=dict(TRAIN_SSR_POST, **SSR_HQ), steps=2)
    launches["ssr_march_grad"] = {
        p_: train_launches[p_]["ssr_march_grad"]
        for p_ in ("train_ssr", "train_ssr_hq")}
    k14 = k14_forms(zg, froxel, demo.camera, sample_grid, bound, cuda)
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

    done("the training phases")
    demo_entry(cuda)
    done("demo_entry")
    wide_rows = {**forced_rows,
                 **wide_paths(cfg, scene, renderer, renderers, scene_color,
                              view_depth, cuda)}
    done("the wide forms")
    wide_rows.update(shared_edge_paths(cfg, scene, renderers, runs,
                                       scene_color, view_depth, many_rows,
                                       tables, cuda))
    done("the forms past a block's shared memory")
    wide_rows.update(region_edge_paths(cfg, scene, demo, renderers, runs,
                                       scene_color, view_depth, bakes,
                                       arm_work, cuda))
    done("the region forms past a block's shared memory")

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
        # K13's and K15's forms past 32 taps a bin and 48 KB of table
        # (ssr_form_holds), each with the paths that launch it in its form
        for (k, m), row in ssr_rows.items():
            if k != name:
                continue
            paths = SSR_FORM_ROWS[(k, m)][2]
            by = {**launches[name], **{p_: c[name] for p_, c in
                                       train_launches.items() if c.get(name)}}
            entry[m] = dict(row, launches=sum(by.get(p_, 0) for p_ in paths),
                            paths=list(paths))
            log(f"# {name}, {m} (on {row['march']}'s march): "
                f"{row['ms']:.4f} ms/launch, plain "
                + (f"{row['plain_ms']:.3f} ms" if row['plain_ms'] is not None
                   else "not timed")
                + f", bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"launches {entry[m]['launches']} "
                f"({', '.join(paths) or 'held and timed only'})")
        if name == "ssr_march":
            # the RECORD instance: SsrMarchFn's forward, train_ssr's
            b_ms, b_by = bound(*rec_work)
            entry["record"] = {
                "launches": train_launches["train_ssr"]["ssr_march"],
                "paths": ["train_ssr"], "max_abs_err": rec_err,
                "ms": rec_ms, "plain_ms": rec_plain_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None}
            log(f"# ssr_march, record instance: {rec_ms:.4f} ms/launch, "
                f"plain {rec_plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}, launches {entry['record']['launches']} "
                "(train_ssr)")
        # the general forms at 9 suns and 9 fBm channels (many_suns_holds)
        for (k, m), row in many_rows.items():
            if k != name:
                continue
            entry[m] = dict(row, launches=sum(
                launches[name].get(p, 0) for p in GENERAL_PATHS[(k, m)]),
                paths=list(GENERAL_PATHS[(k, m)]))
            paths = ", ".join(GENERAL_PATHS[(k, m)]) or "held and timed only"
            log(f"# {name}, {m}: {row['ms']:.4f} ms/call, plain "
                f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"by {row['bound_by']}, launches {entry[m]['launches']} "
                f"({paths})")
        # the wide index forms: forced at 240x135x128 beside the narrow
        # ones, and at their crossings (wide_paths)
        for (k, m), row in wide_rows.items():
            if k == name:
                entry[m] = row
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
    if sys.argv[1:2] == ["--cpu-gbuffer"]:
        sys.exit(cpu_gbuffer(sys.argv[2]))
    sys.exit(main())
