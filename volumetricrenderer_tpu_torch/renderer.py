"""Frame orchestrator.

`render_frame(state, scene, time_x) -> (image, aux, new_state)` as in
`volumetricrenderer_tpu/renderer.py`, routed on the config as there, every
branch ending in the composite on K4 (ops/zg_composite.composite_frame: the
zgather and other integer-ratio composites on its pixel cells, the co-sited
composite at 1/composite_upsample, and the rowmm, anyres and "xla"
composites of any pixel/froxel ratio in its per-pixel form):

  fused    every production knob on, raycast shadows, a sun, local lights
           and media: the fused volume phase (ops/frame_fused.py), its
           local lights from the low-rate radiance bake (K1 K2 K3), from
           the low-rate visibility bake (scatter_bake="vis": K9 K2 K3) or,
           at raycast_shadow_subsample=1, from one shadow ray per froxel
           and light (K2 K3). A medium that samples a noise texture folds
           in only on the radiance bake: every medium's noise factor is
           then sampled at the bake's low grid in plain torch
           (ops/visibility.bake_noise_channels) and rides K1's radiance
           into K2;
  staged   anything else, in the pass order of the Unity reference:
           material volumes (+ blend) -> shadow (+ blend) -> scatter
           (+ blend) -> accumulate (+ blend). Each pass (pipeline.py) takes
           the kernel that stands for the JAX package's Pallas kernel on
           that route -- shadow + blend K5, or K7 then K10; the bakes K1 or
           K9 and the scatter K6; integrate + blend K3, or K8 then K10; the
           material and scatter blends K11; in the shadow-map modes the
           cascaded-PCF sun shadow K12 -- and plain torch where the JAX
           package runs plain XLA (the material volumes, the "xla" shadow
           volume and scan, the "windowed" and "gather" reprojections, the
           shadow-map bakes and their gather samplers, and the XLA scatter:
           scatter_impl="xla", the RenderConfig default and DEMO_CONFIG's,
           or a scene without local lights, whose frame then integrates
           with the plain scan). A scene without a sun has a shadow volume
           of ones (no K5 or K7; its blend still runs); a scene without
           media has zero material volumes and, under the scatter kernel,
           the visibility bake K9 in place of the radiance bake.

The shadow maps of shadow_mode="map" / "map_dir" are baked by
`bake_shadow_data` (plain torch, ray casting on the renderer's device) once
per call of render_frame, or once up front by the caller, who then passes
them as `shadow_data`, as the JAX package's bench does. composite_impl=
"pallas" ends in K4 too: it computes the JAX package's `composite_pallas`.
With composite_upsample > 1 (UHD_CONFIG) the composite runs K4 at the low
resolution on co-sited pixels and upsamples in plain torch
(ops/zg_composite.composite_cosited), where the JAX package does.

The geometry may hold the procedural heightfield, which every sun ray, the
G-buffer and the shadow-map bakes march, and the local-light rays with
heightfield_local_shadows; and boxes of fractional opacity, whose shadow
rays then carry an occlusion amount. A scene may carry a triangle mesh
(models/mesh.TriMesh): render_scene_inputs rasterizes it (ops/raster.py,
plain torch) into the G-buffer; the frame never reads it, and its shadow
comes from the geometry's proxy boxes, plain boxes to every kernel.

`render_frame_post` is render_frame followed by the post stack (post.py),
the JAX package's frame + post entry point.

render_frame(slab=...) renders one slab of an H-sharded frame
(parallel/shard_render.py): the renderer's config holds the slab's
halo-extended shapes and its band of the image, the slab the global grid
and the slab's first global row. Every route takes slabs, as in the JAX
package, and every plain pass and kernel reads global rows; the "gather"
reprojection and the post stack raise NotImplementedError there, where
the JAX package refuses them too.

Under grad (a scene, state or scene colour tensor requiring it) the frame
is differentiable wherever the JAX package's is -- the plain-torch passes by
autograd, the composite through K4 forward and its adjoint K14 backward
(ops/zg_composite.CompositeFn), render_frame_post's SSR march through K13
forward and its adjoint K15 backward (ops/ssr.SsrMarchFn: JAX
differentiates its XLA march there) -- and check_differentiable refuses,
naming the JAX kernel, every frame whose JAX route reaches a Pallas kernel,
which jax.grad refuses (inverse.py trains through this).

All branches keep one FrameState, so a state made by one feeds another as
long as the same blends are on. A config or scene that the JAX package would
send down a branch that is not ported raises NotImplementedError naming it.

Each pass runs inside a range named as the JAX package's jax.named_scope
around it (utils/profiling.scope, PASS_NAMES), so a profiler trace carries
the pass names; without a profiler recording the range is a no-op.

The renderer runs on CUDA unless it is built with device="cpu"; without a
GPU and without that request it raises instead of running on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from volumetricrenderer_tpu_torch import froxel, pipeline
from volumetricrenderer_tpu_torch.post import PostConfig, apply_post_planes
from volumetricrenderer_tpu_torch import shadow as shadow_lib
from volumetricrenderer_tpu_torch.config import (RenderConfig,
                                                 composite_eligible,
                                                 composite_route)
from volumetricrenderer_tpu_torch.jitter import jitter_for_frame
from volumetricrenderer_tpu_torch.models.scene import Scene, tensor_marks
from volumetricrenderer_tpu_torch.ops import raster, raycast
from volumetricrenderer_tpu_torch.ops.cuda import upload
from volumetricrenderer_tpu_torch.ops.frame_fused import (frame_tables,
                                                          integrate_blend,
                                                          volume_phase)
from volumetricrenderer_tpu_torch.ops.material import media_foldable
from volumetricrenderer_tpu_torch.ops.shadow_blend import dir_shadow_blend
from volumetricrenderer_tpu_torch.ops.visibility import bake_noise_channels
from volumetricrenderer_tpu_torch.ops.zg_composite import composite_frame
from volumetricrenderer_tpu_torch.state import FrameState
from volumetricrenderer_tpu_torch.utils.profiling import scope

def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA request without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain-torch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class VolumetricRenderer:
    """Owns the static config and the device."""

    def __init__(self, config: RenderConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        # (object, tensor_marks of it, its copy on the CPU) of the last
        # scene and sun shadow data passed in
        self._host_scene = None
        self._host_shadow = None

    def init_state(self, num_dir_lights: int = 1) -> FrameState:
        """Fresh history: shadow visibility 1, accumulation 0, and zero
        material and scatter histories where their blends are on."""
        cfg = self.config
        return FrameState.create(cfg.grid_dhw, num_dir_lights, cfg.dtype,
                                 self.device,
                                 with_material=cfg.temporal_blend_material,
                                 with_scatter=cfg.temporal_blend_scatter)

    def fuses_frame(self, scene: Optional[Scene] = None) -> bool:
        """Whether render_frame takes the fused volume phase (the JAX
        renderer's `fuse_frame`, given what check_supported admits): the
        config's terms and, given a scene, its sun, local lights and media,
        whose noise textures fold in only on the radiance bake (ss > 1)."""
        cfg = self.config
        if scene is not None:
            if not (scene.media and scene.dir_lights.count
                    and scene.point_lights.count + scene.spot_lights.count):
                return False
            if not media_foldable(scene.media) and not (
                    cfg.scatter_bake == "radiance"
                    and max(int(cfg.raycast_shadow_subsample), 1) > 1):
                return False
        return bool(cfg.frame_fused and cfg.temporal_blend_shadow
                    and cfg.temporal_blend_accumulation
                    and not cfg.temporal_blend_material
                    and not cfg.temporal_blend_scatter
                    and cfg.dir_shadow_impl == "pallas"
                    and cfg.reproj_impl == "pallas"
                    and cfg.scatter_impl == "pallas"
                    and cfg.accumulate_impl == "pallas"
                    and cfg.material_impl == "fused"
                    and cfg.shadow_mode == "raycast")

    def scatter_kernel(self, scene: Scene, local_maps=None) -> bool:
        """Whether the frame's scatter pass runs kernel K6
        (pipeline.uses_scatter_kernel); local_maps None: with the maps
        bake_shadow_data makes for the scene's local lights."""
        return pipeline.uses_scatter_kernel(
            self.config, scene.point_lights.count + scene.spot_lights.count,
            local_maps)

    def bakes_noise(self, scene: Scene) -> bool:
        """Whether the frame's low-rate radiance volume carries noise
        channels, one per noise-bearing medium: the fBm where the scatter
        kernel evaluates the media (bake_procedural_noise), and with a
        noise texture on the fused frame every medium's, whatever
        bake_procedural_noise says (the JAX frame bakes them all there)."""
        cfg = self.config
        if not (self.scatter_kernel(scene) and self.vis_ss() > 1
                and cfg.scatter_bake == "radiance" and scene.media):
            return False
        if not media_foldable(scene.media):
            return self.fuses_frame(scene)
        return bool(cfg.bake_procedural_noise
                    and pipeline.fuses_material(cfg, scene.media))

    def check_supported(self, scene: Scene, slab=None) -> None:
        """Raise NotImplementedError for what the port does not cover (with
        a slab, also what it does not cover in H-sharded slabs). Any number
        of suns and noise media renders; what the card's indexing or shared
        memory cannot take is refused by the kernels' wrappers, by name,
        before any launch."""
        cfg = self.config
        if slab is not None and cfg.reproj_impl == "gather":
            raise NotImplementedError(
                "reproj_impl='gather' in a slab: the gather reprojection has "
                "no bounded row support (the JAX package refuses it there "
                "too)")
        for name, values in (("shadow_mode", ("raycast", "map",
                                              "map_dir")),
                             ("reproj_impl", ("pallas", "windowed",
                                              "gather")),
                             ("dir_shadow_impl", ("pallas", "xla")),
                             ("scatter_impl", ("pallas", "xla")),
                             ("accumulate_impl", ("pallas", "xla")),
                             ("material_impl", ("fused", "xla")),
                             ("scatter_bake", ("radiance", "vis"))):
            if getattr(cfg, name) not in values:
                raise NotImplementedError(
                    f"config {name}={getattr(cfg, name)!r}: one of {values}")

    def check_differentiable(self, scene: Scene, shadow_data,
                             slab=None) -> None:
        """Raise NotImplementedError, naming the JAX package's Pallas
        kernel, wherever the JAX frame's route for this config and scene
        reaches one: jax.grad refuses every Pallas kernel, so the port
        refuses the same frames under grad, on the CPU as on the card
        (render_frame calls this when grad is on and a scene, state or scene
        colour tensor requires it). Everywhere else the port's frame is
        differentiable: the plain-torch passes by autograd, the composite
        through zg_composite.CompositeFn (K4 forward, K14 backward).
        shadow_data: the frame's maps (bake_shadow_data's triple). The first
        refusal that applies is raised."""
        cfg = self.config
        dir_sh, cube_sh, spot_sh = shadow_data
        n_dir = scene.dir_lights.count
        kernel = self.scatter_kernel(scene, (cube_sh, spot_sh))
        blends = (cfg.temporal_blend_shadow, cfg.temporal_blend_accumulation,
                  cfg.temporal_blend_material, cfg.temporal_blend_scatter)
        refused = (
            (slab is not None, "render_frame(slab=...): the port does not "
             "differentiate a slab's frame (its halo exchange and crop)"),
            (self.fuses_frame(scene), "the fused frame: JAX "
             "frame_volume_fused (ops/pallas/frame_fused.py)"),
            (kernel, "the scatter kernel: JAX scatter_local_pallas "
             "(ops/pallas/scatter.py), its bakes bake_radiance_pallas, "
             "bake_visibility_pallas (ops/pallas/visibility.py) and, with "
             "accumulate_impl='pallas' on its planes, accumulate_fused_pallas "
             "(ops/pallas/integrate.py) or integrate_blend_fused "
             "(ops/pallas/integrate_blend.py)"),
            (cfg.shadow_mode == "raycast" and cfg.dir_shadow_impl == "pallas"
             and n_dir > 0, "dir_shadow_impl='pallas': JAX "
             "dir_shadow_pallas (ops/pallas/dir_shadow.py) and "
             "dir_shadow_blend_fused (ops/pallas/shadow_blend.py)"),
            (pipeline.uses_pcf_kernel(cfg, dir_sh, n_dir),
             "the cascaded-PCF sun shadow: JAX pcf_dir_shadow_pallas "
             "(ops/pallas/pcf_shadow.py)"),
            (cfg.reproj_impl == "pallas" and any(blends),
             "reproj_impl='pallas': JAX fused_temporal_blend "
             "(ops/pallas/temporal.py) and windowed_warp_pallas "
             "(ops/pallas/warp.py)"),
            (composite_route(cfg) == "cosited", "the co-sited composite: "
             "JAX composite_zgather_planes (ops/pallas/zg_composite.py)"),
            (composite_eligible(cfg), "composite_impl='zgather': JAX "
             "composite_zgather (ops/pallas/zg_composite.py)"),
            (cfg.composite_impl == "pallas",
             "composite_impl='pallas': JAX composite_pallas "
             "(ops/pallas/composite.py)"),
        )
        for hit, what in refused:
            if hit:
                raise NotImplementedError(
                    f"{what}, under grad: jax.grad refuses that Pallas "
                    "kernel, and the port refuses the same frame")

    def bake_shadow_data(self, scene: Scene):
        """The shadow maps of the frame on the renderer's device: (sun
        cascades DirShadowData, point-light cubes CubeShadowData, spot maps
        SpotShadowData), each None where the mode or the scene has none.
        The sun bake is camera-aligned wherever the JAX package aligns it
        (dir_shadow_impl="pallas", or any impl in map_dir), so that the
        choice of sampler never changes the bake; map_dir shadows the local
        lights by rays and bakes no local maps."""
        cfg = self.config
        dir_shadow = cube_shadow = spot_shadow = None
        if cfg.shadow_mode == "raycast":
            return dir_shadow, cube_shadow, spot_shadow
        scene = scene.to(self.device)
        cam = scene.camera
        if scene.dir_lights.count:
            aligned = (cfg.dir_shadow_impl == "pallas"
                       or cfg.shadow_mode == "map_dir")
            align_up = cam.view_to_world()[:3, 1] if aligned else None
            dir_shadow = shadow_lib.bake_dir_shadows(
                scene.geometry, scene.dir_lights.direction,
                scene.dir_lights.shadow_strength, cam.position, cam.forward,
                cam.fov_y, cam.aspect, cam.near, cfg.shadow_distance,
                cfg.cascade_splits, cfg.shadow_map_size, align_up=align_up)
        if cfg.shadow_mode == "map_dir":
            return dir_shadow, cube_shadow, spot_shadow
        pts, sps = scene.point_lights, scene.spot_lights
        if pts.count:
            cube_shadow = shadow_lib.bake_cube_shadows(
                scene.geometry, pts.position, pts.range, pts.shadow_strength,
                cfg.shadow_map_size)
        if sps.count:
            spot_shadow = shadow_lib.bake_spot_shadows(
                scene.geometry, sps.position, sps.direction, sps.spot_angle,
                sps.range, sps.shadow_strength, cfg.shadow_map_size)
        return dir_shadow, cube_shadow, spot_shadow

    def render_scene_inputs(self, scene: Scene
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scene colour [IH, IW, 3] and linear view depth [IH, IW], standing
        in for the G-buffer: the analytic ray caster and, where the scene
        carries a TriMesh, the triangle rasterizer (ops/raster.py), shaded
        against the analytic occluders and composited by depth, clipped to
        the camera's far plane. Primary rays then skip the mesh's shadow
        proxy boxes, which the mesh covers."""
        cfg = self.config
        scene = scene.to(self.device)
        cam = scene.camera
        dirs, _ = raycast.camera_rays(cfg.image_width, cfg.image_height,
                                      cam.fov_y, cam.aspect,
                                      cam.view_to_world())
        if scene.dir_lights.count:
            sun_dir = scene.dir_lights.direction[0]
            sun_color = scene.dir_lights.packed_color[0]
        else:
            sun_dir = torch.tensor([0.0, -1.0, 0.0], device=self.device)
            sun_color = torch.zeros(3, device=self.device)
        color, depth = raycast.render_scene(
            scene.geometry, cam.position, dirs, sun_dir, sun_color,
            scene.ambient, cam.far, skip_proxy_boxes=scene.mesh is not None)
        if scene.mesh is not None:
            chunk = raster.CUDA_CHUNK if self.device.type == "cuda" \
                else raster.CPU_CHUNK
            malb, mnrm, mdepth = raster.rasterize_mesh(
                scene.mesh, cam, cfg.image_width, cfg.image_height, chunk)
            mcolor, _ = raster.shade_mesh_gbuffer(
                malb, mnrm, mdepth, cam.position, dirs, scene.geometry,
                sun_dir, sun_color, scene.ambient)
            near = torch.minimum(mdepth, depth)
            color = torch.where((mdepth < depth)[..., None], mcolor, color)
            depth = torch.minimum(near, cam.far)
        return color, depth

    def host_scene(self, scene: Scene) -> Scene:
        """`scene` without its mesh and with every other tensor on the CPU,
        kept for the last scene passed in and copied again once one of its
        tensors was edited in place or given new storage. The mesh is left
        out of the copy and of its marks: no frame table reads it (the
        G-buffer rasterizes it on the renderer's device)."""
        self._host_scene = _host_copy(self._host_scene, scene,
                                      lambda s: dataclasses.replace(
                                          s, mesh=None))
        return self._host_scene[2]

    def frame_tables(self, state: FrameState, scene: Scene, time_x=0.0,
                     slab=None):
        """Host prep of one frame: (FrameTables, FroxelParams, world_to_view)
        -- the packed tables the volume kernels read, on the renderer's
        device, and the view matrix on the CPU. A slab's params hold the
        global grid and the slab's first row y0.

        Wherever the scene lives, the tables are packed on the CPU from its
        host copy: ~170 small torch ops, each cheaper there than a launch on
        the GPU, then uploaded in one asynchronous copy (FrameTables.to)."""
        cfg = self.config
        self.check_supported(scene, slab)
        with torch.no_grad():
            return self._frame_tables(state, self.host_scene(scene), time_x,
                                      slab)

    def _frame_tables(self, state, scene, time_x, slab):
        cfg = self.config
        cam = scene.camera
        view_to_world = cam.view_to_world()
        world_to_view = froxel.invert_rigid(view_to_world)
        params = self._params(cam, slab)
        # history is invalid on frame 0
        alpha = np.float32(cfg.temporal_blend_alpha) \
            * np.float32(state.frame_count > 0)
        prev_w2v = world_to_view if cfg.use_current_matrix_for_reproj \
            else state.prev_world_to_view.cpu()
        # the local lights' source: the low-rate radiance bake, else a
        # per-light loop (over rays at ss = 1, over the visibility bake
        # above), which needs the full-rate light schedule; the fBm channels
        # ride the radiance volume into a scatter that evaluates the media.
        # The XLA scatter reads none of the local lights' tables.
        kernel = self.scatter_kernel(scene)
        ss = self.vis_ss() if kernel else 1
        radiance = ss > 1 and cfg.scatter_bake == "radiance" \
            and bool(scene.media)
        local = (scene.point_lights, scene.spot_lights) if kernel \
            else (None, None)
        tables = frame_tables(
            params, view_to_world, prev_w2v, jitter_for_frame(
                state.frame_count), alpha, scene.dir_lights, *local,
            scene.geometry, scene.media, time_x, cam.position, cfg.grid,
            cfg.reproj_window, ss, self.bakes_noise(scene),
            cfg.jitter_dir_scatter, light_schedule=not radiance,
            heightfield_local=cfg.heightfield_local_shadows)
        if self.device.type != "cpu":
            tables = tables.to(self.device)
            params = froxel.params_to(params, self.device)
        return tables, params, world_to_view

    def vis_ss(self) -> int:
        """The rate of the local lights' low grid: raycast_shadow_subsample,
        at least 2 where shadow_mode="map" bakes the local maps there (the
        JAX pass's `vis_mode`)."""
        ss = max(int(self.config.raycast_shadow_subsample), 1)
        return max(ss, 2) if self.config.shadow_mode == "map" else ss

    def host_shadow(self, dir_shadow):
        """`dir_shadow` with every tensor on the CPU, kept as host_scene
        keeps the scene (K12's schedule is host prep)."""
        self._host_shadow = _host_copy(self._host_shadow, dir_shadow)
        return self._host_shadow[2]

    def _params(self, cam, slab=None):
        """The frame's FroxelParams for camera `cam`: over the global grid
        and from the slab's first row y0 where a slab is given."""
        cfg = self.config
        params = froxel.make_froxel_params(
            cam.fov_y, cam.aspect, cam.near, cfg.volume_distance,
            cfg.depth_distribution,
            cfg.grid if slab is None else tuple(slab.grid_global))
        if slab is not None:
            params = dataclasses.replace(params, y0=float(slab.y0))
        return params

    def froxel_params(self, scene: Scene, slab=None):
        """The frame's FroxelParams (of the global grid, from the slab's
        first row where a slab is given) on the renderer's device, from the
        host copy of the scene's camera, as render_frame makes them."""
        params = self._params(self.host_scene(scene).camera, slab)
        return params if self.device.type == "cpu" \
            else froxel.params_to(params, self.device)

    def pcf_tables(self, state: FrameState, scene: Scene, dir_shadow,
                   slab=None):
        """K12's tables of the frame (pipeline.pack_pcf_tables), packed on
        the CPU from the host copies of the scene and the shadow data, on
        the renderer's device; a slab's hold its global grid and first row
        y0, which the kernel's rows and its window test read."""
        with torch.no_grad():
            return self._pcf_tables(state, scene, dir_shadow, slab)

    def _pcf_tables(self, state, scene, dir_shadow, slab):
        cfg = self.config
        host = self.host_scene(scene)
        cam = host.camera
        t = pipeline.pack_pcf_tables(
            cfg, self._params(cam, slab), cam.view_to_world(),
            jitter_for_frame(state.frame_count), host.dir_lights,
            self.host_shadow(dir_shadow))
        return t.to(self.device) if self.device.type != "cpu" else t

    def render_frame(self, state: FrameState, scene: Scene, time_x=0.0,
                     scene_color: Optional[torch.Tensor] = None,
                     view_depth: Optional[torch.Tensor] = None,
                     shadow_data=None, slab=None
                     ) -> Tuple[torch.Tensor, dict, FrameState]:
        """One frame. Returns (image [IH, IW, 4], aux, new state).

        shadow_data: the maps of bake_shadow_data, baked once by the caller;
        None bakes them in this call (the shadow-map modes only).

        slab (parallel/shard_render.Slab): render one slab of an H-sharded
        frame. The config holds the slab's halo-extended grid and its band
        of the image, whose G-buffer band the caller passes; every output
        covers the extended slab and the caller drops the halo rows.

        aux holds the volumes of the frame: `shadow` [Nd, D, H, W],
        `accumulation` [4, D, H, W] and, on the staged branch where they
        exist, `scatter` [4, D, H, W] (r, g, b, extinction; the JAX package
        packs it [D, H, W, 4]) and `material_a` [4, D, H, W], `material_b`
        [1, D, H, W]: the material volumes are written only when the
        scatter reads them (material_impl="xla" or the material blend),
        not when it evaluates the media itself."""
        cfg = self.config
        tables, params, world_to_view = self.frame_tables(state, scene,
                                                          time_x, slab)
        if slab is not None and (scene_color is None or view_depth is None):
            raise ValueError("a slab needs the caller's G-buffer band "
                             "(scene_color and view_depth)")
        if scene_color is None or view_depth is None:
            with scope("gbuffer"):
                scene_color, view_depth = self.render_scene_inputs(scene)
        if shadow_data is None:
            with scope("shadow_maps"):
                shadow_data = self.bake_shadow_data(scene)
        if torch.is_grad_enabled() and requires_grad(scene, state,
                                                     scene_color):
            self.check_differentiable(scene, shadow_data, slab)
        dir_sh, cube_sh, spot_sh = shadow_data
        f32 = torch.float32
        prev_shadow = state.prev_shadow.to(f32).contiguous()
        prev_acc = state.prev_accumulation.to(f32).contiguous()
        aux = {}
        mat_a = scatter = None
        if self.fuses_frame(scene):
            noise = None
            if tables.texture_noise:
                geo, scene_dev = self.frame_geometry(state, scene, tables,
                                                     params, world_to_view)
                with scope("bake_noise_tex"):
                    noise = bake_noise_channels(
                        cfg, params, geo.view_to_world, geo.jitter,
                        scene_dev.media, time_x, tables.ss)
            with scope("volume_fused"):
                shadow, acc = volume_phase(tables, prev_shadow, prev_acc,
                                           noise)
        else:
            geo, scene_dev = self.frame_geometry(state, scene, tables,
                                                 params, world_to_view)
            kernel = self.scatter_kernel(scene, (cube_sh, spot_sh))
            material = None
            if not pipeline.fuses_material(cfg, scene.media, kernel):
                with scope("write_material_volume"):
                    mat_a, mat_b = pipeline.write_material_volumes(
                        cfg, params, geo.view_to_world, geo.jitter, time_x,
                        scene_dev.media)
                if cfg.temporal_blend_material:
                    mat_a = pipeline.temporal_blend_material(
                        cfg, geo, mat_a, state.prev_material_a.to(f32))
                material = (mat_a.contiguous(), mat_b.contiguous())
                aux.update(material_a=mat_a, material_b=mat_b)

            pallas_reproj = cfg.reproj_impl == "pallas"
            if (cfg.temporal_blend_shadow and pallas_reproj
                    and cfg.dir_shadow_impl == "pallas"
                    and cfg.shadow_mode == "raycast" and tables.n_dir):
                with scope("shadow_blend"):
                    shadow = dir_shadow_blend(tables, prev_shadow)
            else:
                with scope("write_shadow_volume"):
                    pcf = self.pcf_tables(state, scene, dir_sh, slab) \
                        if pipeline.uses_pcf_kernel(cfg, dir_sh,
                                                    tables.n_dir) else None
                    shadow = pipeline.write_shadow_volume_dir(
                        cfg, tables, geo, scene_dev.dir_lights,
                        scene_dev.geometry, dir_sh, pcf)
                if cfg.temporal_blend_shadow:
                    with scope("temporal_blend_shadow"):
                        shadow = pipeline.temporal_blend_shadow(
                            cfg, tables, geo, shadow.contiguous(),
                            prev_shadow)

            with scope("write_scatter_volume"):
                scatter = pipeline.write_scatter_volume(
                    cfg, tables, shadow.contiguous(), material, geo,
                    scene_dev, (cube_sh, spot_sh), time_x)
            # the scatter blend works on the volume, not on the kernel's
            # planes, and the XLA scatter writes no planes: what follows
            # then takes the plain accumulation
            kernel_planes = kernel and not cfg.temporal_blend_scatter
            if cfg.temporal_blend_scatter:
                scatter = pipeline.temporal_blend_scatter(
                    cfg, geo, scatter, state.prev_scatter.to(f32))

            if (cfg.temporal_blend_accumulation and pallas_reproj
                    and cfg.accumulate_impl == "pallas" and kernel_planes):
                with scope("integrate_blend"):
                    acc = integrate_blend(tables, scatter, prev_acc)
            else:
                with scope("accumulate"):
                    acc = pipeline.accumulate(cfg, tables, scatter, params,
                                              kernel_planes)
                if cfg.temporal_blend_accumulation:
                    with scope("temporal_blend_accumulation"):
                        acc = pipeline.temporal_blend_accumulation(
                            cfg, tables, geo, acc.contiguous(), prev_acc)
            aux["scatter"] = scatter
        with scope("composite"):
            image = composite_frame(cfg, acc.contiguous(),
                                    scene_color.contiguous(),
                                    view_depth.contiguous(), params, slab)
        dt = cfg.dtype
        new_state = FrameState(
            prev_shadow=shadow.to(dt), prev_accumulation=acc.to(dt),
            prev_world_to_view=world_to_view,
            frame_count=state.frame_count + 1,
            prev_material_a=mat_a.to(dt)
            if cfg.temporal_blend_material else None,
            prev_scatter=scatter.to(dt)
            if cfg.temporal_blend_scatter else None)
        aux.update(shadow=shadow, accumulation=acc, scene_color=scene_color,
                   view_depth=view_depth)
        return image, aux, new_state

    def render_frame_post(self, state: FrameState, scene: Scene,
                          post_cfg: PostConfig, time_x=0.0,
                          scene_color: Optional[torch.Tensor] = None,
                          view_depth: Optional[torch.Tensor] = None,
                          shadow_data=None, velocity=None, slab=None
                          ) -> Tuple[torch.Tensor, dict, FrameState]:
        """Frame + post stack: render_frame, then post.apply_post_planes on
        the image's r, g, b planes with aux["view_depth"] and `velocity`
        ([H, W, 2] pixels, post.camera_velocity; None skips motion blur).
        Returns (display rgb [H, W, 3], aux, new state). A slab raises: the
        post stack's screen-space passes need the whole image."""
        if slab is not None:
            raise NotImplementedError("the post stack in a slab: its "
                                      "screen-space passes are not ported "
                                      "to H-sharded bands")
        image, aux, new_state = self.render_frame(
            state, scene, time_x, scene_color, view_depth, shadow_data)
        out = apply_post_planes([image[..., c] for c in range(3)], post_cfg,
                                view_depth=aux["view_depth"],
                                velocity=velocity)
        return torch.stack(out, dim=-1), aux, new_state

    def render_debug_slice(self, state: FrameState, scene: Scene, z: int,
                           volume: str = "accumulation", time_x=0.0
                           ) -> torch.Tensor:
        """The reference's debug pass: froxel slice z of aux[volume] of one
        frame composited over the frame's scene colour ([IH, IW, 3],
        utils/debug.debug_composite). The four-channel volumes
        (accumulation, scatter, material_a) blend as rgba; a one-channel
        volume (the first sun's shadow, material_b) as grey with alpha 1."""
        from volumetricrenderer_tpu_torch.utils.debug import (
            debug_composite, volume_slice)
        _, aux, _ = self.render_frame(state, scene, time_x)
        vol = aux[volume]
        if volume in ("accumulation", "scatter", "material_a"):
            sl = volume_slice(vol.permute(1, 2, 3, 0), z)
        else:
            sl = volume_slice(vol[0], z)
            sl = torch.stack([sl, sl, sl, torch.ones_like(sl)], dim=-1)
        return debug_composite(aux["scene_color"], sl)

    def frame_geometry(self, state: FrameState, scene: Scene, tables,
                       params, world_to_view):
        """What the plain-torch passes read, on the renderer's device
        (pipeline.FrameGeometry), and the scene there."""
        cfg = self.config
        dev = self.device
        host = self.host_scene(scene)
        prev_w2v = world_to_view if cfg.use_current_matrix_for_reproj \
            else state.prev_world_to_view.cpu()
        mats = upload(torch.stack([host.camera.view_to_world(), prev_w2v]),
                      dev)
        alpha = float(np.float32(cfg.temporal_blend_alpha)
                      * np.float32(state.frame_count > 0))
        geo = pipeline.FrameGeometry(
            params=params, view_to_world=mats[0], prev_world_to_view=mats[1],
            jitter=upload(tables.jitter, dev), alpha=alpha, grid=cfg.grid)
        return geo, scene.to(dev)


def requires_grad(*objs) -> bool:
    """Whether any tensor in objs (trees of dataclasses and tuples, or
    tensors) requires grad."""
    def walk(o):
        if isinstance(o, torch.Tensor):
            return o.requires_grad
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return any(walk(getattr(o, f.name))
                       for f in dataclasses.fields(o))
        if isinstance(o, tuple):
            return any(walk(v) for v in o)
        return False
    return any(walk(o) for o in objs)


def _host_copy(cached, obj, strip=None):
    """(obj, its tensor_marks, obj.to("cpu")): `cached` while it holds this
    very object with every tensor unchanged, else a new copy; strip(obj),
    where given, is what is marked and copied. The marks (each tensor's
    version counter and data pointer, a few dozen attribute reads) change
    with any in-place edit; JAX arrays are immutable, so the reference
    never sees a stale copy either."""
    kept = obj if strip is None else strip(obj)
    marks = tensor_marks(kept)
    if cached is not None and cached[0] is obj and cached[1] == marks:
        return cached
    return obj, marks, kept.to("cpu")
