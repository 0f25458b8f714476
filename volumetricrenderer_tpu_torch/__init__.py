"""volumetricrenderer_tpu_torch: the froxel volumetric renderer on PyTorch
and hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of `volumetricrenderer_tpu` (JAX on a TPU), which stays the
reference. This package imports torch and numpy, never JAX or the JAX
package. Ported so far: the production frame (the fused volume phase, its
local lights from the radiance bake, the visibility bake or per-light rays,
and the zgather composite, at 1080p and at 4K, exact or co-sited), the
staged frame beside it (shadow, scatter and
integrate as separate kernels, with the exact per-light scatter) and the
history frame (material volumes, the per-light visibility bake, the
material, scatter and standalone shadow and accumulation blends), the
shadow-map frames and the post stack (`post.py`, `render_frame_post`), on
`benchmark_scene` and on the reference demo scene `demo_scene` (its
procedural terrain in every ray cast; boxes of fractional opacity too; its
tree meshes, rasterized into the G-buffer by `ops/raster.py`, with their
voxelized shadow proxies: `demo_scene(mesh_env=True)`), with
procedural or texture noise (`ops/noise.perlin_texture_3d`), with or
without a sun or media, at any pixel/froxel ratio, and in H-sharded slabs
on one device (`parallel/shard_render.make_multislab_render`); and the
training path (`inverse.py`: fog, light and occluder parameters fitted by
gradient descent through the frame, the composite's gradient on kernel K14,
data parallel over `torch.distributed`) with `checkpoint.py`'s state
checkpoints; scene files (`io/scene_io.py`, the JAX package's JSON
format), `models/builder.SceneBuilder`, the mesh ingestion (`io/fbx.py`,
`models/voxelize.py`, the native core's binding `io/native.py`) and the
demo entry, `python -m volumetricrenderer_tpu_torch.demo`; see ROADMAP.md
for what remains.
"""

from volumetricrenderer_tpu_torch.config import (DEMO_CONFIG, FULL_CONFIG,
                                                 UHD_CONFIG, RenderConfig)
from volumetricrenderer_tpu_torch.models import (Camera, DirectionalLights,
                                                 Geometry, Medium,
                                                 PointLights, Scene,
                                                 SpotLights, TriMesh,
                                                 benchmark_scene, demo_scene)
from volumetricrenderer_tpu_torch.renderer import VolumetricRenderer
from volumetricrenderer_tpu_torch.state import FrameState

__all__ = [
    "RenderConfig", "DEMO_CONFIG", "FULL_CONFIG", "UHD_CONFIG",
    "VolumetricRenderer", "FrameState", "Camera", "DirectionalLights",
    "PointLights", "SpotLights", "Medium", "Geometry", "TriMesh", "Scene",
    "benchmark_scene", "demo_scene",
]
