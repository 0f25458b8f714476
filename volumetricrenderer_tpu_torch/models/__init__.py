from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.models.lights import (DirectionalLights,
                                                        PointLights,
                                                        SpotLights)
from volumetricrenderer_tpu_torch.models.media import Medium
from volumetricrenderer_tpu_torch.models.mesh import TriMesh
from volumetricrenderer_tpu_torch.models.scene import (Scene, benchmark_scene,
                                                       demo_scene)

__all__ = ["Camera", "DirectionalLights", "PointLights", "SpotLights",
           "Medium", "Geometry", "TriMesh", "Scene", "benchmark_scene",
           "demo_scene"]
