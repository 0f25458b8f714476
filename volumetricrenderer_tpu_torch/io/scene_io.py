"""Declarative scene files in JSON (`volumetricrenderer_tpu/io/scene_io.py`).

The reference authors its scene as serialized Unity fields (camera, sun and
spot parameters, fog medium); this loads such a description into a Scene
and writes one back. The format is the JAX package's, so one file loads in
both packages. Two dialects, free to mix section by section:

- SERIALIZED (what `scene_to_dict` writes): each section carries the exact
  dataclass fields (struct-of-arrays lights, fov in radians, normalized
  directions) and loads back bit for bit: nothing is re-normalized or
  re-converted.
- AUTHORED (by hand): the constructors' forms -- a camera with
  `fov_y_deg`, lights as a list of per-light dicts, geometry as
  `planes/spheres/boxes` tuples, media as `Medium.create` arguments --
  through the models' create() (the presets' normalization).

The optional `mesh` section is a TriMesh's fields; the optional `post`
section a PostConfig's.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from volumetricrenderer_tpu_torch.models.camera import Camera
from volumetricrenderer_tpu_torch.models.geometry import Geometry
from volumetricrenderer_tpu_torch.models.lights import (DirectionalLights,
                                                        PointLights,
                                                        SpotLights)
from volumetricrenderer_tpu_torch.models.media import Medium
from volumetricrenderer_tpu_torch.models.mesh import TriMesh
from volumetricrenderer_tpu_torch.models.scene import Scene

SCHEMA_VERSION = 1

# per-field dtypes that are not float32 (every other tensor field is)
_DTYPES = {"has_shadow": np.bool_, "tris": np.int32}


def _dc_to_dict(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None or isinstance(v, (str, int, float, bool)):
            out[f.name] = v
        else:
            arr = v.detach().cpu().numpy()
            if arr.size == 0:
                # tolist() of a (0, 3) is just []: keep the shape
                out[f.name] = {"empty": list(arr.shape)}
            else:
                out[f.name] = arr.tolist()
    return out


def _dc_from_dict(cls, d: dict, device):
    """cls from its fields in d. A field with a default is static (a str,
    int, float or bool, copied as it is); every other field is a tensor."""
    kw = {}
    for f in dataclasses.fields(cls):
        v = d.get(f.name)
        static = f.default is not dataclasses.MISSING
        if v is None:
            # an optional tensor (Medium.noise_tex) is written as None; an
            # absent static field takes its default
            kw[f.name] = f.default if static else None
        elif static or isinstance(v, str):
            kw[f.name] = v
        else:
            dt = _DTYPES.get(f.name, np.float32)
            a = np.zeros(tuple(v["empty"]), dt) \
                if isinstance(v, dict) and "empty" in v \
                else np.asarray(v, dt)
            kw[f.name] = torch.as_tensor(a, device=device)
    return cls(**kw)


def _is_serialized(cls, d: dict) -> bool:
    """A section is in the serialized dialect when it holds every field
    without a default (the authored forms use the create() argument names,
    which differ in at least one field of every section)."""
    return all(f.name in d for f in dataclasses.fields(cls)
               if f.default is dataclasses.MISSING)


# per-entry defaults of the optional create() arguments, as each create()
# fills them when the whole column is left out, so that an authored light
# list may set e.g. has_shadow on some entries only
_LIGHT_KEY_DEFAULTS = {
    "shadow_strength": 1.0,
    "intensity_multiplier": 1.0,
    "inner_angle_percent": 0.5,
}


def _light_key_default(cls, key):
    if key == "has_shadow":
        return cls is DirectionalLights     # create(): suns True,
    return _LIGHT_KEY_DEFAULTS.get(key)     # point and spot lights False


def _lights_from(cls, d, device):
    if isinstance(d, dict):                       # serialized SoA
        return _dc_from_dict(cls, d, device)
    if not d:                                     # authored empty list
        return cls.empty(device)
    # authored: a list of per-light dicts -> the create() columns
    keys = set().union(*[set(e) for e in d])
    cols = {k: [e.get(k) for e in d] for k in keys}
    # an entry without an OPTIONAL key takes that key's create() default
    # (the other entries keep theirs); a REQUIRED key missing on some
    # entries is an authoring error
    for k, col in cols.items():
        if any(v is None for v in col):
            default = _light_key_default(cls, k)
            if default is None:
                raise ValueError(
                    f"light list entries disagree on required key '{k}'")
            cols[k] = [default if v is None else v for v in col]
    return cls.create(**cols, device=device)


def _section_from(cls, d: dict, device):
    if _is_serialized(cls, d):
        return _dc_from_dict(cls, d, device)
    return cls.create(**d, device=device)


def scene_to_dict(scene: Scene) -> dict:
    """The exact (serialized-dialect) dict of a Scene; JSON-safe."""
    return {
        "schema": SCHEMA_VERSION,
        "camera": _dc_to_dict(scene.camera),
        "dir_lights": _dc_to_dict(scene.dir_lights),
        "point_lights": _dc_to_dict(scene.point_lights),
        "spot_lights": _dc_to_dict(scene.spot_lights),
        "media": [_dc_to_dict(m) for m in scene.media],
        "geometry": _dc_to_dict(scene.geometry),
        "ambient": scene.ambient.detach().cpu().numpy().tolist(),
        "mesh": None if scene.mesh is None else _dc_to_dict(scene.mesh),
    }


def scene_from_dict(d: dict, device="cuda") -> Scene:
    """A Scene on `device` from the serialized or the authored dialect (see
    the module docstring). Unknown top-level keys raise (typos)."""
    known = {"schema", "camera", "dir_lights", "point_lights", "spot_lights",
             "media", "geometry", "ambient", "mesh"}
    extra = set(d) - known
    if extra:
        raise ValueError(f"unknown scene keys: {sorted(extra)}")
    mesh = d.get("mesh")
    geometry = d.get("geometry")
    return Scene(
        camera=_section_from(Camera, d["camera"], device),
        dir_lights=_lights_from(DirectionalLights, d.get("dir_lights", []),
                                device),
        point_lights=_lights_from(PointLights, d.get("point_lights", []),
                                  device),
        spot_lights=_lights_from(SpotLights, d.get("spot_lights", []),
                                 device),
        media=tuple(_section_from(Medium, m, device)
                    for m in d.get("media", [])),
        geometry=Geometry.empty(device) if geometry is None
        else _section_from(Geometry, geometry, device),
        ambient=torch.as_tensor(np.asarray(d.get("ambient", (0.0, 0.0, 0.0)),
                                           np.float32), device=device),
        mesh=None if mesh is None else _dc_from_dict(TriMesh, mesh, device),
    )


def post_to_dict(post_cfg) -> dict:
    """A PostConfig as a JSON-safe dict (tuples as lists)."""
    out = {}
    for f in dataclasses.fields(post_cfg):
        v = getattr(post_cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def post_from_dict(d: dict):
    """The port's post.PostConfig from any subset of its fields (defaults
    fill the rest); lists become tuples; unknown keys raise."""
    from volumetricrenderer_tpu_torch.post import PostConfig
    names = {f.name for f in dataclasses.fields(PostConfig)}
    extra = set(d) - names
    if extra:
        raise ValueError(f"unknown post keys: {sorted(extra)}")
    kw = {}
    for f in dataclasses.fields(PostConfig):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        kw[f.name] = v
    return PostConfig(**kw)


def save_scene(path: str, scene: Scene, post_cfg=None) -> None:
    """Write the scene (and post_cfg, where given, as its `post` section)."""
    doc = scene_to_dict(scene)
    if post_cfg is not None:
        doc["post"] = post_to_dict(post_cfg)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def load_scene(path: str, with_post: bool = False, device="cuda"):
    """The Scene of a file on `device`; with_post=True returns (scene, its
    PostConfig or None)."""
    with open(path) as f:
        doc = json.load(f)
    post = doc.pop("post", None)
    scene = scene_from_dict(doc, device)
    if with_post:
        return scene, (None if post is None else post_from_dict(post))
    return scene
