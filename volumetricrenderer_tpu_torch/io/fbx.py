"""Minimal binary-FBX mesh reader: vertices and triangles only
(`volumetricrenderer_tpu/io/fbx.py`, copied: numpy, no JAX).

The reference's environment is FBX tree meshes instanced by a Unity prefab
(Assets/Fbxs/Nature_Tree_*.fbx, placed by Assets/Prefabs/Enviornment.prefab).
This parses the FBX node tree (Kaydara binary format 7.x), pulls every
Objects/Geometry node's `Vertices` and `PolygonVertexIndex`, fans polygons
into triangles and hands the soup to models/voxelize.py or models/mesh.py.

Format notes (from the public file layout, no external dependencies):
- 21-byte magic "Kaydara FBX Binary  \\x00", 2 pad bytes, uint32 version.
- Node record: EndOffset, NumProperties, PropertyListLen (uint32, or uint64
  from version 7500), uint8 name length, name, properties, nested children
  terminated by a zeroed sentinel record.
- Property type codes: Y,C,I,F,D,L scalars; f,d,l,i,b arrays (uint32 count,
  encoding, byte length; zlib-deflated when encoding == 1); S/R strings/raw.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00"
_SCALAR = {b"Y": ("<h", 2), b"C": ("<b", 1), b"I": ("<i", 4),
           b"F": ("<f", 4), b"D": ("<d", 8), b"L": ("<q", 8)}
_ARRAY = {b"f": np.float32, b"d": np.float64, b"l": np.int64, b"i": np.int32,
          b"b": np.uint8}


class _Node:
    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list):
        self.name = name
        self.props = props
        self.children: List[_Node] = []

    def find_all(self, name: str):
        out = []
        for c in self.children:
            if c.name == name:
                out.append(c)
            out.extend(c.find_all(name))
        return out

    def child(self, name: str):
        for c in self.children:
            if c.name == name:
                return c
        return None


def _read_node(buf: bytes, pos: int, long_offsets: bool):
    if long_offsets:
        end, nprops, plen = struct.unpack_from("<QQQ", buf, pos)
        pos += 24
    else:
        end, nprops, plen = struct.unpack_from("<III", buf, pos)
        pos += 12
    if end == 0:                                   # sentinel record
        return None, pos + 1
    nlen = buf[pos]
    pos += 1
    name = buf[pos:pos + nlen].decode("ascii", "replace")
    pos += nlen
    props = []
    for _ in range(nprops):
        t = buf[pos:pos + 1]
        pos += 1
        if t in _SCALAR:
            fmt, sz = _SCALAR[t]
            props.append(struct.unpack_from(fmt, buf, pos)[0])
            pos += sz
        elif t in _ARRAY:
            count, enc, blen = struct.unpack_from("<III", buf, pos)
            pos += 12
            raw = buf[pos:pos + blen]
            pos += blen
            if enc == 1:
                raw = zlib.decompress(raw)
            props.append(np.frombuffer(raw, dtype=_ARRAY[t], count=count))
        elif t in (b"S", b"R"):
            slen = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            data = buf[pos:pos + slen]
            pos += slen
            props.append(data.decode("utf-8", "replace") if t == b"S" else data)
        else:
            raise ValueError(f"unknown FBX property type {t!r} at {pos}")
    node = _Node(name, props)
    while pos < end:
        child, pos = _read_node(buf, pos, long_offsets)
        if child is None:
            break
        node.children.append(child)
    return node, max(pos, end)


def parse_fbx(path: str) -> _Node:
    """Parse a binary FBX file into its node tree (root node)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a binary FBX file")
    version = struct.unpack_from("<I", buf, 23)[0]
    long_offsets = version >= 7500
    root = _Node("", [])
    pos = 27
    while pos < len(buf):
        node, pos = _read_node(buf, pos, long_offsets)
        if node is None:
            break
        root.children.append(node)
    return root


def _triangulate(poly_idx: np.ndarray) -> np.ndarray:
    """FBX PolygonVertexIndex (negative value = XOR-complemented final index
    of a polygon) -> [T, 3] int32 triangle fan."""
    tris = []
    poly: List[int] = []
    for v in poly_idx:
        last = v < 0
        poly.append(int(~v) if last else int(v))
        if last:
            for k in range(1, len(poly) - 1):
                tris.append((poly[0], poly[k], poly[k + 1]))
            poly = []
    return np.asarray(tris, np.int32).reshape(-1, 3)


def load_fbx_meshes(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """[(vertices [V, 3] f32, triangles [T, 3] i32), ...] — one entry per
    Geometry node, in the file's local units/axes."""
    root = parse_fbx(path)
    out = []
    for geo in root.find_all("Geometry"):
        vn = geo.child("Vertices")
        pn = geo.child("PolygonVertexIndex")
        if vn is None or pn is None:
            continue
        verts = np.asarray(vn.props[0], np.float64).reshape(-1, 3) \
            .astype(np.float32)
        tris = _triangulate(np.asarray(pn.props[0], np.int64))
        if len(verts) and len(tris):
            out.append((verts, tris))
    return out


def merge_meshes(meshes) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (verts, tris) pairs into one soup."""
    vs, ts = [], []
    off = 0
    for v, t in meshes:
        vs.append(v)
        ts.append(t + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(ts)


def normalize_mesh(verts: np.ndarray, height: float = 1.0,
                   ground: float = 0.0) -> np.ndarray:
    """Uniform-scale + translate so the mesh stands on y = ground with the
    given height (placement units come from the scene, not the file — FBX
    unit scale varies per exporter)."""
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    s = height / max(float(hi[1] - lo[1]), 1e-6)
    out = (verts - lo[None]) * s
    cx = 0.5 * (hi[0] - lo[0]) * s
    cz = 0.5 * (hi[2] - lo[2]) * s
    return out - np.asarray([cx, -ground, cz], np.float32)[None]
