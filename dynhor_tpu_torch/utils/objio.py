"""Wavefront OBJ/MTL loading (host-side, numpy).

The port's own copy of ``dynhor_tpu/utils/objio.py`` (the port imports
nothing of the JAX package).  Replaces PyTorch3D's ``load_objs_as_meshes``
(ObjTracker/run.py:10,107) and trimesh.load (vis.py:24).  Off the hot
path — runs once at startup; callers move the arrays it returns to the
device.

Supports: v, vt, f (v, v/vt, v/vt/vn, v//vn) with polygon fan
triangulation; mtllib/usemtl with map_Kd texture images (via PIL).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Triangle mesh with optional UV texture.

    verts: (V, 3) float32.
    faces: (F, 3) int32 vertex indices.
    face_uvs: (F, 3, 2) float32 per-corner UV coords (zeros if untextured).
    texture: (Ht, Wt, 3) float32 in [0, 1] (ones if untextured).
    has_texture: bool.
    """

    verts: np.ndarray
    faces: np.ndarray
    face_uvs: np.ndarray
    texture: np.ndarray
    has_texture: bool


def _parse_mtl(path: str) -> dict[str, str]:
    """Material name -> diffuse texture path (absolute)."""
    out: dict[str, str] = {}
    if not os.path.exists(path):
        return out
    base = os.path.dirname(path)
    cur = None
    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] == "newmtl" and len(parts) > 1:
                cur = parts[1]
            elif parts[0] == "map_Kd" and cur is not None and len(parts) > 1:
                out[cur] = os.path.join(base, parts[-1])
    return out


def load_obj(path: str) -> MeshData:
    """Load an OBJ file with optional UV texture."""
    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    face_v: list[tuple[int, int, int]] = []
    face_vt: list[tuple[int, int, int]] = []
    mtl_files: list[str] = []
    base = os.path.dirname(path)

    def vidx(tok: str, n: int) -> tuple[int, int]:
        """Returns (vertex_index, uv_index) both 0-based; uv -1 if absent."""
        comps = tok.split("/")
        vi = int(comps[0])
        vi = vi - 1 if vi > 0 else n + vi
        ti = -1
        if len(comps) > 1 and comps[1]:
            t = int(comps[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        return vi, ti

    with open(path, "r", errors="ignore") as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                uvs.append([u, v])
            elif tag == "f":
                idx = [vidx(t, len(verts)) for t in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    face_v.append((idx[0][0], idx[k][0], idx[k + 1][0]))
                    face_vt.append((idx[0][1], idx[k][1], idx[k + 1][1]))
            elif tag == "mtllib" and len(parts) > 1:
                mtl_files.append(os.path.join(base, parts[-1]))

    v = np.asarray(verts, np.float32)
    fv = np.asarray(face_v, np.int32)
    uv = np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32)

    texture = np.ones((2, 2, 3), np.float32)
    has_texture = False
    for mtl in mtl_files:
        for tex_path in _parse_mtl(mtl).values():
            if os.path.exists(tex_path):
                from PIL import Image

                img = np.asarray(Image.open(tex_path).convert("RGB"), np.float32) / 255.0
                texture = img
                has_texture = True
                break
        if has_texture:
            break

    if uv.shape[0] > 0 and (np.asarray(face_vt) >= 0).all():
        fuv = uv[np.asarray(face_vt, np.int64)]
    else:
        fuv = np.zeros((fv.shape[0], 3, 2), np.float32)
        has_texture = False
    return MeshData(v, fv, fuv.astype(np.float32), texture, has_texture)
