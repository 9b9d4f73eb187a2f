"""Generate a procedural kettle mesh (body, lid knob, spout, handle) as OBJ.

Twin of ``tools/make_kettle_mesh.py`` (numpy only): the same vertices and
faces, the same OBJ text.  The reference's second demo sequence is a
kettle; its data is external, so this makes a kettle-like object for the
synthetic pipeline (``tools.make_demo_data --obj assets/kettle/kettle.obj``).

    python -m dynhor_tpu_torch.tools.make_kettle_mesh --out assets/kettle/kettle.obj
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _uv_sphere(center, radius, n_theta=24, n_phi=32, squash=1.0):
    """Squashed UV sphere; returns (verts, faces)."""
    thetas = np.linspace(0, np.pi, n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = [
        [radius * np.sin(t) * np.cos(p), squash * radius * np.cos(t),
         radius * np.sin(t) * np.sin(p)]
        for t in thetas for p in phis
    ]
    verts = np.asarray(verts) + np.asarray(center)
    faces = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts, np.asarray(faces, np.int64)


def _tube(path_pts, radius, n_seg=10):
    """Tube swept along a polyline; returns (verts, faces)."""
    path = np.asarray(path_pts, float)
    verts = []
    for k, p in enumerate(path):
        d = path[k + 1] - p if k + 1 < len(path) else p - path[k - 1]
        d = d / max(np.linalg.norm(d), 1e-9)
        a = np.array([0.0, 1.0, 0.0]) if abs(d[1]) < 0.9 else np.array([1.0, 0.0, 0.0])
        u = np.cross(d, a)
        u /= max(np.linalg.norm(u), 1e-9)
        v = np.cross(d, u)
        for s in range(n_seg):
            ang = 2 * np.pi * s / n_seg
            verts.append(p + radius * (np.cos(ang) * u + np.sin(ang) * v))
    verts = np.asarray(verts)
    faces = []
    for k in range(len(path) - 1):
        for s in range(n_seg):
            a = k * n_seg + s
            b = k * n_seg + (s + 1) % n_seg
            c = (k + 1) * n_seg + s
            d = (k + 1) * n_seg + (s + 1) % n_seg
            faces.append([a, b, c])
            faces.append([b, d, c])
    return verts, np.asarray(faces, np.int64)


def kettle_mesh() -> tuple[np.ndarray, np.ndarray]:
    """(verts (V, 3) float64, faces (F, 3) int64, 0-based)."""
    parts = [
        _uv_sphere((0, 0, 0), 0.5, squash=0.8),  # body
        _uv_sphere((0, 0.42, 0), 0.12, n_theta=12, n_phi=16),  # lid knob
    ]
    t = np.linspace(0, 1, 8)  # spout: a tube from the body out and up
    parts.append(_tube(np.stack(
        [0.35 + 0.45 * t, -0.1 + 0.45 * t**1.5, np.zeros_like(t)], axis=1), 0.09))
    a = np.linspace(-0.75 * np.pi, -0.25 * np.pi, 12)  # handle: an arc over the top
    parts.append(_tube(np.stack(
        [0.75 * np.cos(a), 0.35 + 0.75 * -np.sin(a) * 0.55, np.zeros_like(a)], axis=1), 0.06))
    verts_all, faces_all, off = [], [], 0
    for v, f in parts:
        verts_all.append(v)
        faces_all.append(f + off)
        off += len(v)
    return np.concatenate(verts_all), np.concatenate(faces_all)


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    lines = [f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts]
    lines += [f"f {tri[0]} {tri[1]} {tri[2]}\n" for tri in faces + 1]
    return "".join(lines)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="assets/kettle/kettle.obj")
    args = parser.parse_args(argv)
    verts, faces = kettle_mesh()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write(obj_text(verts, faces))
    print(f"kettle: {len(verts)} verts / {len(faces)} faces -> {args.out}")


if __name__ == "__main__":
    main()
