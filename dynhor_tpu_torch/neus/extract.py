"""Mesh extraction (marching tetrahedra) + Chamfer distance.

Port of ``dynhor_tpu/neus/extract.py``: marching TETRAHEDRA (6-tet cube
split; tiny tables, watertight output) in numpy or through the native
library (``dynhor_tpu_torch/native``), area-weighted surface samples and a
symmetric Chamfer distance (scipy's cKDTree).  The SDF grid is evaluated
in batches on the field's device; the triangle assembly runs on the host.
"""
from __future__ import annotations

import numpy as np
import torch

# Cube corner offsets (binary order: bit0=z, bit1=y, bit2=x).
_CORNERS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
    np.int64,
)
# 6-tetrahedra decomposition of the cube (indices into _CORNERS),
# all sharing the main diagonal 0-7.
_TETS = np.array(
    [[0, 5, 1, 7], [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7]],
    np.int64,
)


def _tet_triangles(tet_vals, tet_idx):
    """Triangles for one tetra case set, vectorized over tets.

    Args:
      tet_vals: (T, 4) sdf at tet corners.
      tet_idx: (T, 4) global vertex ids of tet corners.

    Returns list of (a_id, b_id) edge pairs per triangle corner:
      tris: (n_tris, 3, 2) int64 — each corner is an (edge lo, edge hi)
      global-vertex-id pair to interpolate on.
    """
    inside = tet_vals < 0.0  # (T, 4)
    case = (
        inside[:, 0].astype(np.int64)
        + inside[:, 1] * 2
        + inside[:, 2] * 4
        + inside[:, 3] * 8
    )
    tris = []
    # Edge list per case: standard marching-tets table expressed as corner
    # pairs (i, j) meaning the intersection point on edge i-j.
    E = {
        1: [[(0, 1), (0, 2), (0, 3)]],
        2: [[(1, 0), (1, 3), (1, 2)]],
        3: [[(0, 2), (0, 3), (1, 3)], [(0, 2), (1, 3), (1, 2)]],
        4: [[(2, 0), (2, 1), (2, 3)]],
        5: [[(0, 1), (2, 1), (0, 3)], [(2, 1), (2, 3), (0, 3)]],
        6: [[(1, 0), (2, 0), (1, 3)], [(2, 0), (2, 3), (1, 3)]],
        7: [[(0, 3), (1, 3), (2, 3)]],
        8: [[(3, 0), (3, 2), (3, 1)]],
        9: [[(0, 1), (0, 2), (3, 2)], [(0, 1), (3, 2), (3, 1)]],
        10: [[(1, 0), (3, 0), (1, 2)], [(3, 0), (3, 2), (1, 2)]],
        11: [[(0, 2), (3, 2), (1, 2)]],
        12: [[(2, 0), (3, 0), (2, 1)], [(3, 0), (3, 1), (2, 1)]],
        13: [[(0, 1), (2, 1), (3, 1)]],
        14: [[(1, 0), (3, 0), (2, 0)]],
    }
    for c, tri_list in E.items():
        sel = np.nonzero(case == c)[0]
        if len(sel) == 0:
            continue
        for tri in tri_list:
            corners = np.empty((len(sel), 3, 2), np.int64)
            for k, (i, j) in enumerate(tri):
                corners[:, k, 0] = tet_idx[sel, i]
                corners[:, k, 1] = tet_idx[sel, j]
            tris.append(corners)
    if not tris:
        return np.zeros((0, 3, 2), np.int64)
    return np.concatenate(tris, axis=0)


def marching_tetrahedra(
    sdf_grid: np.ndarray, origin, spacing
) -> tuple[np.ndarray, np.ndarray]:
    """Extract the sdf=0 isosurface.

    Args:
      sdf_grid: (Nx, Ny, Nz) float sdf samples (negative inside).
      origin: (3,) world position of grid[0,0,0].
      spacing: scalar or (3,) grid step.

    Returns (verts (V, 3) float32, faces (F, 3) int32).
    """
    sdf_grid = np.asarray(sdf_grid, np.float64)
    nx, ny, nz = sdf_grid.shape
    origin = np.broadcast_to(np.asarray(origin, np.float64), (3,))
    spacing = np.broadcast_to(np.asarray(spacing, np.float64), (3,))

    # Global vertex ids = flattened grid indices.
    def vid(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    # All cubes (vectorized).
    cx, cy, cz = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    cube_base = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # (C, 3)
    # Quick reject: cubes whose 8 corners are same-signed.
    corner_ids = cube_base[:, None, :] + _CORNERS[None, :, :]  # (C, 8, 3)
    vals8 = sdf_grid[corner_ids[..., 0], corner_ids[..., 1], corner_ids[..., 2]]
    active = ~((vals8 < 0).all(1) | (vals8 >= 0).all(1))
    corner_ids = corner_ids[active]
    vals8 = vals8[active]
    if corner_ids.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    gids8 = vid(corner_ids[..., 0], corner_ids[..., 1], corner_ids[..., 2])  # (C, 8)

    all_tris = []
    for tet in _TETS:
        tet_vals = vals8[:, tet]  # (C, 4)
        tet_gids = gids8[:, tet]
        tris = _tet_triangles(tet_vals, tet_gids)
        if len(tris):
            all_tris.append(tris)
    if not all_tris:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tris = np.concatenate(all_tris, axis=0)  # (F, 3, 2) edge endpoint gids

    # Unique edges -> interpolated vertices.
    edges = tris.reshape(-1, 2)
    edges_sorted = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges_sorted, axis=0, return_inverse=True)

    def gid_to_xyz(g):
        iz = g % nz
        iy = (g // nz) % ny
        ix = g // (nz * ny)
        return np.stack([ix, iy, iz], axis=-1)

    a = gid_to_xyz(uniq[:, 0])
    b = gid_to_xyz(uniq[:, 1])
    va = sdf_grid[a[:, 0], a[:, 1], a[:, 2]]
    vb = sdf_grid[b[:, 0], b[:, 1], b[:, 2]]
    tt = np.clip(va / np.where(np.abs(va - vb) < 1e-12, 1e-12, va - vb), 0.0, 1.0)
    pos = (1 - tt)[:, None] * a + tt[:, None] * b
    verts = origin[None] + pos * spacing[None]
    faces = inv.reshape(-1, 3)
    return verts.astype(np.float32), faces.astype(np.int32)


def sdf_grid_from_field(sdf_eval, resolution: int = 128, bound: float = 1.0,
                        batch: int = 65536, device=None) -> np.ndarray:
    """``sdf_eval(points (N, 3) tensor) -> (N,)`` on the (resolution^3)
    grid over [-bound, bound]^3, ``batch`` points a call on ``device`` (None
    = the CPU); returns the (R, R, R) f32 grid on the host."""
    xs = np.linspace(-bound, bound, resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)
    pts = torch.from_numpy(grid).to(device)
    with torch.no_grad():
        out = torch.cat([sdf_eval(pts[i : i + batch]).reshape(-1)
                         for i in range(0, pts.shape[0], batch)])
    return out.float().cpu().numpy().reshape(resolution, resolution, resolution)


def mesh_from_sdf_grid(sdf_grid: np.ndarray, bound: float = 1.0, use_native: bool = True):
    """The zero level set of a grid over [-bound, bound]^3: (verts, faces).
    ``use_native`` builds and runs the C++ library (raising if g++
    fails); False runs the numpy version."""
    resolution = sdf_grid.shape[0]
    spacing = 2.0 * bound / (resolution - 1)
    origin = (-bound, -bound, -bound)
    if use_native:
        from .. import native

        return native.marching_tetrahedra_native(sdf_grid, origin=origin, spacing=spacing)
    return marching_tetrahedra(sdf_grid, origin=origin, spacing=spacing)


def extract_mesh_from_field(sdf_eval, resolution: int = 128, bound: float = 1.0,
                            batch: int = 65536, use_native: bool = True, device=None):
    """Evaluate ``sdf_eval`` on a grid (``sdf_grid_from_field``) and extract
    its zero level set (``mesh_from_sdf_grid``)."""
    grid = sdf_grid_from_field(sdf_eval, resolution, bound, batch, device)
    return mesh_from_sdf_grid(grid, bound, use_native)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int, seed: int = 0):
    """Area-weighted uniform surface samples."""
    if len(faces) == 0:
        return np.zeros((0, 3), np.float32)
    rng = np.random.RandomState(seed)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    idx = rng.choice(len(faces), size=n, p=p)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return (1 - r1) * v0[idx] + r1 * (1 - r2) * v1[idx] + r1 * r2 * v2[idx]


def chamfer_distance(
    verts_a, faces_a, verts_b, faces_b, n_samples: int = 10000, seed: int = 0
) -> float:
    """Symmetric point-sampled Chamfer distance (mean of both directions)."""
    from scipy.spatial import cKDTree

    pa = sample_surface(np.asarray(verts_a), np.asarray(faces_a), n_samples, seed)
    pb = sample_surface(np.asarray(verts_b), np.asarray(faces_b), n_samples, seed + 1)
    if len(pa) == 0 or len(pb) == 0:
        return float("inf")
    da, _ = cKDTree(pb).query(pa)
    db, _ = cKDTree(pa).query(pb)
    return float(da.mean() + db.mean()) / 2.0
