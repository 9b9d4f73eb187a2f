"""Hard z-buffer triangle rasterization (PyTorch, batched over frames).

Port of ``dynhor_tpu/ops/rasterize.py``.  The dense ``rasterize`` is the
plainly correct reference: a loop over fixed-size face chunks keeps a
running (zmin, face_id) per pixel.  It renders the refine targets; the
fine step itself uses the tile-binned fused raster (ops/raster_fused.py).

Convention: pixel (i, j) has center at continuous coords (j+0.5, i+0.5),
u right, v down, matching ``project_perspective``.  Barycentrics are
screen-space (PyTorch3D perspective_correct=False).  Every function takes a
leading frame axis B, and faces either (F, 3), one mesh shared by every
frame, or (B, F, 3), a mesh per frame (the pooled multi-sequence batch,
parallel/multiseq.py, whose padding faces (0, 0, 0) have zero area).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

_BG_ZBUF = -1.0  # background zbuf value (PyTorch3D fragments.zbuf convention)


class Fragments(NamedTuple):
    pix_to_face: Tensor  # (B, H, W) int32, -1 where no face
    bary: Tensor  # (B, H, W, 3) screen-space barycentrics of the winning face
    zbuf: Tensor  # (B, H, W) camera-space depth, -1 background


def project_perspective(verts_cam: Tensor, K: Tensor) -> Tensor:
    """Camera-space verts (..., V, 3) -> (u_pix, v_pix, z_cam); K (..., 3, 3)."""
    z = verts_cam[..., 2:3]
    xy = verts_cam[..., :2] / torch.where(z.abs() < 1e-9, 1e-9, z)
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    u = fx * xy[..., 0] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v, verts_cam[..., 2]], dim=-1)


def _edge(ax, ay, bx, by, px, py):
    """Signed edge function: cross(b - a, p - a). Positive = p left of a->b."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _safe_inv(area: Tensor) -> Tensor:
    # Double-where: 1/area is never EVALUATED at degenerate faces, whose
    # backward would be inf/NaN even where the result is discarded.
    degen = area.abs() < 1e-12
    return torch.where(degen, 0.0, 1.0 / torch.where(degen, 1.0, area))


def face_verts(verts: Tensor, faces: Tensor) -> Tensor:
    """(B, F, 3, C) corners of every face: verts (B, V, C); faces (F, 3)
    shared by the B frames, or (B, F, 3) one mesh per frame."""
    faces = faces.long()
    if faces.dim() == 2:
        return verts[:, faces]
    return verts[torch.arange(verts.shape[0], device=verts.device)[:, None, None], faces]


def pixel_centers(h: int, w: int, device) -> tuple[Tensor, Tensor]:
    """Row-major (H*W,) pixel-center coordinates (gx, gy)."""
    gx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5).repeat(h)
    gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5).repeat_interleave(w)
    return gx, gy


def rasterize(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    face_chunk: int = 256,
    znear: float = 1e-2,
) -> Fragments:
    """Dense hard rasterization of B frames of one mesh.

    Args:
      verts_pix: (B, V, 3) projected (u, v, z) from project_perspective.
      faces: (F, 3) or (B, F, 3) integer vertex ids.
      face_chunk: faces per loop step (memory knob).
    """
    b = verts_pix.shape[0]
    h, w = image_size
    p = h * w
    dev = verts_pix.device
    gx, gy = pixel_centers(h, w, dev)
    faces = faces.long()
    fv_all = face_verts(verts_pix, faces)  # (B, F, 3, 3)
    zbuf = torch.full((b, p), float("inf"), device=dev)
    fid = torch.full((b, p), -1, dtype=torch.int64, device=dev)
    for s in range(0, faces.shape[-2], face_chunk):
        fv = fv_all[:, s : s + face_chunk, None]  # (B, FC, 1, 3, 3)
        x0, y0, z0 = fv[..., 0, 0], fv[..., 0, 1], fv[..., 0, 2]
        x1, y1, z1 = fv[..., 1, 0], fv[..., 1, 1], fv[..., 1, 2]
        x2, y2, z2 = fv[..., 2, 0], fv[..., 2, 1], fv[..., 2, 2]
        area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (B, FC, 1)
        inv_area = _safe_inv(area)
        # (B, FC, P) signed barycentrics (area-normalized: both windings).
        w0 = _edge(x1, y1, x2, y2, gx, gy) * inv_area
        w1 = _edge(x2, y2, x0, y0, gx, gy) * inv_area
        w2 = _edge(x0, y0, x1, y1, gx, gy) * inv_area
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area.abs() > 1e-12)
        z = w0 * z0 + w1 * z1 + w2 * z2
        z = torch.where(inside & (z > znear), z, float("inf"))
        zc, j = z.min(dim=1)  # first minimal face of the chunk
        better = zc < zbuf
        zbuf = torch.where(better, zc, zbuf)
        fid = torch.where(better, j + s, fid)
    hit = fid >= 0
    bary = barycentrics_at(verts_pix, faces, fid, gx, gy)
    return Fragments(
        pix_to_face=fid.to(torch.int32).reshape(b, h, w),
        bary=torch.where(hit[..., None], bary, 0.0).reshape(b, h, w, 3),
        zbuf=torch.where(hit, zbuf, _BG_ZBUF).reshape(b, h, w),
    )


def _bary_of_rows(r: Tensor, gx: Tensor, gy: Tensor) -> Tensor:
    x0, y0, x1, y1 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    x2, y2 = r[..., 4], r[..., 5]
    inv_area = _safe_inv((x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0))
    w0 = _edge(x1, y1, x2, y2, gx, gy) * inv_area
    w1 = _edge(x2, y2, x0, y0, gx, gy) * inv_area
    w2 = _edge(x0, y0, x1, y1, gx, gy) * inv_area
    return torch.stack([w0, w1, w2], dim=-1)


def barycentrics_at(
    verts_pix: Tensor, faces: Tensor, pix_to_face: Tensor, gx: Tensor, gy: Tensor
) -> Tensor:
    """Differentiable screen-space barycentrics of the selected faces.

    Visibility (pix_to_face) is hard, but given the winning face the
    barycentrics are smooth in the vertices — the gradient path of the
    reference's fine loss (PyTorch3D blur_radius=0, faces_per_pixel=1).

    Args:
      verts_pix: (B, V, 3); faces: (F, 3) or (B, F, 3); pix_to_face:
      (B, P), may hold -1; gx, gy: (P,) or (B, P) pixel-center coords.

    Returns: (B, P, 3) barycentrics (unclamped, normalized).
    """
    faces = faces.long()
    fidx = pix_to_face.long().clamp(0, faces.shape[-2] - 1)
    if faces.dim() == 2:
        vid = faces[fidx]  # (B, P, 3)
    else:
        vid = torch.gather(faces, 1, fidx[..., None].expand(-1, -1, 3))
    b = verts_pix.shape[0]
    fv = torch.gather(
        verts_pix[..., :2], 1, vid.reshape(b, -1, 1).expand(-1, -1, 2)
    )  # (B, P*3, 2)
    return _bary_of_rows(fv.reshape(b, -1, 6), gx, gy)


def barycentrics_from_rows(
    rows_xy: Tensor, pix_to_face: Tensor, gx: Tensor, gy: Tensor
) -> Tensor:
    """``barycentrics_at`` from pre-packed per-face rows — ONE gather hop.

    Args:
      rows_xy: (B, F, C>=6) packed [x0 y0 x1 y1 x2 y2 ...] (differentiable).
      pix_to_face: (B, P), may contain -1.
      gx, gy: (P,) or (B, P) pixel-center coords.

    Returns: (B, P, 3) barycentrics (unclamped, normalized).
    """
    fidx = pix_to_face.long().clamp(0, rows_xy.shape[1] - 1)
    r = torch.gather(
        rows_xy[..., :6], 1, fidx[..., None].expand(-1, -1, 6)
    )  # (B, P, 6)
    return _bary_of_rows(r, gx, gy)


def compute_vertex_normals(verts: Tensor, faces: Tensor) -> Tensor:
    """Area-weighted unit vertex normals (PyTorch3D verts_normals
    semantics); verts (B, V, 3), faces (F, 3) or (B, F, 3) -> (B, V, 3).

    A mesh per frame adds into the (B * V) flattened vertices through ids
    offset by b * V, one ``index_add`` per corner as for a shared mesh, so
    each vertex sums its faces' terms in the same order in both forms."""
    faces = faces.long()
    if faces.dim() == 2:
        v0 = verts[:, faces[:, 0]]
        v1 = verts[:, faces[:, 1]]
        v2 = verts[:, faces[:, 2]]
        fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # magnitude = 2*area
        vn = torch.zeros_like(verts)
        for k in range(3):
            vn = vn.index_add(1, faces[:, k], fn)
    else:
        b, v = verts.shape[:2]
        fv = face_verts(verts, faces)  # (B, F, 3, 3)
        fn = torch.linalg.cross(fv[:, :, 1] - fv[:, :, 0], fv[:, :, 2] - fv[:, :, 0], dim=-1)
        ids = faces + (torch.arange(b, device=verts.device) * v)[:, None, None]
        fn_flat = fn.reshape(-1, 3)
        vn = verts.new_zeros((b * v, 3))
        for k in range(3):
            vn = vn.index_add(0, ids[..., k].reshape(-1), fn_flat)
        vn = vn.reshape(b, v, 3)
    # Double-where normalization: vertices whose incident faces are all
    # degenerate get normal 0 with a clean zero gradient.
    n2 = (vn * vn).sum(-1, keepdim=True)
    safe = n2 > 1e-12
    n2_safe = torch.where(safe, n2, 1.0)
    return torch.where(safe, vn / torch.sqrt(n2_safe), 0.0)
