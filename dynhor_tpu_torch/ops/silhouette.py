"""Dense differentiable soft silhouette (PyTorch, batched over frames).

Port of ``dynhor_tpu/ops/silhouette.py``.  SoftRas-style coverage (Liu et
al., ICCV'19): each face adds softplus(+-dist/sigma) of the pixel's linear
distance to its nearest edge (+ inside), the union 1 - prod(1 - p) is
1 - exp(-sum), and a loop over face chunks accumulates the (B, H*W) mass.
Each chunk is recomputed in the backward (``torch.utils.checkpoint``, as
the JAX package's ``jax.checkpoint``), so memory is one chunk's
(B, face_chunk, H*W) temporaries.  No kernel: the JAX package leaves this
to XLA.  Linear distance only, as everywhere in the port.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .rasterize import face_verts, pixel_centers, rasterize

Tensor = torch.Tensor


def _point_segment_dist2(px, py, ax, ay, bx, by, eps=1e-12):
    """Squared distance from point p to segment a-b (all broadcastable)."""
    abx = bx - ax
    aby = by - ay
    apx = px - ax
    apy = py - ay
    denom = abx * abx + aby * aby
    t = ((apx * abx + apy * aby) / denom.clamp_min(eps)).clamp(0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def face_pixel_bary(fv: Tensor, px: Tensor, py: Tensor):
    """Per (pixel, face) barycentrics and inside test, in the JAX package's
    order of operations.  fv: (..., N, 3, 3) face vertices (u, v, z); px,
    py: (..., P, 1) pixel centers.  Returns ((x, y, z) per vertex, each
    (..., 1, N)), (w0, w1, w2) (..., P, N), inside (..., P, N) and the
    signed area (..., 1, N)."""
    verts = [tuple(fv[..., i, k].unsqueeze(-2) for k in range(3)) for i in range(3)]
    (x0, y0, _), (x1, y1, _), (x2, y2, _) = verts
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    degen = area.abs() < 1e-12  # double-where: no 1/0 in the backward
    inv_area = torch.where(degen, 0.0, 1.0 / torch.where(degen, 1.0, area))
    w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area
    w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area
    w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (area.abs() > 1e-12)
    return verts, (w0, w1, w2), inside, area


def softplus_mass(fv: Tensor, valid: Tensor, px: Tensor, py: Tensor, sigma: float, znear: float):
    """sum over faces of softplus(logit) per pixel.

    fv: (..., N, 3, 3) face vertices (u, v, z); valid: (..., N) bool;
    px, py: (..., P, 1) pixel centers.  Returns (..., P)."""
    verts, _, inside, area = face_pixel_bary(fv, px, py)
    (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = verts
    sign = torch.where(inside, 1.0, -1.0)
    d2 = torch.minimum(
        _point_segment_dist2(px, py, x0, y0, x1, y1),
        torch.minimum(
            _point_segment_dist2(px, py, x1, y1, x2, y2),
            _point_segment_dist2(px, py, x2, y2, x0, y0),
        ),
    )
    logit = sign * torch.sqrt(d2.clamp_min(1e-12)) * (1.0 / sigma)
    # Faces behind the camera, padding and degenerate faces add no mass.
    visible = (
        valid.unsqueeze(-2) & ((z0 > znear) | (z1 > znear) | (z2 > znear))
        & (area.abs() > 1e-12)
    )
    softplus = logit.clamp_min(0.0) + torch.log1p(torch.exp(-logit.abs()))
    return torch.where(visible, softplus, 0.0).sum(-1)


def soft_silhouette(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    face_chunk: int = 512,
    znear: float = 1e-2,
) -> Tensor:
    """Soft silhouette in [0, 1] of B frames of one mesh.

    Args:
      verts_pix: (B, V, 3) projected (u_pix, v_pix, z_cam); gradients flow
        to these.
      faces: (F, 3), or (B, F, 3) a mesh per frame.
      sigma: edge softness; the logit is signed_distance / sigma.
      face_chunk: faces per loop step (memory knob).
      znear: faces entirely behind this depth are dropped.

    Returns: (B, H, W) float32 coverage.
    """
    b = verts_pix.shape[0]
    h, w = image_size
    gx, gy = pixel_centers(h, w, verts_pix.device)
    px, py = gx[:, None], gy[:, None]  # (P, 1)
    fv_all = face_verts(verts_pix, faces)  # (B, F, 3, 3)
    valid = torch.ones(fv_all.shape[:2], dtype=torch.bool, device=verts_pix.device)
    acc = verts_pix.new_zeros((b, h * w))
    for s in range(0, faces.shape[-2], face_chunk):
        acc = acc + checkpoint(
            softplus_mass, fv_all[:, s : s + face_chunk], valid[:, s : s + face_chunk],
            px, py, sigma, znear, use_reentrant=False,
        )
    return (1.0 - torch.exp(-acc)).reshape(b, h, w)


def silhouette_straight_through(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    hard: Tensor | None = None,
    sigma: float = 0.25,
    face_chunk: int = 512,
) -> Tensor:
    """Hard silhouette forward, soft silhouette backward:
    ``soft + (hard - soft).detach()``.

    Args:
      hard: optional precomputed (B, H, W) hard coverage; by default the
        dense hard raster's.
    """
    soft = soft_silhouette(verts_pix, faces, image_size, sigma=sigma, face_chunk=face_chunk)
    if hard is None:
        frag = rasterize(verts_pix, faces, image_size, face_chunk=face_chunk)
        hard = (frag.pix_to_face >= 0).to(soft.dtype)
    return soft + (hard - soft).detach()
