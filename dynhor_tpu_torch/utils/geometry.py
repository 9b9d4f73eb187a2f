"""Rotation representations and SO(3) sampling (PyTorch).

Port of ``dynhor_tpu/utils/geometry.py`` (the parts the fine refine, the
prior scoring and the gating use).
Behavioral reference: ObjTracker/utils/geometry.py (rot6d, Zhou CVPR'19),
ObjTracker/utils/render.py:56-93 (Avro'92 uniform sampling).

Vertices are ROW vectors throughout the tracker: ``verts @ R + T``; the
OpenCV column-convention matrix is the transpose of ``R``.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def rot6d_to_matrix(rot_6d: Tensor) -> Tensor:
    """Continuous 6D rotation -> 3x3 matrix via Gram-Schmidt.

    The 6D code is the first two COLUMNS of the matrix.

    Args:
      rot_6d: (..., 6) or (..., 3, 2).

    Returns: (..., 3, 3) rotation matrices.
    """
    lead = rot_6d.shape[:-1] if rot_6d.shape[-1] == 6 else rot_6d.shape[:-2]
    r = rot_6d.reshape(lead + (3, 2))
    a1 = r[..., 0]
    a2 = r[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    a2_proj = (b1 * a2).sum(-1, keepdim=True) * b1
    b2u = a2 - a2_proj
    b2 = b2u / torch.linalg.norm(b2u, dim=-1, keepdim=True).clamp_min(1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack((b1, b2, b3), dim=-1)


def matrix_to_rot6d(rotmat: Tensor) -> Tensor:
    """3x3 rotation -> 6D code (first two columns), shape (..., 3, 2)."""
    return rotmat[..., :, :2]


def rotation_angle_difference(R1: Tensor, R2: Tensor) -> Tensor:
    """Geodesic angle between rotation matrices, in degrees: the angle of
    ``R1 @ R2^T`` (ObjTracker/utils/camera.py:4-9), its cosine clipped to
    [-1, 1] before the arccos.  Broadcasts over leading dims."""
    R_rel = torch.einsum("...ij,...kj->...ik", R1, R2)
    trace = R_rel.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos_theta = (0.5 * (trace - 1.0)).clamp(-1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos_theta))


def rotations_from_uniforms(x: Tensor) -> Tensor:
    """Avro'92 rotations (``-H @ Rz``, Householder ``H = I - 2 v v^T``) from
    (3, n) uniforms in [0, 1); uniform (Haar) when ``x`` is."""
    x1, x2, x3 = x[0], x[1], x[2]
    tau = 2.0 * math.pi
    c1, s1 = torch.cos(tau * x1), torch.sin(tau * x1)
    zeros, ones = torch.zeros_like(x1), torch.ones_like(x1)
    R = torch.stack(
        (
            torch.stack((c1, s1, zeros), dim=1),
            torch.stack((-s1, c1, zeros), dim=1),
            torch.stack((zeros, zeros, ones), dim=1),
        ),
        dim=1,
    )  # (n, 3, 3)
    v = torch.stack(
        (
            torch.cos(tau * x2) * torch.sqrt(x3),
            torch.sin(tau * x2) * torch.sqrt(x3),
            torch.sqrt(1.0 - x3),
        ),
        dim=1,
    )  # (n, 3)
    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[1], 3, 3)
    H = eye - 2.0 * v[:, :, None] * v[:, None, :]
    return -torch.matmul(H, R)


def random_rotations(n: int, generator: torch.Generator | None = None) -> Tensor:
    """(n, 3, 3) uniform random rotations on the CPU, from uniforms drawn
    from ``generator`` (so a seed gives the same rotations wherever they are
    moved).  For rotations on another device, pass its uniforms to
    ``rotations_from_uniforms``."""
    x = torch.rand((3, n), generator=generator, dtype=torch.float32)
    return rotations_from_uniforms(x)


def center_and_normalize_verts(verts: Tensor) -> Tensor:
    """Center at the centroid; scale so the max vertex norm is 0.5
    (ObjTracker/run.py:110-112)."""
    verts = verts - verts.mean(dim=0, keepdim=True)
    return verts / torch.linalg.norm(verts, dim=1).max() * 0.5
