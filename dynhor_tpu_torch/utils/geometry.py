"""Rotation representations and SO(3) sampling (PyTorch).

Port of ``dynhor_tpu/utils/geometry.py``.
Behavioral reference: ObjTracker/utils/geometry.py (rot6d, Zhou CVPR'19),
ObjTracker/utils/render.py:56-93 (Avro'92 uniform sampling) and :95-123,
221-234 (the look-at grid of prior views and its in-plane rolls).

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


def look_at_rotation(camera_pos: Tensor, at: Tensor, up=(0.0, 1.0, 0.0)) -> Tensor:
    """World-to-camera rotation (OpenCV column convention, +z forward, y
    down) of a camera at ``camera_pos`` looking toward ``at``:
    ``X_cam = R_cv @ X_world + t_cv`` with ``t_cv = -R_cv @ camera_pos``.
    Looking straight up or down, x falls back to (1, 0, 0)."""
    up = torch.as_tensor(up, dtype=camera_pos.dtype, device=camera_pos.device)
    z_axis = at - camera_pos
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=-1, keepdim=True).clamp_min(1e-12)
    x_axis = torch.linalg.cross(up.expand_as(z_axis), z_axis, dim=-1)
    x_norm = torch.linalg.norm(x_axis, dim=-1, keepdim=True)
    fallback = torch.tensor(
        [1.0, 0.0, 0.0], dtype=camera_pos.dtype, device=camera_pos.device
    ).expand_as(z_axis)
    x_axis = torch.where(x_norm > 1e-6, x_axis / x_norm.clamp_min(1e-12), fallback)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)
    # OpenCV has +y image-down; x flips with y to keep det = +1.
    return torch.stack((-x_axis, -y_axis, z_axis), dim=-2)


def spherical_camera_rotations(
    num_azimuth: int, num_elevation: int, dtype=torch.float32
) -> Tensor:
    """Azimuth x elevation grid of OpenCV world-to-camera rotations
    (ObjTracker/utils/render.py:95-123): ``num_elevation`` elevations
    strictly between the poles, times ``num_azimuth`` azimuths, then the two
    polar views.  Returns (num_azimuth * num_elevation + 2, 3, 3)."""
    azim = torch.linspace(0.0, 360.0, num_azimuth + 1)[:-1]
    elev = torch.linspace(-90.0, 90.0, num_elevation + 2)[1:-1]
    ee, aa = torch.meshgrid(elev, azim, indexing="ij")
    angles = torch.stack([aa.reshape(-1), ee.reshape(-1)], dim=1)
    top_down = torch.tensor([[0.0, -90.0 + 1e-3], [0.0, 90.0 - 1e-3]])
    angles = torch.cat([angles, top_down], dim=0).to(dtype)
    a = torch.deg2rad(angles[:, 0])
    e = torch.deg2rad(angles[:, 1])
    # PyTorch3D's spherical convention: x = cos(e) sin(a), y = sin(e),
    # z = cos(e) cos(a).
    pos = torch.stack(
        [torch.cos(e) * torch.sin(a), torch.sin(e), torch.cos(e) * torch.cos(a)], dim=1
    )
    return look_at_rotation(pos, torch.zeros((1, 3), dtype=dtype))


def roll_matrices(num_roll: int, dtype=torch.float32) -> Tensor:
    """In-plane rolls about +z at linspace(-180, 180, num_roll) degrees
    (ObjTracker/utils/render.py:224-234)."""
    if num_roll == 1:
        angles = torch.zeros((1,), dtype=dtype)
    else:
        angles = torch.deg2rad(torch.linspace(-180.0, 180.0, num_roll)).to(dtype)
    c, s = torch.cos(angles), torch.sin(angles)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], dim=1), torch.stack([s, c, z], dim=1),
         torch.stack([z, z, o], dim=1)],
        dim=1,
    )


def matrix_to_quaternion(R: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (w, x, y, z) (..., 4),
    Shepperd's method without branches: the best-conditioned of four
    candidates, sign chosen so that w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None].expand(*best.shape, 1, 4), dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    return q * torch.sign(torch.where(q[..., :1] == 0, 1.0, q[..., :1]))


def quaternion_to_matrix(q: Tensor) -> Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def quaternion_slerp(q0: Tensor, q1: Tensor, t) -> Tensor:
    """Spherical interpolation between unit quaternions (shortest arc)."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = dot.abs().clamp(-1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.ndim == q0.ndim - 1:
        t = t[..., None]
    small = sin_theta < 1e-5
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_theta.clamp_min(1e-12))
    w1 = torch.where(small, t, torch.sin(t * theta) / sin_theta.clamp_min(1e-12))
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.norm(out, dim=-1, keepdim=True).clamp_min(1e-12)


def center_and_normalize_verts(verts: Tensor) -> Tensor:
    """Center at the centroid; scale so the max vertex norm is 0.5
    (ObjTracker/run.py:110-112)."""
    verts = verts - verts.mean(dim=0, keepdim=True)
    return verts / torch.linalg.norm(verts, dim=1).max() * 0.5
