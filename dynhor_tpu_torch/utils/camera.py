"""Intrinsics / projection algebra (PyTorch).

Port of ``dynhor_tpu/utils/camera.py:project_ndc`` (the offscreen penalty's
projection).  Behavioral reference: ObjTracker/utils/camera.py:26-63.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def project_ndc(verts_cam: Tensor, K01: Tensor, eps: float = 1e-9) -> Tensor:
    """Project camera-space verts with a [0,1]-normalized K to nr-style NDC.

    neural_renderer's projection with ``orig_size=1`` and all-zero lens
    distortion (as the released reference runs it): perspective divide, K in
    [0,1] units, y flip, then map to [-1, 1].

    Args:
      verts_cam: (..., V, 3).
      K01: (..., 3, 3) intrinsics normalized so the image spans [0, 1].

    Returns: (..., V, 3) — (u, v) in [-1, 1] (y up) and camera-space depth z.
    """
    x = verts_cam[..., 0]
    y = verts_cam[..., 1]
    z = verts_cam[..., 2]
    x_ = x / (z + eps)
    y_ = y / (z + eps)
    v3 = torch.stack([x_, y_, torch.ones_like(z)], dim=-1)
    uv1 = torch.einsum("...ij,...vj->...vi", K01, v3)
    u = 2.0 * (uv1[..., 0] - 0.5)
    v = 2.0 * ((1.0 - uv1[..., 1]) - 0.5)
    return torch.stack([u, v, z], dim=-1)
