"""Intrinsics / projection algebra (PyTorch).

Port of ``dynhor_tpu/utils/camera.py``: ``project_ndc`` (the offscreen
penalty's projection), ``batch_proj2d``, ``get_K_crop_resize``,
``tco_init_from_boxes_autodepth`` (the translation init after gating) and
``intrinsics_from_image``.  Behavioral reference: ObjTracker/utils/camera.py.
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


def batch_proj2d(verts: Tensor, K: Tensor) -> Tensor:
    """Pinhole projection of camera-space points (..., V, 3) to pixels
    (..., V, 2); K (..., 3, 3).  ObjTracker/utils/camera.py:18-24."""
    hom = torch.einsum("...ij,...vj->...vi", K, verts)
    return hom[..., :2] / hom[..., 2:]


def get_K_crop_resize(K: Tensor, boxes_xyxy: Tensor, crop_size: int) -> Tensor:
    """Intrinsics after cropping to ``boxes_xyxy`` (..., 4) and resizing to
    a ``crop_size`` square (half-pixel-centered, ObjTracker/utils/
    camera.py:84-130).  K (..., 3, 3) -> (..., 3, 3)."""
    K = K.float()
    boxes = boxes_xyxy.float()
    final = float(crop_size)
    crop_w = boxes[..., 2] - boxes[..., 0]
    crop_h = boxes[..., 3] - boxes[..., 1]
    crop_cj = (boxes[..., 0] + boxes[..., 2]) / 2.0
    crop_ci = (boxes[..., 1] + boxes[..., 3]) / 2.0
    cx = K[..., 0, 2] + (crop_w - 1.0) / 2.0 - crop_cj
    cy = K[..., 1, 2] + (crop_h - 1.0) / 2.0 - crop_ci
    center_x = (crop_w - 1.0) / 2.0
    center_y = (crop_h - 1.0) / 2.0
    scale_x = final / crop_w
    scale_y = final / crop_h
    scaled_center = (final - 1.0) / 2.0
    fx = scale_x * K[..., 0, 0]
    fy = scale_y * K[..., 1, 1]
    new_cx = scaled_center + scale_x * (cx - center_x)
    new_cy = scaled_center + scale_y * (cy - center_y)
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([fx, zeros, new_cx], dim=-1)
    row1 = torch.stack([zeros, fy, new_cy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def tco_init_from_boxes_autodepth(
    boxes_xywh: Tensor, model_points_3d: Tensor, K: Tensor, num_iters: int = 10
) -> Tensor:
    """BOP-style translation init: fit the depth so that the projected
    bbox diagonal matches the detection's, in ``num_iters`` fixed-point
    steps (ObjTracker/utils/camera.py:132-176).

    Args:
      boxes_xywh: (..., 4) detection boxes in pixels.
      model_points_3d: (..., V, 3) rotated (camera-aligned) model points.
      K: (..., 3, 3).

    Returns: (..., 3) translations.
    """
    b = boxes_xywh
    boxes = torch.stack(
        [b[..., 0], b[..., 1], b[..., 0] + b[..., 2], b[..., 1] + b[..., 3]], dim=-1
    )
    diag_bb = torch.linalg.norm(boxes[..., 2:4] - boxes[..., 0:2], dim=-1)
    bb_centers = (boxes[..., 0:2] + boxes[..., 2:4]) / 2.0
    fxfy = torch.stack([K[..., 0, 0], K[..., 1, 1]], dim=-1)
    cxcy = torch.stack([K[..., 0, 2], K[..., 1, 2]], dim=-1)
    z = torch.ones(b.shape[:-1] + (1,), dtype=model_points_3d.dtype, device=b.device)
    xy = (bb_centers - cxcy) * z / fxfy
    for _ in range(num_iters):
        trans = torch.cat([xy, z], dim=-1)
        proj = batch_proj2d(model_points_3d + trans[..., None, :], K)
        pmin = proj.amin(-2)
        pmax = proj.amax(-2)
        diag_proj = torch.linalg.norm(pmax - pmin, dim=-1)
        centers = (pmin + pmax) / 2.0
        z = z + z * (diag_proj / diag_bb - 1.0)[..., None]
        xy = xy + (bb_centers - centers) * z / fxfy
    return torch.cat([xy, z], dim=-1)


def intrinsics_from_image(
    height: int, width: int, focal_factor: float = 1.2, *, device
) -> Tensor:
    """Synthesized pinhole intrinsics: f = focal_factor * min(h, w),
    c = (w // 2, h // 2) (ObjTracker/run.py:119-123)."""
    focal = focal_factor * min(height, width)
    return torch.tensor(
        [[focal, 0.0, width // 2], [0.0, focal, height // 2], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )
