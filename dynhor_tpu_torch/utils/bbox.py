"""Bounding-box algebra (PyTorch).

Port of ``dynhor_tpu/utils/bbox.py``.
Behavioral reference: ObjTracker/utils/bbox.py (detectron2 BoxMode
XYXY<->XYWH) and the tight-bbox extraction in ObjTracker/run.py:35-43 /
pose_initializtion.py:201-208.  Boxes carry any leading batch dims.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def bbox_xy_to_wh(bbox: Tensor) -> Tensor:
    """(x1, y1, x2, y2) -> (x, y, w, h).  Reference: utils/bbox.py:92-103."""
    return torch.cat([bbox[..., :2], bbox[..., 2:4] - bbox[..., :2]], dim=-1)


def bbox_wh_to_xy(bbox: Tensor) -> Tensor:
    """(x, y, w, h) -> (x1, y1, x2, y2).  Reference: utils/bbox.py:106-117."""
    return torch.cat([bbox[..., :2], bbox[..., :2] + bbox[..., 2:4]], dim=-1)


def make_bbox_square(bbox_xywh: Tensor, bbox_expansion: float = 0.0) -> Tensor:
    """Square box with the same center, side = max(w, h) * (1 + expansion)
    (ObjTracker/utils/bbox.py:70-89)."""
    b = bbox_xywh
    cx = b[..., 0] + b[..., 2] / 2.0
    cy = b[..., 1] + b[..., 3] / 2.0
    side = torch.maximum(b[..., 2], b[..., 3]) * (1.0 + bbox_expansion)
    return torch.stack([cx - side / 2.0, cy - side / 2.0, side, side], dim=-1)


def mask_tight_bbox_xyxy(mask: Tensor, pad: float = 5.0) -> Tensor:
    """Tight xyxy box around the nonzero pixels of each mask, padded by
    ``pad`` and clamped to the image.

    The min/max over ``any`` rows and columns with 1<<30 sentinels (no
    ``nonzero``), so it makes no host sync.  An empty mask gives the
    reference's sentinel box, clamped.

    Args:
      mask: (..., H, W) boolean or {0, 1}.

    Returns: (..., 4) float32 (x1, y1, x2, y2).
    """
    h, w = mask.shape[-2:]
    m = mask > 0
    rows = m.any(dim=-1)  # (..., H)
    cols = m.any(dim=-2)  # (..., W)
    row_idx = torch.arange(h, device=mask.device)
    col_idx = torch.arange(w, device=mask.device)
    big = 1 << 30
    min_row = torch.where(rows, row_idx, big).amin(-1)
    max_row = torch.where(rows, row_idx, -big).amax(-1)
    min_col = torch.where(cols, col_idx, big).amin(-1)
    max_col = torch.where(cols, col_idx, -big).amax(-1)
    x1 = (min_col.float() - pad).clamp_min(0.0)
    y1 = (min_row.float() - pad).clamp_min(0.0)
    x2 = (max_col.float() + pad).clamp_max(float(w))
    y2 = (max_row.float() + pad).clamp_max(float(h))
    return torch.stack([x1, y1, x2, y2], dim=-1)


def compute_iou(bbox1, bbox2):
    """IoU of two xyxy boxes (ObjTracker/utils/bbox.py:143-163): tensors,
    or numpy arrays on the host."""
    if isinstance(bbox1, Tensor):
        b1, b2 = bbox1, torch.as_tensor(bbox2, device=bbox1.device)
        maximum, minimum = torch.maximum, torch.minimum
    else:
        b1, b2 = np.asarray(bbox1), np.asarray(bbox2)
        maximum, minimum = np.maximum, np.minimum
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lt = maximum(b1[..., :2], b2[..., :2])
    rb = minimum(b1[..., 2:4], b2[..., 2:4])
    wh = (rb - lt).clip(0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (a1 + a2 - inter)
