"""Mask losses (PyTorch).

Port of ``dynhor_tpu/utils/masks.py:batch_mask_iou``.  Behavioral reference:
ObjTracker/utils/losses.py:7-24.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def batch_mask_iou(ref: Tensor, pred: Tensor, eps: float = 1e-6) -> Tensor:
    """Soft IoU over the last two (spatial) axes; (..., H, W) -> (...,)."""
    ref = ref.float()
    pred = pred.float()
    inter = ref * pred
    union = ref + pred - inter
    return inter.sum((-1, -2)) / (union.sum((-1, -2)) + eps)
