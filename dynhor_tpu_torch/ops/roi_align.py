"""ROIAlign-style crop and resize (PyTorch, batched over boxes).

Port of ``dynhor_tpu/ops/roi_align.py`` (``roi_align``,
``crop_and_resize``), which replaces detectron2's
``ROIAlign(aligned=True)`` (ObjTracker/utils/bbox.py:8-36,
pose_initializtion.py:212).  Bilinear sampling is separable per axis, so a
crop is two gathers with per-sample weights, rows then columns, and then
the mean over each bin's ratio x ratio samples.  ``sampling_ratio`` is
static (2), as in the reference's jit version.  The host path
(``roi_align_exact_np``, ``crop_mask_bool_np``) is numpy, copied operation
for operation from the JAX package: detectron2's adaptive ``ceil(roi /
out)`` samples per bin, in f64, feeding crop masks that threshold at 0.5.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _axis_samples(start: Tensor, roi_len: Tensor, out_size: int, ratio: int, src_size: int):
    """Sample positions along one axis, as bilinear gather indices and
    weights.  start, roi_len: (N,).  Returns (idx0, idx1, w0, w1), each
    (N, out_size * ratio)."""
    # Rounded as XLA compiles the reference: roi / out_size as a product
    # with the f32 reciprocal, and start + bin_idx * bin_size as one fused
    # multiply-add (an f64 product of two f32 values is exact).  The crop
    # masks threshold bilinear averages at 0.5, where one ulp decides.
    inv_out = torch.tensor(1.0 / out_size, dtype=roi_len.dtype, device=roi_len.device)
    bin_size = (roi_len * inv_out)[:, None]
    i = torch.arange(out_size * ratio, device=start.device)
    bin_idx = i // ratio
    sub_idx = i % ratio
    pos0 = (bin_idx.double() * bin_size.double() + start[:, None].double()).float()
    pos = pos0 + (sub_idx + 0.5) * (bin_size / ratio)
    valid = (pos >= -1.0) & (pos <= src_size)
    p = pos.clamp_min(0.0)
    i0 = torch.floor(p).clamp_max(src_size - 1).long()
    at_edge = i0 >= src_size - 1
    i1 = (i0 + 1).clamp_max(src_size - 1)
    frac = torch.where(at_edge, 0.0, p - i0)
    w1 = torch.where(valid, frac, 0.0)
    w0 = torch.where(valid, 1.0 - frac, 0.0)
    return i0, i1, w0, w1


def crop_and_resize(
    images: Tensor, boxes_xyxy: Tensor, output_size: int, sampling_ratio: int = 2
) -> Tensor:
    """Crop one box per image and resize it to a square, ROIAlign-style
    (aligned=True: half-pixel offset).

    Args:
      images: (N, C, H, W).
      boxes_xyxy: (N, 4) crop boxes in source pixels.

    Returns: (N, C, S, S) float32.
    """
    n_img, c, h, w = images.shape
    img = images.float()
    x1, y1, x2, y2 = boxes_xyxy.float().unbind(-1)
    yi0, yi1, wy0, wy1 = _axis_samples(y1 - 0.5, y2 - y1, output_size, sampling_ratio, h)
    xi0, xi1, wx0, wx1 = _axis_samples(x1 - 0.5, x2 - x1, output_size, sampling_ratio, w)
    n = output_size * sampling_ratio

    def rows_at(idx):
        return torch.gather(img, 2, idx[:, None, :, None].expand(n_img, c, n, w))

    rows = rows_at(yi0) * wy0[:, None, :, None] + rows_at(yi1) * wy1[:, None, :, None]

    def cols_at(idx):
        return torch.gather(rows, 3, idx[:, None, None, :].expand(n_img, c, n, n))

    vals = cols_at(xi0) * wx0[:, None, None, :] + cols_at(xi1) * wx1[:, None, None, :]
    # Mean over each bin's samples, summed in row-major order as the
    # reference reduces them: thresholds on the result (crop masks) see the
    # same rounding.
    r = sampling_ratio
    vals = vals.reshape(n_img, c, output_size, r, output_size, r)
    acc = vals[:, :, :, 0, :, 0]
    for a in range(r):
        for b in range(r):
            if a or b:
                acc = acc + vals[:, :, :, a, :, b]
    return acc / (r * r)


def roi_align(
    image: Tensor, box_xyxy: Tensor, output_size: int, sampling_ratio: int = 2
) -> Tensor:
    """``crop_and_resize`` of one (C, H, W) image and one (4,) box ->
    (C, S, S)."""
    return crop_and_resize(image[None], box_xyxy[None], output_size, sampling_ratio)[0]


def roi_align_exact_np(
    image: np.ndarray, box_xyxy: np.ndarray, output_size: int
) -> np.ndarray:
    """Exact detectron2 ROIAlign(aligned=True, sampling_ratio=0) in numpy.

    Host-side preprocessing path (reference: run.py:47-50 operates per frame
    on the host before optimization).  Uses the adaptive
    ``ceil(bin)``-samples rule that the jit version approximates statically.

    Args:
      image: (C, H, W).
      box_xyxy: (4,).

    Returns: (C, S, S) float32.
    """
    c, h, w = image.shape
    x1, y1, x2, y2 = [float(v) for v in box_xyxy]
    roi_w, roi_h = x2 - x1, y2 - y1
    start_x, start_y = x1 - 0.5, y1 - 0.5
    s = output_size
    bin_w, bin_h = roi_w / s, roi_h / s
    grid_h = max(int(np.ceil(roi_h / s)), 1)
    grid_w = max(int(np.ceil(roi_w / s)), 1)

    def axis(start, bin_size, grid, size):
        i = np.arange(s * grid)
        pos = start + (i // grid) * bin_size + (i % grid + 0.5) * (bin_size / grid)
        valid = (pos >= -1.0) & (pos <= size)
        p = np.maximum(pos, 0.0)
        i0 = np.minimum(np.floor(p), size - 1).astype(np.int64)
        at_edge = i0 >= size - 1
        i1 = np.minimum(i0 + 1, size - 1)
        frac = np.where(at_edge, 0.0, p - i0)
        return i0, i1, np.where(valid, 1 - frac, 0.0), np.where(valid, frac, 0.0)

    yi0, yi1, wy0, wy1 = axis(start_y, bin_h, grid_h, h)
    xi0, xi1, wx0, wx1 = axis(start_x, bin_w, grid_w, w)
    img = image.astype(np.float64)
    rows = img[:, yi0, :] * wy0[None, :, None] + img[:, yi1, :] * wy1[None, :, None]
    vals = rows[:, :, xi0] * wx0[None, None, :] + rows[:, :, xi1] * wx1[None, None, :]
    vals = vals.reshape(c, s, grid_h, s, grid_w).mean(axis=(2, 4))
    return vals.astype(np.float32)


def crop_mask_bool_np(mask: np.ndarray, box_xyxy: np.ndarray, output_size: int) -> np.ndarray:
    """BitMasks.crop_and_resize equivalent: ROIAlign the 0/1 mask, threshold
    at 0.5 -> bool (detectron2 BitMasks.crop_and_resize semantics)."""
    out = roi_align_exact_np(mask[None].astype(np.float32), box_xyxy, output_size)[0]
    return out >= 0.5
