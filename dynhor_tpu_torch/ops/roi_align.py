"""ROIAlign-style crop and resize (PyTorch, batched over boxes).

Port of ``dynhor_tpu/ops/roi_align.py`` (``roi_align``,
``crop_and_resize``), which replaces detectron2's
``ROIAlign(aligned=True)`` (ObjTracker/utils/bbox.py:8-36,
pose_initializtion.py:212).  Bilinear sampling is separable per axis, so a
crop is two gathers with per-sample weights, rows then columns, and then
the mean over each bin's ratio x ratio samples.  ``sampling_ratio`` is
static (2), as in the reference's jit version; detectron2's adaptive
``ceil(roi / out)`` samples per bin is the host path's, not ported here.
"""
from __future__ import annotations

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
