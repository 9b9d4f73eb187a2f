"""Image resizing matching torch.nn.functional.interpolate semantics.

Port of ``dynhor_tpu/ops/resize.py``: the bicubic resampling matrices are
numpy copies (built once per static shape); a resize is two contractions
``W_y @ img @ W_x^T``.  ``resize_bicubic_align_corners`` is the render's
upsampling to the ViT's edge in the fine-step profiler; ``resize_nearest`` is
the mask downsampling of the semantic loss.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor

_A = -0.75  # torch bicubic coefficient (cubic convolution, Keys 1981)


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w1 = (_A + 2.0) * ax3 - (_A + 3.0) * ax2 + 1.0
    w2 = _A * ax3 - 5.0 * _A * ax2 + 8.0 * _A * ax - 4.0 * _A
    return np.where(ax <= 1.0, w1, np.where(ax < 2.0, w2, 0.0))


def _resampling_matrix(src: np.ndarray, in_size: int) -> np.ndarray:
    base = np.floor(src).astype(np.int64)
    t = src - base
    out_size = src.shape[0]
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), _cubic_kernel(tap - t))
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _bicubic_matrix_ac(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) resampling matrix, align_corners=True, clamped taps."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    if out_size > 1:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = np.zeros(1)
    return _resampling_matrix(src, in_size)


@functools.lru_cache(maxsize=64)
def _bicubic_matrix_halfpix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) resampling matrix, align_corners=False
    (src = (dst + 0.5) * in/out - 0.5), clamped taps."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    return _resampling_matrix(src, in_size)


def resize_bicubic_align_corners(images: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bicubic resize, align_corners=True (torch parity);
    (..., H, W) -> (..., out_h, out_w) float32."""
    h, w = images.shape[-2], images.shape[-1]
    wy = torch.as_tensor(_bicubic_matrix_ac(h, out_h), device=images.device)
    wx = torch.as_tensor(_bicubic_matrix_ac(w, out_w), device=images.device)
    x = torch.einsum("oh,...hw->...ow", wy, images.float())
    return torch.einsum("pw,...hw->...hp", wx, x)


def resize_bicubic_halfpix(images: Tensor, out_h: int, out_w: int) -> Tensor:
    """Bicubic resize, align_corners=False (torch parity, no antialias);
    (..., H, W) -> (..., out_h, out_w) float32."""
    h, w = images.shape[-2], images.shape[-1]
    wy = torch.as_tensor(_bicubic_matrix_halfpix(h, out_h), device=images.device)
    wx = torch.as_tensor(_bicubic_matrix_halfpix(w, out_w), device=images.device)
    x = torch.einsum("oh,...hw->...ow", wy, images.float())
    return torch.einsum("pw,...hw->...hp", wx, x)


@functools.lru_cache(maxsize=64)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """torch 'nearest' source indices: floor(dst * in / out)."""
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.minimum(idx, in_size - 1)


def resize_nearest(images: Tensor, out_h: int, out_w: int) -> Tensor:
    """Nearest-neighbor resize (torch 'nearest' parity); (..., H, W)."""
    h, w = images.shape[-2], images.shape[-1]
    yi = torch.as_tensor(_nearest_indices(h, out_h), device=images.device)
    xi = torch.as_tensor(_nearest_indices(w, out_w), device=images.device)
    return images.index_select(-2, yi).index_select(-1, xi)
