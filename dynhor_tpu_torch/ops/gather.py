"""Gathers and a scatter-add along one axis of a 2-D table (K6).

The port's counterpart of the gathers that ``tools/probe_pallas_gather.py``
probes on the TPU: ``take_along_axis`` (out[i, l] = src[idx[i, l], l] along
axis 0, src[i, idx[i, l]] along axis 1) and ``scatter_add_axis0``
(dst[idx[i, l], l] += g[i, l]).  The index may be an expanded view (a zero
stride), so a row gather by one index per row is the same call as a
per-lane gather.  On the card both run the kernels of csrc/gather_probe.cu;
the plain versions here take CPU tensors.  Indices must lie in range.
"""
from __future__ import annotations

import torch

from .. import kernels

Tensor = torch.Tensor


def take_along_axis_plain(src: Tensor, idx: Tensor, axis: int) -> Tensor:
    """Plain version of the K6 gather: ``torch.gather`` on the index."""
    return torch.gather(src, axis, idx.long())


def scatter_add_axis0_plain(g: Tensor, idx: Tensor, n_rows: int) -> Tensor:
    """Plain version of the K6 scatter-add: ``scatter_add_`` on the index."""
    dst = torch.zeros((n_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    return dst.scatter_add_(0, idx.long(), g)


def take_along_axis(src: Tensor, idx: Tensor, axis: int) -> Tensor:
    """K6 gather: the plain version on the CPU, the CUDA kernel otherwise."""
    if src.device.type == "cpu":
        return take_along_axis_plain(src, idx, axis)
    return kernels.take_along_axis(src, idx, axis)


def scatter_add_axis0(g: Tensor, idx: Tensor, n_rows: int) -> Tensor:
    """K6 scatter-add: the plain version on the CPU, the CUDA kernel
    otherwise."""
    if g.device.type == "cpu":
        return scatter_add_axis0_plain(g, idx, n_rows)
    return kernels.scatter_add_axis0(g, idx, n_rows)
