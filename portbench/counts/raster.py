"""Operations and bytes of the raster kernels (K1, K2, K3), from a scene's
real face-tile bins.

Floating-point operations per (pixel, slot) pair that the function needs:
an FMA counts as 2; add, sub, mul, div, min/max, compare, select, sqrt,
exp, log1p each as 1.  Terms of the face alone (area, its guards, edge
vectors, segment denominators, visibility) are left out: they could be
computed once per slot.  Shared geometry 71 (three barycentrics 3 x 6,
inside test 5, sign 1, three point-segment distances 3 x 15, their min 2);
K1 adds 19 (logit 4, softplus and its sum 6, depth 5, depth test 4); K2
adds 29 (logit 4, dfac 4, sigmoid 3, coefficient 3, segment choice 2,
endpoint sums 13).  K3 does 23 per pair of a visible face (barycentrics
18, inside test 5) and 9 more where the pixel lies inside it (depth 5,
depth test 4).

Bytes count each input read once and each output written once: a pair's
16-float face record (K1, K2) or its face id (K3, which reads the records
once per face), a count per tile, and per pixel of a tile with work the
outputs (K1: mass, depth, slot; K3: depth, slot) or the incoming gradient
(K2), and K2's six-float gradient per pair.  Only tiles with at least one
face count: the kernels' work lists skip the rest.
"""
from __future__ import annotations

import torch

from ..reference import raster as RR

OPS_PER_PAIR = {"K1": 90, "K2": 100, "K3": 23}
K3_OPS_INSIDE = 9
TILE = 16
PEAK_F32 = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet, 700 W)
PEAK_BF16 = 989e12  # dense bf16 tensor cores
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(ops: float, nbytes: float, peak: float = PEAK_F32) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak, nbytes / PEAK_BYTES)


def k1k2(loads: torch.Tensor) -> dict:
    """{"K1": (ops, bytes), "K2": (ops, bytes)} of one fused raster's
    forward and backward; ``loads`` (B, T) faces per tile at the margin."""
    pairs = int(loads.sum())
    tiles = int((loads > 0).sum())
    pix = TILE * TILE
    n_pix = pairs * pix
    read = pairs * 64 + tiles * 4
    return {"K1": (n_pix * OPS_PER_PAIR["K1"], read + tiles * pix * 12),
            "K2": (n_pix * OPS_PER_PAIR["K2"], read + tiles * pix * 4 + pairs * 24)}


def inside_pairs(vp: torch.Tensor, faces: torch.Tensor, grid_hw: tuple[int, int]) -> int:
    """(pixel, face) pairs whose pixel centre lies inside the face, over
    the tile grid ``grid_hw``, for faces with a corner past ``znear``."""
    fv = RR.face_corners(vp, faces).detach()
    jx0, cx, jy0, cy = RR.cover_windows(fv, grid_hw)
    b, n = fv.shape[:2]
    total = 0
    nx = max(int(cx.max()), 1)
    ny = max(int(cy.max()), 1)
    step = max(1, (1 << 24) // max(b * nx * ny, 1))
    for s in range(0, n, step):
        sl = slice(s, s + step)
        _, _, ox, oy, live = RR._windows(jx0[:, sl], cx[:, sl], jy0[:, sl], cy[:, sl])
        px = (jx0[:, sl, None] + ox).float() + 0.5
        py = (jy0[:, sl, None] + oy).float() + 0.5
        c = fv[:, sl, :, None, :]
        (w0, w1, w2), nondegen = RR.barycentrics(
            c[:, :, 0, :, 0], c[:, :, 0, :, 1], c[:, :, 1, :, 0], c[:, :, 1, :, 1],
            c[:, :, 2, :, 0], c[:, :, 2, :, 1], px, py)
        total += int((live & (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & nondegen).sum())
    return total


def k3(loads: torch.Tensor, inside: int, n_faces: int) -> tuple[float, float]:
    """(ops, bytes) of one depth raster of B views; ``loads`` (B, T) faces
    per tile at margin 0, ``inside`` the inside pairs."""
    b = loads.shape[0]
    pairs = int(loads.sum())
    tiles = int((loads > 0).sum())
    pix = TILE * TILE
    ops = pairs * pix * OPS_PER_PAIR["K3"] + inside * K3_OPS_INSIDE
    nbytes = b * n_faces * 64 + pairs * 4 + tiles * 4 + tiles * pix * 8
    return ops, nbytes
