"""DKM-correspondence outlier voting on pose trajectories (PyTorch).

Port of ``dynhor_tpu/tracker/outliers.py``.  The reference README ships DKM
dense correspondences "for reconstruction and outlier-voting"
(README.md:43); the voting code itself is unreleased, so this is designed
from the stated purpose:

  1. For every correspondence pair (i, j): lift the matched pixels of
     frame i to 3D through the posed mesh's rendered depth, reproject them
     into frame j with frame j's pose, and score the pair by the MEDIAN
     reprojection error against the matched pixels.
  2. Voting: a frame's score is the MIN of its pair errors; frames whose
     score exceeds ``threshold_px`` are outliers (a bad frame corrupts all
     its pairs, a good neighbour of a bad frame keeps one clean pair).
  3. Repair: outlier poses are replaced by SLERP / linear interpolation
     between the nearest inlier neighbours (the pipeline may then re-run a
     short joint optimization).

The depths are full-image z-buffers from ``rasterize_tiled`` (stock
PyTorch, as the JAX package renders them with XLA), one frame at a time so
that the tile pass's temporaries stay those of one frame; the voting is
host numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..neus.data import CorrData
from ..ops import rasterize as rz
from ..ops.rasterize_tiled import rasterize_tiled
from ..utils import geometry as G
from ..utils.device import resolve_device

Tensor = torch.Tensor


@torch.no_grad()
def _frame_depths(
    verts: Tensor, faces: Tensor, R_rows: Tensor, Ts: Tensor, K: Tensor,
    image_hw: tuple[int, int], max_faces: int = 2048,
) -> Tensor:
    """Rendered z-buffers of all frames (F, H, W); -1 where no surface."""
    out = []
    for R, t in zip(R_rows, Ts):
        vp = rz.project_perspective((verts @ R + t)[None], K)
        out.append(rasterize_tiled(vp, faces, image_hw, max_faces=max_faces).zbuf[0])
    return torch.stack(out)


def _pair_errors(
    depths: Tensor, R_rows: Tensor, Ts: Tensor, K: Tensor, corr: CorrData
) -> tuple[Tensor, Tensor]:
    """Per-match reprojection error (M,) and validity (M,) (a surface hit)."""
    fi, fj = corr.frame_i.long(), corr.frame_j.long()
    xy_i = corr.xy_i
    xi = xy_i[:, 0].to(torch.int32).clamp(0, depths.shape[2] - 1).long()
    yi = xy_i[:, 1].to(torch.int32).clamp(0, depths.shape[1] - 1).long()
    z = depths[fi, yi, xi]
    valid = z > 0
    # Backproject the pixel (frame i, camera space), lift to object space.
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x_cam = (xy_i[:, 0] - cx) / fx * z
    y_cam = (xy_i[:, 1] - cy) / fy * z
    p_cam_i = torch.stack([x_cam, y_cam, z], dim=-1)
    p_obj = torch.einsum("nj,nkj->nk", p_cam_i - Ts[fi], R_rows[fi])  # R^T = inverse
    # Project into frame j.
    p_cam_j = torch.einsum("nj,njk->nk", p_obj, R_rows[fj]) + Ts[fj]
    u = fx * p_cam_j[:, 0] / p_cam_j[:, 2].clamp_min(1e-6) + cx
    v = fy * p_cam_j[:, 1] / p_cam_j[:, 2].clamp_min(1e-6) + cy
    err = torch.linalg.norm(torch.stack([u, v], -1) - corr.xy_j, dim=-1)
    return err, valid


class OutlierReport(NamedTuple):
    frame_scores: np.ndarray  # (F,) min-of-pairs reprojection error (px)
    outliers: np.ndarray  # (F,) bool
    pair_errors: dict  # (i, j) -> median error over the pair's matches


def vote_outliers(
    verts,
    faces,
    R_rows,
    Ts,
    K,
    corr: CorrData,
    image_hw: tuple[int, int],
    threshold_px: float = 8.0,
    device: str | torch.device | None = None,
) -> OutlierReport:
    """Score every frame by correspondence reprojection consistency.

    Args: tensors or arrays on any device, moved to ``device`` (None = the
    CUDA card, raising without one; "cpu" runs on the CPU).
    """
    dev = resolve_device(device)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    R_rows, Ts, K = put(R_rows), put(Ts), put(K)
    f_frames = R_rows.shape[0]
    depths = _frame_depths(put(verts), put(faces, torch.int64), R_rows, Ts, K, image_hw)
    corr_d = CorrData(*(put(x, x.dtype) for x in corr))
    err, valid = _pair_errors(depths, R_rows, Ts, K, corr_d)
    err = err.cpu().numpy()
    valid = valid.cpu().numpy()
    fi = corr.frame_i.cpu().numpy()
    fj = corr.frame_j.cpu().numpy()

    pair_errors: dict = {}
    votes: dict[int, list[float]] = {i: [] for i in range(f_frames)}
    for (a, b) in {(int(x), int(y)) for x, y in zip(fi, fj)}:
        sel = (fi == a) & (fj == b) & valid
        if sel.sum() < 4:
            continue
        med = float(np.median(err[sel]))
        pair_errors[(a, b)] = med
        votes[a].append(med)
        votes[b].append(med)

    scores = np.full(f_frames, np.nan)
    for i, v in votes.items():
        if v:
            scores[i] = float(np.min(v))
    outliers = np.zeros(f_frames, bool)
    known = ~np.isnan(scores)
    outliers[known] = scores[known] > threshold_px
    return OutlierReport(scores, outliers, pair_errors)


def interpolate_poses(
    R_rows: np.ndarray, Ts: np.ndarray, outliers: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Replace outlier poses by SLERP / linear interpolation between the
    nearest inlier neighbours (endpoint outliers copy the nearest inlier).
    Host numpy, the quaternions in f32 torch on the CPU."""
    inlier_idx = np.nonzero(~outliers)[0]
    if len(inlier_idx) == 0 or not outliers.any():
        return np.asarray(R_rows).copy(), np.asarray(Ts).copy()
    quats = G.matrix_to_quaternion(torch.as_tensor(np.asarray(R_rows, np.float32)))
    R_out = np.asarray(R_rows).copy()
    T_out = np.asarray(Ts).copy()
    for i in np.nonzero(outliers)[0]:
        before = inlier_idx[inlier_idx < i]
        after = inlier_idx[inlier_idx > i]
        if len(before) and len(after):
            a, b = int(before[-1]), int(after[0])
            t = (i - a) / (b - a)
            q = G.quaternion_slerp(quats[a], quats[b], torch.tensor(t, dtype=torch.float32))
            R_out[i] = G.quaternion_to_matrix(q).numpy()
            T_out[i] = (1 - t) * Ts[a] + t * Ts[b]
        else:
            src = int(before[-1]) if len(before) else int(after[0])
            R_out[i] = R_rows[src]
            T_out[i] = Ts[src]
    return R_out, T_out
