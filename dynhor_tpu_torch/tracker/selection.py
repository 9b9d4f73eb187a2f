"""Prior-view selection with temporal gating (PyTorch).

Port of ``dynhor_tpu/tracker/selection.py`` (``gate_frame``,
``gate_all_frames``).  Behavioral reference: ObjTracker/
pose_initializtion.py:285-321: per frame, the prior view with the best
masked DINO cosine, gated so that the selection does not jump far from the
previous frame:

  * the top-5 candidates if the previous frame selected a prior (top-10
    after a rejection); pick the one closest in angle to the previous
    rotation;
  * reject it (keep the previous rotation) if it is > 85 deg from the
    previous rotation or from the previously selected prior;
  * after a rejection, re-accept the closest prior if it is < 15 deg away,
    unless it is > 30 deg from the previously selected prior or its score
    is below max(score) - std(score).

``gate_all_frames`` threads the SELECTED rotation from frame to frame (the
parallel pipeline's mode).  The scan is a Python loop over frames on device
tensors: every decision is a tensor select, so the loop never reads the
device.  Ties follow the reference: the top-k is a stable descending sort
(lower index first on equal scores, as ``jax.lax.top_k``), and argmax /
argmin take the first index.

``build_hypotheses`` (multi-hypothesis init, ``num_initializations > 1``)
builds each frame's K rotation inits in numpy on the host, operation for
operation as the JAX package does: the gate pick, its two 180-degree
flips, then prior views by silhouette IoU (diverse first, then relaxed) or
by farthest-point sampling.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.geometry import rotation_angle_difference

Tensor = torch.Tensor


class GateState(NamedTuple):
    prev_rotation: Tensor  # (3, 3) row-convention previous rotation
    former_idx: Tensor  # () int64: previously selected prior, -1 if rejected
    has_prev: Tensor  # () bool: False only before the first frame


class GateResult(NamedTuple):
    rotation_init: Tensor  # (3, 3) row-convention init of the refine
    selected_idx: Tensor  # () int64 (-1 = fell back to the previous rotation)


def initial_state(device=None) -> GateState:
    return GateState(
        torch.eye(3, device=device),
        torch.tensor(-1, device=device),
        torch.tensor(False, device=device),
    )


def gate_frame(
    state: GateState, scores: Tensor, priors_row: Tensor
) -> tuple[GateState, GateResult]:
    """One gating step (pose_initializtion.py:298-321).

    Args:
      scores: (N,) masked DINO cosine of this frame against all prior views.
      priors_row: (N, 3, 3) row-convention prior rotations.

    Returns (state with former_idx and prev_rotation set to the SELECTED
    rotation, GateResult).
    """
    n = scores.shape[0]
    argmax_idx = torch.argmax(scores)

    rel = rotation_angle_difference(state.prev_rotation[None], priors_row)  # (N,)
    former_valid = state.former_idx >= 0
    former_rot = priors_row[state.former_idx.clamp_min(0)]
    former_rel = torch.where(
        former_valid, rotation_angle_difference(former_rot[None], priors_row), 0.0
    )
    topk_num = torch.where(former_valid, 5, 10)

    k_max = min(10, n)
    top_idx = torch.sort(scores, descending=True, stable=True).indices[:k_max]
    pos = torch.arange(k_max, device=scores.device)
    cand_rel = torch.where(pos < topk_num, rel[top_idx], torch.inf)
    sel = top_idx[torch.argmin(cand_rel)]
    rejected = (rel[sel] > 85.0) | (former_rel[sel] > 85.0)
    sel = torch.where(rejected, -1, sel)

    # Fallback re-acceptance: it sets only the NEXT frame's former_idx; the
    # rotation init stays the previous rotation.
    m = torch.argmin(rel)
    score_gate = scores[m] < (scores.max() - torch.std(scores, correction=1))
    re_rejected = (former_valid & (former_rel[m] > 30.0)) | score_gate
    fallback_idx = torch.where(rel.min() < 15.0, torch.where(re_rejected, -1, m), -1)

    gated_idx = torch.where(sel >= 0, sel, fallback_idx)
    gated_rot = torch.where(sel >= 0, priors_row[sel.clamp_min(0)], state.prev_rotation)

    idx = torch.where(state.has_prev, gated_idx, argmax_idx)
    rot_init = torch.where(state.has_prev, gated_rot, priors_row[argmax_idx])
    new_state = GateState(rot_init, idx, torch.ones_like(state.has_prev))
    return new_state, GateResult(rot_init, idx)


def gate_all_frames(scores: Tensor, priors_row: Tensor) -> GateResult:
    """The gating scan over all frames (parallel pipeline mode).

    Args:
      scores: (F, N).
      priors_row: (N, 3, 3).

    Returns GateResult with a leading frame axis, on the scores' device.
    """
    priors_row = priors_row.to(device=scores.device, dtype=torch.float32)
    state = initial_state(scores.device)
    rots, idxs = [], []
    for s in scores:
        state, res = gate_frame(state, s, priors_row)
        rots.append(res.rotation_init)
        idxs.append(res.selected_idx)
    return GateResult(torch.stack(rots), torch.stack(idxs))


# ---------------------------------------------------------------------------
# Multi-hypothesis initialization (num_initializations > 1)
# ---------------------------------------------------------------------------

class Hypotheses(NamedTuple):
    rotations: Tensor  # (F, K, 3, 3) row-convention rotation inits
    # (F, K) int32 provenance: prior-view index; -1 = a 180-degree flip of
    # the gate pick; -2 = the gate's fallback (no prior selected).
    indices: Tensor


# 180-degree camera-frame rotations about X and Y: in the row convention
# (verts @ R) a camera-frame rotation M composes as R @ M (both are
# symmetric diag(+-1)).  The silhouette-preserving ambiguities of flat-ish
# objects.
_FLIP_X = np.diag(np.array([1.0, -1.0, -1.0], np.float32))
_FLIP_Y = np.diag(np.array([-1.0, 1.0, -1.0], np.float32))


def _pairwise_angle_deg(R: np.ndarray, chosen: np.ndarray) -> np.ndarray:
    """(N,) least geodesic angle (deg) of each rotation in R to any chosen."""
    tr = np.einsum("nab,mab->nm", R, chosen)  # trace(R_i @ C_j^T), (N, M)
    cos = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos)).min(axis=1)


def build_hypotheses(
    rotation_init,
    selected_idx,
    priors_row,
    k: int,
    sil_scores=None,
    include_flips: bool = True,
    min_angle_deg: float = 30.0,
) -> Hypotheses:
    """Per-frame rotation hypotheses for the multi-init refine.

    Slots per frame:
      0        the gated pick;
      1, 2     its 180-degree camera-frame flips about X, then Y, when
               ``include_flips``;
      rest     greedy silhouette-IoU retrieval over ``sil_scores``,
               skipping views within ``min_angle_deg`` of a chosen
               hypothesis, relaxed to the best remaining if that pool runs
               dry; without sil scores, farthest-point sampling over the
               prior views.

    Args:
      rotation_init: (F, 3, 3) gate picks (``gate_all_frames``).
      selected_idx: (F,) gate indices (-1 = fallback).
      priors_row: (N, 3, 3) row-convention prior rotations.
      sil_scores: optional (F, N) silhouette-IoU matrix.
      (Tensors on any device, or arrays.)

    Returns Hypotheses of CPU tensors.
    """
    R0 = torch.as_tensor(rotation_init).cpu().numpy().astype(np.float32)  # (F, 3, 3)
    sel = torch.as_tensor(selected_idx).cpu().numpy().astype(np.int32)
    priors = torch.as_tensor(priors_row).cpu().numpy().astype(np.float32)
    sil = None if sil_scores is None else torch.as_tensor(sil_scores).cpu().numpy()
    f_frames = R0.shape[0]
    n = priors.shape[0]
    k = max(1, min(k, n + 3))

    rots = np.zeros((f_frames, k, 3, 3), np.float32)
    idxs = np.full((f_frames, k), -1, np.int32)
    for f in range(f_frames):
        chosen = [R0[f]]
        ids = [int(sel[f]) if sel[f] >= 0 else -2]
        if include_flips and len(chosen) < k:
            chosen.append(R0[f] @ _FLIP_X)
            ids.append(-1)
        if include_flips and len(chosen) < k:
            chosen.append(R0[f] @ _FLIP_Y)
            ids.append(-1)
        if len(chosen) < k:
            stack = np.stack(chosen)
            if sil is not None:
                order = np.argsort(-sil[f])
                # The diverse pass, then the relaxed fill.
                for relax in (False, True):
                    for v in order:
                        if len(chosen) >= k:
                            break
                        if v in ids:
                            continue
                        ang = _pairwise_angle_deg(priors[v : v + 1], stack)[0]
                        if relax or ang >= min_angle_deg:
                            chosen.append(priors[v])
                            ids.append(int(v))
                            stack = np.stack(chosen)
                    if len(chosen) >= k:
                        break
            else:
                while len(chosen) < k:
                    ang = _pairwise_angle_deg(priors, stack)
                    v = int(np.argmax(ang))
                    chosen.append(priors[v])
                    ids.append(v)
                    stack = np.stack(chosen)
        rots[f] = np.stack(chosen[:k])
        idxs[f] = np.asarray(ids[:k], np.int32)
    return Hypotheses(torch.as_tensor(rots), torch.as_tensor(idxs))
