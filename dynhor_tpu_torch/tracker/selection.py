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
"""
from __future__ import annotations

from typing import NamedTuple

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
