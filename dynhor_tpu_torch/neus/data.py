"""Dense correspondences of a sequence (host side).

Port of ``CorrData`` (``dynhor_tpu/neus/trainer.py``) and
``load_correspondences`` (``dynhor_tpu/neus/data.py``); the rest of the
reconstruction stage is not ported yet (ROADMAP queue 1).

Data convention (README.md:27-44):
  <seq>/correspondence_infos/   DKM dense correspondences (optional):
                                pairs_*.npz with {frame_i, frame_j,
                                xy_i (M,2), xy_j (M,2)}; a frame is named by
                                its id or by its index into the sorted rgb
                                list, coordinates are pixels.
"""
from __future__ import annotations

import glob as globlib
import os
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class CorrData(NamedTuple):
    """Dense correspondences (DKM convention: pixel matches between frames)."""

    frame_i: Tensor  # (M,) int32
    frame_j: Tensor  # (M,) int32
    xy_i: Tensor  # (M, 2) pixel coords in frame_i
    xy_j: Tensor  # (M, 2) pixel coords in frame_j


def load_correspondences(
    dataroot: str, frame_ids: list[str], downscale: int = 1
) -> CorrData | None:
    """All pairs under ``<dataroot>/correspondence_infos`` as CPU tensors,
    or None when the directory or every pair is missing.  Pairs naming an
    unknown frame are skipped."""
    corr_dir = os.path.join(dataroot, "correspondence_infos")
    if not os.path.isdir(corr_dir):
        return None
    id_to_idx = {fid: i for i, fid in enumerate(frame_ids)}

    def resolve(v) -> int | None:
        """Frame reference -> index: a frame-id string or an integer index
        into the sorted rgb list."""
        raw = v.item() if getattr(v, "ndim", 1) == 0 else v
        if isinstance(raw, (int,)) or (
            isinstance(raw, str) and raw.isdigit() and raw not in id_to_idx
        ):
            idx = int(raw)
            return idx if 0 <= idx < len(frame_ids) else None
        return id_to_idx.get(str(raw))

    fi, fj, xi, xj = [], [], [], []
    for path in sorted(globlib.glob(os.path.join(corr_dir, "*.npz"))):
        d = np.load(path, allow_pickle=True)
        ai = resolve(d["frame_i"])
        bi = resolve(d["frame_j"])
        if ai is None or bi is None:
            continue
        m = d["xy_i"].shape[0]
        fi.append(np.full((m,), ai, np.int32))
        fj.append(np.full((m,), bi, np.int32))
        xi.append(d["xy_i"].astype(np.float32) / downscale)
        xj.append(d["xy_j"].astype(np.float32) / downscale)
    if not fi:
        return None
    return CorrData(*(
        torch.from_numpy(np.concatenate(x)) for x in (fi, fj, xi, xj)
    ))
