"""Experiment artifacts: npz pose export, TensorBoard scalars, config copy.

Output contract matches the reference exactly (SURVEY.md §3.4/§5):
``exps/<seq>/<exp>/{obj_infos/<frame>.npz, board/, config.yaml,
render_res/}`` with npz keys {R (o2c column convention), T, K}
(run.py:165-179); vis resumes from those files (vis.py:41-55).

A copy of ``dynhor_tpu/io/artifacts.py``, numpy only: the files are
byte-compatible with the JAX package's.  ``Board`` writes through
tensorboardX, or through ``torch.utils.tensorboard`` where tensorboardX is
missing.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Iterable

import numpy as np


def save_pose_npzs(
    exp_dir: str,
    frame_ids: Iterable[str],
    rotations_row: np.ndarray,
    translations: np.ndarray,
    K: np.ndarray,
    obj_scale: float | None = None,
) -> None:
    """Per-frame {R, T, K} npz (run.py:165-179).

    Args:
      rotations_row: (F, 3, 3) ROW-convention rotations (verts @ R + T);
        saved transposed to the object->camera column convention
        (run.py:166 quirk preserved).
      translations: (F, 3) or (F, 1, 3).
      K: (3, 3) full-image intrinsics.
    """
    out = os.path.join(exp_dir, "obj_infos")
    os.makedirs(out, exist_ok=True)
    translations = np.asarray(translations).reshape(len(rotations_row), -1)[:, :3]
    for i, fid in enumerate(frame_ids):
        data = {
            "R": np.asarray(rotations_row[i]).T.astype(np.float32),
            "T": translations[i].astype(np.float32),
            "K": np.asarray(K, np.float32),
        }
        if obj_scale is not None:
            data["obj_scale"] = np.float32(obj_scale)
        np.savez(os.path.join(out, f"{fid}.npz"), **data)


def load_pose_npz(exp_dir: str, frame_id: str) -> dict[str, np.ndarray] | None:
    path = os.path.join(exp_dir, "obj_infos", f"{frame_id}.npz")
    if not os.path.exists(path):
        return None
    return dict(np.load(path))


def copy_config(exp_dir: str, config_path: str) -> None:
    os.makedirs(exp_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(exp_dir, "config.yaml"))


class Board:
    """TensorBoard scalar writer (run.py:127, jointopt.py:151-155):
    tensorboardX, else ``torch.utils.tensorboard``.

    Degrades to a no-op if neither is available.
    """

    def __init__(self, exp_dir: str):
        self._writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return
        self._writer = SummaryWriter(os.path.join(exp_dir, "board"))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def add_history(self, history: dict[str, Any]) -> None:
        """Write per-step arrays (the jointopt history) as scalar curves."""
        for tag, values in history.items():
            arr = np.asarray(values)
            for step, v in enumerate(arr):
                self.add_scalar(tag, float(v), step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
