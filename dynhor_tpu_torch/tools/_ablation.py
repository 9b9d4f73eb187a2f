"""Inputs and pose errors shared by the port's ablation tools: the
sequence, its annotations, the mesh and the ViT as each JAX ablation tool
loads them, and rotation errors against a synthetic sequence's GT."""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..models import dino as dino_mod
from ..tracker import pipeline as PL
from ..utils import geometry as G


def load_inputs(cfg: dict):
    """(seq, ann, mesh) of a loaded config."""
    sysc = cfg["system"]
    seq = PL.load_sequence(cfg["data_info"]["dataroot"])
    ann = PL.process_frames(seq, int(sysc["crop_size"]), float(sysc["bbox_expansion"]))
    mesh = PL.load_mesh(cfg["data_info"]["obj_path"], bool(cfg["data_info"]["normalize_mesh"]))
    return seq, ann, mesh


def load_vit(cfg: dict, edge: int | None = None):
    """(params, DinoConfig) from ``system.dino``: its checkpoint or, with
    none, the seeded random init; ``edge`` overrides the input edge."""
    dino = cfg["system"]["dino"]
    return dino_mod.load_params(
        dino.get("checkpoint"),
        dino_mod.config_for_model(
            dino.get("model", "dinov2_vitb14"),
            smaller_edge_size=int(edge or dino["smaller_edge_size"]),
        ),
    )


def gt_path_or_exit(cfg: dict, what: str) -> str:
    path = os.path.join(cfg["data_info"]["dataroot"], "gt_poses.npz")
    if not os.path.exists(path):
        sys.exit(f"no {path} — {what} needs synthetic GT")
    return path


def gt_rows(gt_path: str) -> np.ndarray:
    """(F, 3, 3) GT rotations in the row convention."""
    return np.swapaxes(np.load(gt_path)["R"], -1, -2)


def rot_errors(rotations_row, gt_row) -> np.ndarray:
    """Per-frame geodesic degrees between two row-convention rotation sets."""
    return G.rotation_angle_difference(
        torch.as_tensor(np.asarray(rotations_row, np.float32)),
        torch.as_tensor(np.asarray(gt_row, np.float32)),
    ).numpy()
