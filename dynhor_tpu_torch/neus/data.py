"""Reconstruction-stage data loading (host side).

Port of ``dynhor_tpu/neus/data.py`` and of the ``ReconData`` / ``CorrData``
tuples of ``dynhor_tpu/neus/trainer.py``.  The tensors stay on the CPU;
the trainer places them on its device.

Data convention (README.md:27-44):
  <seq>/rgb/*.png|jpg           target images
  <seq>/sam_seg/*.png           SAM-v2 masks (G channel = object)
  <seq>/monocular_normal/*.png  StableNormal camera-space normals,
                                encoded (n + 1) / 2 in RGB (optional)
  <seq>/correspondence_infos/   DKM dense correspondences (optional):
                                pairs_*.npz with {frame_i, frame_j,
                                xy_i (M,2), xy_j (M,2)}; a frame is named by
                                its id or by its index into the sorted rgb
                                list, coordinates are pixels.

Poses come from the stage-1 npz artifacts (exps/<seq>/<exp>/obj_infos/:
R is object->camera COLUMN convention).
"""
from __future__ import annotations

import glob as globlib
import os
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class ReconData(NamedTuple):
    """Stacked per-frame supervision."""

    images: Tensor  # (F, H, W, 3) float32 [0,1]
    masks: Tensor  # (F, H, W) float32 {0,1} object masks
    normals: Tensor | None  # (F, H, W, 3) camera-space unit normals or None
    R_rows: Tensor  # (F, 3, 3) object->camera row-convention rotations
    Ts: Tensor  # (F, 3)
    K: Tensor  # (3, 3)

    def to(self, device) -> ReconData:
        return ReconData(*(None if x is None else x.to(device) for x in self))


class CorrData(NamedTuple):
    """Dense correspondences (DKM convention: pixel matches between frames)."""

    frame_i: Tensor  # (M,) int32
    frame_j: Tensor  # (M,) int32
    xy_i: Tensor  # (M, 2) pixel coords in frame_i
    xy_j: Tensor  # (M, 2) pixel coords in frame_j

    def to(self, device) -> CorrData:
        return CorrData(*(x.to(device) for x in self))


def _frame_paths(dataroot: str) -> list[str]:
    paths = sorted(globlib.glob(os.path.join(dataroot, "rgb", "*.jpg")))
    if not paths:
        paths = sorted(globlib.glob(os.path.join(dataroot, "rgb", "*.png")))
    if not paths:
        raise FileNotFoundError(f"no rgb frames under {dataroot}/rgb")
    return paths


def load_recon_data(
    dataroot: str, poses_dir: str, downscale: int = 1
) -> tuple[ReconData, list[str]]:
    """Supervision + stage-1 poses as CPU tensors.

    Args:
      poses_dir: directory of per-frame npz files ({R, T, K}); frames with
        no pose file are skipped.
      downscale: integer image downscale factor (intrinsics rescaled).

    Returns (ReconData, frame_ids).
    """
    from PIL import Image

    images, masks, normals, Rs, Ts = [], [], [], [], []
    frame_ids = []
    K = None
    have_normals = os.path.isdir(os.path.join(dataroot, "monocular_normal"))
    for p in _frame_paths(dataroot):
        fid = os.path.basename(p)[:-4]
        pose_path = os.path.join(poses_dir, fid + ".npz")
        if not os.path.exists(pose_path):
            continue
        pose = np.load(pose_path)
        img = Image.open(p).convert("RGB")
        if downscale > 1:
            img = img.resize((img.width // downscale, img.height // downscale), Image.BILINEAR)
        images.append(np.asarray(img, np.float32) / 255.0)
        seg = np.asarray(
            Image.open(os.path.join(dataroot, "sam_seg", fid + ".png")).resize(
                img.size, Image.NEAREST
            )
        )
        masks.append((seg[:, :, 1] == 255).astype(np.float32))
        if have_normals:
            npath = os.path.join(dataroot, "monocular_normal", fid + ".png")
            nimg = Image.open(npath).resize(img.size, Image.BILINEAR)
            normals.append(np.asarray(nimg, np.float32)[:, :, :3] / 255.0 * 2.0 - 1.0)
        # npz R is object->camera COLUMN convention; row convention = R^T.
        Rs.append(pose["R"].T.astype(np.float32))
        Ts.append(pose["T"].astype(np.float32).reshape(3))
        if K is None:
            K = pose["K"].astype(np.float32)
            if downscale > 1:
                K = K.copy()
                K[:2] /= downscale
        frame_ids.append(fid)
    if not frame_ids:
        raise FileNotFoundError(f"no poses found under {poses_dir}")
    data = ReconData(
        images=torch.from_numpy(np.stack(images)),
        masks=torch.from_numpy(np.stack(masks)),
        normals=torch.from_numpy(np.stack(normals)) if normals else None,
        R_rows=torch.from_numpy(np.stack(Rs)),
        Ts=torch.from_numpy(np.stack(Ts)),
        K=torch.from_numpy(K),
    )
    return data, frame_ids


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
