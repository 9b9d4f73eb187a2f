"""Evaluate tracked poses against ground truth.

    python -m dynhor_tpu_torch.tools.eval_poses --exp exps/custom_shoes/pred \
        --gt data/custom_shoes/gt_poses.npz

Twin of ``tools/eval_poses.py``: the same arguments and print lines.  Per
frame, the rotation error (geodesic degrees, ``utils/geometry.
rotation_angle_difference`` in f32) and the translation error (Euclidean),
then the means and medians.  GT schema: ``gt_poses.npz`` with R (F, 3, 3,
object-to-camera, column convention) and T (F, 3), as the demo-data tools
write it.  Host arithmetic on a dozen matrices: it runs on the CPU, as the
JAX tool pins its own to the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..utils.geometry import rotation_angle_difference


def evaluate(exp_dir: str, gt_path: str) -> dict:
    """Errors of ``<exp_dir>/obj_infos/*.npz`` against ``gt_path``, frame i
    of the sorted files against GT row i: {"frames": names, "rot_deg": (F,),
    "trans": (F,), "rot_mean", "rot_median", "trans_mean", "trans_median"}."""
    gt = np.load(gt_path)
    npzs = sorted(glob.glob(os.path.join(exp_dir, "obj_infos", "*.npz")))
    if not npzs:
        raise SystemExit(f"no poses under {exp_dir}/obj_infos")
    rot_errs, t_errs = [], []
    for i, path in enumerate(npzs):
        d = np.load(path)
        ang = rotation_angle_difference(
            torch.as_tensor(d["R"])[None], torch.as_tensor(gt["R"][i])[None]
        )
        rot_errs.append(float(ang[0]))
        t_errs.append(float(np.linalg.norm(d["T"].reshape(3) - gt["T"][i])))
    rot, trans = np.asarray(rot_errs), np.asarray(t_errs)
    return {
        "frames": [os.path.basename(p)[:-4] for p in npzs],
        "rot_deg": rot, "trans": trans,
        "rot_mean": float(rot.mean()), "rot_median": float(np.median(rot)),
        "trans_mean": float(trans.mean()), "trans_median": float(np.median(trans)),
    }


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", required=True, help="exps/<seq>/<exp> directory")
    parser.add_argument("--gt", required=True, help="gt_poses.npz")
    args = parser.parse_args(argv)
    r = evaluate(args.exp, args.gt)
    for name, ang, terr in zip(r["frames"], r["rot_deg"], r["trans"]):
        print(f"{name}: rot {ang:6.2f} deg  trans {terr:.4f}")
    print(
        f"\nsummary over {len(r['rot_deg'])} frames: "
        f"rot mean {r['rot_mean']:.2f} / median {r['rot_median']:.2f} deg; "
        f"trans mean {r['trans_mean']:.4f} / median {r['trans_median']:.4f}"
    )
    return r


if __name__ == "__main__":
    main()
