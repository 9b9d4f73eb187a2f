"""Oracle-init ablation: DINO-gated view selection against the GT-nearest
prior view.

Twin of ``tools/ablate_oracle_init.py``: the same arguments, arms and print
lines.  On a synthetic sequence the GT pose is known, so refine + joint run
twice, from (a) the DINO gate's init and (b) the prior view geodesically
nearest to the GT rotation (``system.oracle_init``, tracker/pipeline.py).
If (b) recovers ~0.95+ IoU, the view-selection miss explains the gap and
refine + joint are healthy; if not, they have a robustness fault
independent of the ViT.

    python -m dynhor_tpu_torch.tools.ablate_oracle_init \
        --config configs/custom_kettle.yaml [--init-iters 50] [--views 500]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np

from ..io.config import load_config
from ..tracker import pipeline as PL
from . import _ablation as A

ARMS = (("dino-gate", False), ("oracle-init", True))


def run(config: str, init_iters: int | None = None, joint_iters: int | None = None,
        views: int | None = None, device=None) -> dict:
    """Both arms; {arm: {"iou", "wall", "init_rot_err", "joint_rot_err",
    "result"}} (rotation errors in degrees per frame, ``result`` the
    pipeline's TrackResult), printing each arm's line as it ends."""
    cfg = load_config(config)
    sysc = cfg["system"]
    if init_iters is not None:
        sysc["init_num_iterations"] = init_iters
    if joint_iters is not None:
        sysc["joint_num_iterations"] = joint_iters
    if views is not None:
        sysc["prior"]["num_views"] = views
    gt_path = A.gt_path_or_exit(cfg, "the oracle ablation")
    gt_row = A.gt_rows(gt_path)
    seq, ann, mesh = A.load_inputs(cfg)
    dparams, dcfg = A.load_vit(cfg)
    results = {}
    for name, oracle in ARMS:
        c = copy.deepcopy(cfg)
        c["system"]["oracle_init"] = {"enabled": oracle, "gt_poses": gt_path}
        t0 = time.time()
        res = PL.track_sequence(c, seq, ann, mesh, dino_params=dparams, dino_cfg=dcfg,
                                device=device)
        dt = time.time() - t0
        iou = float(res.history["iou_object"][-1])
        init_err = A.rot_errors(res.init_rotations_row, gt_row)
        joint_err = A.rot_errors(res.rotations_row, gt_row)
        results[name] = dict(iou=iou, wall=dt, init_rot_err=init_err,
                             joint_rot_err=joint_err, result=res)
        print(
            f"[{name}] wall {dt:.1f}s  joint IoU {iou:.4f}  "
            f"rot err after refine: mean {np.mean(init_err):.1f} deg"
            f"  after joint: mean {np.mean(joint_err):.1f} deg",
            flush=True,
        )
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_shoes.yaml")
    ap.add_argument("--init-iters", type=int, default=None,
                    help="override system.init_num_iterations")
    ap.add_argument("--joint-iters", type=int, default=None)
    ap.add_argument("--views", type=int, default=None,
                    help="override system.prior.num_views")
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for the CPU")
    args = ap.parse_args(argv)
    results = run(args.config, args.init_iters, args.joint_iters, args.views, args.device)
    a, b = results["dino-gate"], results["oracle-init"]
    print("\n=== ablation summary (record in BASELINE.md) ===")
    print(f"config: {args.config}")
    print(f"joint IoU: dino-gate {a['iou']:.4f} -> oracle {b['iou']:.4f}")
    print(
        "per-frame joint rot err (deg): dino-gate "
        f"{np.round(a['joint_rot_err'], 1).tolist()}\n"
        "                              oracle    "
        f"{np.round(b['joint_rot_err'], 1).tolist()}"
    )
    if b["iou"] >= 0.9:
        print(
            "CONCLUSION: oracle init recovers — the gap is the view-selection"
            " miss (random-weight DINO); refine+joint are healthy."
        )
    else:
        print(
            "CONCLUSION: oracle init does NOT recover — refine/joint have a"
            " robustness issue on this sequence independent of DINO."
        )
    return results


if __name__ == "__main__":
    main()
