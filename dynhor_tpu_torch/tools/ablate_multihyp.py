"""Multi-hypothesis init ablation: the K=1 gate pick against
``num_initializations=K``.

Twin of ``tools/ablate_multihyp.py``: the same arguments, defaults, arms and
print lines.  Both arms run with matched configs (refine and joint steps,
prior views, tournament steps) and report the joint IoU, the rotation
errors against GT and the wall-clock cost.

    python -m dynhor_tpu_torch.tools.ablate_multihyp --config configs/custom_kettle.yaml \
        [--k 4] [--init-iters 50] [--joint-iters 100] [--views 500] \
        [--tournament 25] [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np

from ..io.config import load_config
from ..tracker import pipeline as PL
from . import _ablation as A


def run(config: str, k: int = 4, init_iters: int = 50, joint_iters: int = 100,
        views: int = 500, tournament: int = 25, propagate_rounds: int | None = None,
        smooth_weight: float | None = None, skip_k1: bool = False, device=None) -> dict:
    """{arm: {"iou", "wall", "init_rot_err", "joint_rot_err", "result"}},
    printing each arm's lines as it ends."""
    cfg = load_config(config)
    sysc = cfg["system"]
    sysc["init_num_iterations"] = init_iters
    sysc["joint_num_iterations"] = joint_iters
    sysc["prior"]["num_views"] = views
    gt_row = A.gt_rows(A.gt_path_or_exit(cfg, "the ablation"))
    seq, ann, mesh = A.load_inputs(cfg)
    dparams, dcfg = A.load_vit(cfg)
    arms = [("gate-K1", 1), (f"multihyp-K{k}", k)]
    if skip_k1:
        arms = arms[1:]
    results = {}
    for name, n in arms:
        c = copy.deepcopy(cfg)
        c["system"]["num_initializations"] = n
        c["system"]["hypotheses"]["tournament_iters"] = tournament
        if propagate_rounds is not None:
            c["system"]["hypotheses"]["propagate_rounds"] = propagate_rounds
        if smooth_weight is not None:
            c["system"]["hypotheses"]["smooth_weight"] = smooth_weight
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
        print(f"[{name}] per-frame joint rot err (deg): "
              f"{np.round(joint_err, 1).tolist()}", flush=True)
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_kettle.yaml")
    ap.add_argument("--k", type=int, default=4,
                    help="num_initializations for the multi-hyp arm")
    ap.add_argument("--init-iters", type=int, default=50)
    ap.add_argument("--joint-iters", type=int, default=100)
    ap.add_argument("--views", type=int, default=500)
    ap.add_argument("--tournament", type=int, default=25)
    ap.add_argument("--propagate-rounds", type=int, default=None,
                    help="override system.hypotheses.propagate_rounds")
    ap.add_argument("--smooth-weight", type=float, default=None,
                    help="override system.hypotheses.smooth_weight")
    ap.add_argument("--skip-k1", action="store_true",
                    help="run only the multi-hypothesis arm")
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for the CPU")
    args = ap.parse_args(argv)
    results = run(args.config, args.k, args.init_iters, args.joint_iters, args.views,
                  args.tournament, args.propagate_rounds, args.smooth_weight, args.skip_k1,
                  args.device)
    if args.skip_k1:
        return results
    a = results["gate-K1"]
    b = results[f"multihyp-K{args.k}"]
    print("\n=== multi-hypothesis ablation summary (record in BASELINE.md) ===")
    print(f"config: {args.config}  K={args.k} tournament={args.tournament}")
    print(f"joint IoU: K=1 {a['iou']:.4f} -> K={args.k} {b['iou']:.4f}")
    print(
        f"mean joint rot err: K=1 {np.mean(a['joint_rot_err']):.1f} deg -> "
        f"K={args.k} {np.mean(b['joint_rot_err']):.1f} deg"
    )
    print(
        f"wall: K=1 {a['wall']:.1f}s -> K={args.k} {b['wall']:.1f}s "
        f"({b['wall'] / max(a['wall'], 1e-9):.2f}x)"
    )
    print(
        "per-frame joint rot err (deg): K=1      "
        f"{np.round(a['joint_rot_err'], 1).tolist()}\n"
        f"                              K={args.k}      "
        f"{np.round(b['joint_rot_err'], 1).tolist()}"
    )
    return results


if __name__ == "__main__":
    main()
