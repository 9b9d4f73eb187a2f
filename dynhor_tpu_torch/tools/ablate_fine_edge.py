"""Fine-loss ViT-edge ablation: pose quality across the ViT's input edge.

Twin of ``tools/ablate_fine_edge.py``: the same arguments, defaults and
print lines.  The reference fixes the ViT's input edge at 518 px (37²
tokens); the fine refine step is ViT-bound and the ViT's cost grows about
quadratically with the tokens.  Per edge, refine + joint run on a sequence
with synthetic GT and report the joint IoU and the rotation errors.  The
edge applies to both the frame features and the fine loss's render branch
(one token grid for the masked cosine), as in the reference.  Edges 378 and
252 give 730 and 325 tokens, counts off the flash kernel's tiles.

    python -m dynhor_tpu_torch.tools.ablate_fine_edge --config configs/custom_shoes.yaml \
        [--edges 518 378 252] [--init-iters 50] [--joint-iters 100] [--views 500] \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import time

from ..io.config import load_config
from ..tracker import pipeline as PL
from . import _ablation as A


def run(config: str, edges=(518, 378, 252), init_iters: int = 50, joint_iters: int = 100,
        views: int = 500, device=None) -> dict:
    """{edge: {"iou", "wall", "init", "joint", "tokens", "result"}} (rotation
    errors in degrees per frame), printing each edge's line as it ends."""
    cfg = load_config(config)
    sysc = cfg["system"]
    sysc["init_num_iterations"] = init_iters
    sysc["joint_num_iterations"] = joint_iters
    sysc["prior"]["num_views"] = views
    gt_row = A.gt_rows(A.gt_path_or_exit(cfg, "the ablation"))
    seq, ann, mesh = A.load_inputs(cfg)
    results = {}
    for edge in edges:
        c = copy.deepcopy(cfg)
        c["system"]["dino"]["smaller_edge_size"] = int(edge)
        dparams, dcfg = A.load_vit(c, edge)
        t0 = time.time()
        res = PL.track_sequence(c, seq, ann, mesh, dino_params=dparams, dino_cfg=dcfg,
                                device=device)
        dt = time.time() - t0
        iou = float(res.history["iou_object"][-1])
        init_err = A.rot_errors(res.init_rotations_row, gt_row)
        joint_err = A.rot_errors(res.rotations_row, gt_row)
        results[edge] = dict(iou=iou, wall=dt, init=init_err, joint=joint_err,
                             tokens=dcfg.feat_size**2 + 1, result=res)
        print(
            f"[edge {edge} -> {dcfg.feat_size}^2 tokens] wall {dt:.1f}s  "
            f"joint IoU {iou:.4f}  rot err after refine {init_err.mean():.1f}"
            f" deg / after joint {joint_err.mean():.1f} deg",
            flush=True,
        )
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_shoes.yaml")
    ap.add_argument("--edges", nargs="+", type=int, default=[518, 378, 252])
    ap.add_argument("--init-iters", type=int, default=50)
    ap.add_argument("--joint-iters", type=int, default=100)
    ap.add_argument("--views", type=int, default=500)
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for the CPU")
    args = ap.parse_args(argv)
    results = run(args.config, args.edges, args.init_iters, args.joint_iters, args.views,
                  args.device)
    print("\n=== fine-loss DINO-edge ablation (record in BASELINE.md) ===")
    print(f"config: {args.config}")
    for edge, r in results.items():
        print(
            f"edge {edge:4d}: joint IoU {r['iou']:.4f}  "
            f"rot err refine/joint {r['init'].mean():6.1f} / "
            f"{r['joint'].mean():6.1f} deg  wall {r['wall']:.1f}s"
        )
    return results


if __name__ == "__main__":
    main()
