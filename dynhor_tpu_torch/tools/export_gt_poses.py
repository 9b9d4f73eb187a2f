"""Export gt_poses.npz to the stage-1 obj_infos artifact layout.

Twin of ``tools/export_gt_poses.py`` (numpy only): writes
``exps/<seq>/gt/obj_infos/NNNN.npz`` ({R, T, K} per frame, the schema the
reconstruction stage reads), so the NeuS stage can train from ground-truth
poses (``configs/neus_shoes_fast.yaml``'s ``poses_dir:
exps/custom_shoes/gt/obj_infos``) with pose error factored out of the
Chamfer/PSNR comparison.

    python -m dynhor_tpu_torch.tools.export_gt_poses --data data/custom_shoes \
        [--out exps/custom_shoes/gt/obj_infos]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def export(data: str, out: str | None = None) -> tuple[int, str]:
    """Write one npz a frame; returns (frames, output directory)."""
    gt = np.load(os.path.join(data, "gt_poses.npz"))
    seq = os.path.basename(os.path.normpath(data))
    out = out or os.path.join("exps", seq, "gt", "obj_infos")
    os.makedirs(out, exist_ok=True)
    n = gt["R"].shape[0]
    for i in range(n):
        np.savez(
            os.path.join(out, f"{i:04d}.npz"),
            R=gt["R"][i].astype(np.float32),
            T=gt["T"][i].astype(np.float32),
            K=gt["K"].astype(np.float32),
        )
    return n, out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="sequence dir with gt_poses.npz")
    ap.add_argument("--out", default=None, help="default exps/<seq>/gt/obj_infos")
    args = ap.parse_args(argv)
    n, out = export(args.data, args.out)
    print(f"wrote {n} GT pose npz files -> {out}")


if __name__ == "__main__":
    main()
