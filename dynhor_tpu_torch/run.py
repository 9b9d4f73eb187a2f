"""Pose-estimation entry point of the port (reference: ObjTracker/run.py).

    python -m dynhor_tpu_torch.run --config_path configs/custom_shoes.yaml
    python -m dynhor_tpu_torch.run --config_path ... --device cpu

Loads the sequence + template mesh, scores the prior views, refines every
frame's pose in one batched loop, runs the joint temporal optimization and
the outlier voting, and saves per-frame {R, T, K} npz files under
<exps_root>/<seq>/<exp>/obj_infos/, as ``run.py`` does.  It runs on the CUDA
card and raises without one, unless ``--device cpu`` asks for the CPU.

On N cards, one process a card, with ``system.devices: N`` (or unset):

    python -m torch.distributed.run --nproc-per-node N -m dynhor_tpu_torch.run \
        --config_path configs/custom_shoes.yaml

Each process joins the group from the launcher's environment (NCCL on the
card, gloo with ``--device cpu``); the prior scoring shards its views over
the ranks and rank 0 writes the artifacts.
"""
from __future__ import annotations

import argparse

from .io.config import load_config
from .parallel.multihost import init_from_env
from .tracker.pipeline import TrackResult, run_from_config


def main(argv: list[str] | None = None) -> TrackResult:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--exps_root", type=str, default="exps")
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device; the default is the CUDA card (no CPU fallback)",
    )
    args = parser.parse_args(argv)
    config = load_config(args.config_path)
    init_from_env("gloo" if args.device == "cpu" else "nccl")
    result = run_from_config(config, exps_root=args.exps_root, device=args.device)
    print(
        f"tracked {len(result.rotations_row)} frames; "
        f"final joint loss {result.history['loss'][-1]:.4f}, "
        f"iou {result.history['iou_object'][-1]:.4f}"
    )
    return result


if __name__ == "__main__":
    main()
