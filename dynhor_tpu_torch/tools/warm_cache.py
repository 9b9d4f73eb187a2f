"""Build the port's CUDA kernels ahead of a run, then drive the tracking
pipeline once at reduced iteration counts.

    python -m dynhor_tpu_torch.tools.warm_cache [--config configs/custom_shoes.yaml]
        [--build-dir DIR]

Twin of ``tools/warm_cache.py``'s pipeline mode.  The JAX package's cost
of a fresh process is XLA compiles, which its persistent cache keeps; the
port's is the ``nvcc`` build of its kernels (``kernels.build()``: one
``nvcc`` a source, started together, into ``build/``, which later
processes reuse by each source's hash).  The pipeline pass (25 refine and
50 joint steps on the config's sequence) then runs every kernel of the
path once and checks the whole path starts on this card.  The JAX tool's
``--dryrun`` mode warms the TPU harness's sharded tiers on a virtual CPU
mesh (``__graft_entry__.py``); the port has neither XLA programs to cache
nor that harness, so the mode has no counterpart here.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .. import kernels
from ..io.config import load_config
from ..tracker import pipeline as PL
from . import _ablation as A


def warm_kernels(build_dir: str | None = None) -> tuple[float, str]:
    """(seconds, ptxas's report) of ``kernels.build(build_dir)``."""
    t0 = time.time()
    report = kernels.build(build_dir)
    return time.time() - t0, report


def warm_pipeline(config_path: str, device=None) -> float:
    """Seconds of one ``track_sequence`` at 25 refine and 50 joint steps."""
    cfg = load_config(config_path)
    sysc = cfg["system"]
    sysc["init_num_iterations"] = 25
    sysc["joint_num_iterations"] = 50
    dataroot = cfg["data_info"]["dataroot"]
    if not os.path.isdir(dataroot):
        sys.exit(f"no {dataroot}: generate the demo data first "
                 f"(python -m dynhor_tpu_torch.tools.make_demo_data --out {dataroot})")
    t0 = time.time()
    seq, ann, mesh = A.load_inputs(cfg)
    dparams, dcfg = A.load_vit(cfg)
    PL.track_sequence(cfg, seq, ann, mesh, dino_params=dparams, dino_cfg=dcfg, device=device)
    return time.time() - t0


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_shoes.yaml")
    ap.add_argument("--build-dir", default=None, help="default: <repo>/build")
    args = ap.parse_args(argv)
    secs, _ = warm_kernels(args.build_dir)
    out = {"build_s": secs}
    print(f"[warm] kernels built and loaded from {args.build_dir or kernels.BUILD_DIR} "
          f"in {secs:.1f}s", flush=True)
    out["pipeline_s"] = warm_pipeline(args.config)
    print(f"[warm] pipeline ran in {out['pipeline_s']:.1f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
