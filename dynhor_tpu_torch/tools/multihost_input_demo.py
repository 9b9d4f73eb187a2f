"""Multi-process input-pipeline demo: one process a host (a card, or the
CPU).

Twin of ``tools/multihost_input_demo.py``.  Each process loads only its own
slice of the frame files (``parallel/multihost.process_local_range``),
keeps it as its shard of the global batch (``multihost.global_batch``) and
computes a per-frame reduction whose sum crosses the process boundary
(``parallel/mesh.all_reduce``); every rank then holds the global sum and
the gathered per-frame values.  ``--coordinator`` is "host:port" or an
init URL ("file:///dir/rendezvous").  A process here holds one device:
``--devices-per-process`` (the JAX tool's virtual CPU devices a process)
is accepted for the JAX tool's command line and has no effect.

    python -m dynhor_tpu_torch.tools.multihost_input_demo --coordinator file:///tmp/rdv \
        --rank 0 --world 2 --data /tmp/frames --out /tmp/out0.npz [--backend gloo]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from ..parallel import mesh as PM
from ..parallel import multihost as MH


def demo(data: str) -> dict:
    """This process's share of the demo in a joined group: {"per_frame",
    "total", "lo", "hi", "n_global", "world"} (arrays)."""
    files = sorted(glob.glob(os.path.join(data, "frame_*.npy")))
    n = len(files)
    lo, hi = MH.process_local_range(n)
    # This process's disk reads only.
    frames = torch.as_tensor(np.stack([np.load(f) for f in files[lo:hi]]))
    mesh = PM.make_mesh(axis_name="frames")
    batch = MH.global_batch({"frames": frames, "w": torch.arange(lo, hi) + 1.0,
                             "scale": torch.tensor(2.0)}, n, mesh, "frames")
    b = batch.local
    per_frame = (b["frames"] ** 2).mean(dim=(1, 2)) * b["w"] * b["scale"] / 2.0
    total = PM.all_reduce(per_frame.sum(), mesh)
    return {"lo": np.array(lo), "hi": np.array(hi), "n_global": np.array(batch.n_global),
            "total": total.numpy(), "per_frame": PM.gather_leading(per_frame, mesh).numpy(),
            "world": np.array(PM.world()[1])}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices-per-process", type=int, default=2,
                    help="the JAX tool's virtual devices a process; one device a process here")
    ap.add_argument("--backend", default="gloo", help="gloo (CPU tensors) or nccl")
    args = ap.parse_args(argv)
    MH.init_distributed(args.coordinator, args.world, args.rank, backend=args.backend)
    try:
        out = demo(args.data)
        np.savez(args.out, rank=args.rank, process_count=int(out["world"]),
                 global_devices=int(out["world"]), **out)
        print(f"rank {args.rank}: total={float(out['total']):.6f} ok", flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
