"""Convert a DINOv2 torch checkpoint to a .npz the loader reads natively.

Twin of ``tools/convert_dino_checkpoint.py``: the same arguments and print
lines; the round-trip check goes through this package's
``models/dino.convert_torch_state_dict``.  On a machine with network
access, fetch the official weights first:

    python -c "import torch; m = torch.hub.load('facebookresearch/dinov2', 'dinov2_vitb14'); \
               torch.save(m.state_dict(), 'dinov2_vitb14.pth')"
    python -m dynhor_tpu_torch.tools.convert_dino_checkpoint dinov2_vitb14.pth dinov2_vitb14.npz

then set ``system.dino.checkpoint: dinov2_vitb14.npz`` in the run config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import dino as D


def convert(src: str, dst: str) -> dict:
    """Write ``src``'s tensors to ``dst`` (.npz) and convert them back:
    {"tensors": n, "params": n, "pos_grid": g, "cfg": DinoConfig}."""
    sd = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    flat = {k: v.detach().cpu().numpy() for k, v in sd.items() if hasattr(v, "detach")}
    np.savez(dst, **flat)
    params, cfg = D.convert_torch_state_dict(dict(np.load(dst)))
    n = sum(int(np.prod(a.shape)) for a in _leaves(params))
    return {"tensors": len(flat), "params": n, "pos_grid": cfg.pos_grid, "cfg": cfg}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="torch .pth state_dict (official or HF naming)")
    parser.add_argument("dst", help="output .npz")
    args = parser.parse_args(argv)
    r = convert(args.src, args.dst)
    print(f"wrote {r['tensors']} tensors -> {args.dst}")
    print(f"converted OK: {r['params'] / 1e6:.1f}M params, pos grid {r['pos_grid']}")
    return r


if __name__ == "__main__":
    main()
