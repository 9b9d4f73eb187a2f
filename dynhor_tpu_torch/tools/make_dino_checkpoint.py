"""Write a full-size official-format ``dinov2_vitb14`` state_dict to disk.

Twin of ``tools/make_dino_checkpoint.py``: the same keys, shapes, dtypes and
values (numpy's ``default_rng(seed)``) as ``torch.hub.load('facebookresearch/
dinov2', 'dinov2_vitb14').state_dict()`` has keys, shapes and dtypes, with
random values.  It drives the real loading path (config
``system.dino.checkpoint`` -> ``models/dino.load_params`` ->
``convert_torch_state_dict``), so that dropping in the real file is a config
change, not a code change.

    python -m dynhor_tpu_torch.tools.make_dino_checkpoint dinov2_vitb14_random.npz [--pth]

With the real weights, use ``tools.convert_dino_checkpoint`` instead (or
point the config at the .pth directly).
"""
from __future__ import annotations

import argparse

import numpy as np

# dinov2_vitb14: patch 14, dim 768, depth 12, heads 12, mlp 4x, 518-px
# pos-embed grid (37^2 + cls).
DIM = 768
DEPTH = 12
PATCH = 14
N_POS = 37 * 37 + 1
MLP = 4 * DIM


def official_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """Official facebookresearch/dinov2 key layout, random values."""
    rng = np.random.default_rng(seed)

    def tn(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    sd: dict[str, np.ndarray] = {
        "cls_token": tn(1, 1, DIM),
        "pos_embed": tn(1, N_POS, DIM),
        "mask_token": tn(1, DIM),  # present in the official file; unused here
        "patch_embed.proj.weight": tn(DIM, 3, PATCH, PATCH),
        "patch_embed.proj.bias": tn(DIM),
        "norm.weight": np.ones(DIM, np.float32),
        "norm.bias": np.zeros(DIM, np.float32),
    }
    for i in range(DEPTH):
        p = f"blocks.{i}."
        sd[p + "norm1.weight"] = np.ones(DIM, np.float32)
        sd[p + "norm1.bias"] = np.zeros(DIM, np.float32)
        sd[p + "attn.qkv.weight"] = tn(3 * DIM, DIM)
        sd[p + "attn.qkv.bias"] = tn(3 * DIM)
        sd[p + "attn.proj.weight"] = tn(DIM, DIM)
        sd[p + "attn.proj.bias"] = tn(DIM)
        sd[p + "ls1.gamma"] = np.full(DIM, 1e-5, np.float32)
        sd[p + "norm2.weight"] = np.ones(DIM, np.float32)
        sd[p + "norm2.bias"] = np.zeros(DIM, np.float32)
        sd[p + "mlp.fc1.weight"] = tn(MLP, DIM)
        sd[p + "mlp.fc1.bias"] = tn(MLP)
        sd[p + "mlp.fc2.weight"] = tn(DIM, MLP)
        sd[p + "mlp.fc2.bias"] = tn(DIM)
        sd[p + "ls2.gamma"] = np.full(DIM, 1e-5, np.float32)
    return sd


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="output path (.npz, or .pth with --pth)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pth", action="store_true",
                    help="save as a torch state_dict .pth instead of .npz")
    args = ap.parse_args(argv)
    sd = official_state_dict(args.seed)
    if args.pth:
        import torch

        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, args.out)
    else:
        np.savez(args.out, **sd)
    n_params = sum(v.size for v in sd.values())
    print(f"wrote {args.out}: {len(sd)} tensors, {n_params/1e6:.1f}M params")


if __name__ == "__main__":
    main()
