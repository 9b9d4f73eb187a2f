"""The ViT's forward and backward to the input crop (the fine step's ViT
work: 8 x 3 x 256² crops through the fused resize + patch embedding to
518-edge tokens, ViT-B/14 in bf16), under each recomputation policy.

    python -m dynhor_tpu_torch.tools.probe_vit_fused [--attn-impl xla flash]

Twin of ``tools/probe_vit_fused.py``: the policies "frozen", "dots" and
False, plus True.  ``pieces`` builds one callable per policy (the image
gradient of a mean-square loss of the tokens); ``run`` times each on the
card by CUDA events after a first call, and reads its peak memory.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..models import dino as D
from ..utils.device import resolve_device
from ._timing import first_and_mean_ms

FRAMES = 8
CROP = 256
POLICIES = ("frozen", "dots", False, True)


def pieces(device, cfg: D.DinoConfig = D.DinoConfig(), frames: int = FRAMES, crop: int = CROP,
           policies=POLICIES, dtype=torch.bfloat16) -> dict:
    """{"remat=<policy>": fn}: fn() returns d(loss)/d(crops) (frames, 3,
    crop, crop) under that policy; random weights from seed 0, crops from
    seed 1."""
    params = D.map_params(D.init_params(cfg, torch.Generator().manual_seed(0)),
                          lambda a: a.to(device, dtype))
    rgb = torch.rand((frames, 3, crop, crop), generator=torch.Generator().manual_seed(1)).to(device)

    def make(remat):
        def grad():
            x = rgb.clone().requires_grad_(True)
            f = D.forward_tokens_from_crop(params, x, cfg, remat=remat)
            (f.float() ** 2).mean().backward()
            return x.grad

        return grad

    return {f"remat={r!r}": make(r) for r in policies}


def run(device=None, attn_impls=("xla",), n: int = 10, out=print) -> dict:
    """{(attn_impl, policy label): {"ms", "first_ms", "peak_gib"}}."""
    dev = resolve_device(device)
    res = {}
    for impl in attn_impls:
        cfg = dataclasses.replace(D.DinoConfig(), attn_impl=impl)
        for label, fn in pieces(dev, cfg).items():
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            first, ms = first_and_mean_ms(fn, dev, n)
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            res[(impl, label)] = {"ms": ms, "first_ms": first, "peak_gib": peak}
            out(f"[{impl}] {label:14s} f+b {ms:7.1f} ms  (first call {first / 1e3:5.1f} s, "
                f"peak {peak:.2f} GiB)")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--attn-impl", nargs="+", default=["xla"], choices=["xla", "flash", "splash"])
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, args.attn_impl, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
