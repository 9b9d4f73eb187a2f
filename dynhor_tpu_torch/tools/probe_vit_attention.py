"""A/B the ViT's attention implementations at the fine loss's shape.

    python -m dynhor_tpu_torch.tools.probe_vit_attention [--frames 8] [--edge 518] [--iters 10]

Twin of ``tools/probe_vit_attention.py``: DINOv2 ViT-B/14 forward and
backward to the INPUT IMAGE (weights frozen, the fine loss's pattern) at
``frames`` x 518² in bf16 under ``remat="frozen"``, for each attention the
card tells apart:

  * ``xla``               the attention written out (the gradient baseline)
  * ``flash``             the K5 kernels, two-pass backward
  * ``splash``            the same kernels (the TPU's tile knobs select
                          nothing here, so the JAX tool's block sweeps
                          collapse into this one)
  * ``splash fused-bwd``  ``splash_fused_bwd=True``: the fused backward (K5c)

Each prints its f+b ms (CUDA events, after a first call that builds the
kernels) and the max |Δ| of its image gradient against ``xla``'s, also
relative to the largest |gradient| (bf16 noise is expected; a structural
fault would be of the gradient's own size).  The random weights' attention
layer scale is raised from the init's 1e-5 to 1: at 1e-5 the attention
vanishes below bf16's resolution of the residual stream and every
variant's gradient equals ``xla``'s.  A variant that fails makes the tool
fail.

``pieces`` builds one callable per variant (runnable on the CPU at a tiny
size); ``run`` times them on the card.

Env: ``DYNHOR_PROBE_ONLY="name1;name2"`` runs only the named variants
(exact match against the labels above); ``xla`` is always kept as the
gradient baseline.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..models import dino as D
from ..utils.device import resolve_device
from ._timing import first_and_mean_ms

VARIANTS = {
    "xla": {"attn_impl": "xla"},
    "flash": {"attn_impl": "flash"},
    "splash": {"attn_impl": "splash"},
    "splash fused-bwd": {"attn_impl": "splash", "splash_fused_bwd": True},
}


def selected(only: str | None = None) -> list[str]:
    """The variants to run: all, or ``xla`` and those named in ``only``
    (``DYNHOR_PROBE_ONLY``'s format)."""
    if not only:
        return list(VARIANTS)
    keep = only.split(";")
    return [name for name in VARIANTS if name == "xla" or name in keep]


def pieces(device, frames: int = 8, edge: int = 518, cfg: D.DinoConfig | None = None,
           names=None, dtype=torch.bfloat16) -> dict:
    """{variant: fn}: fn() returns d(loss)/d(images) (frames, 3, edge, edge)
    under that variant's attention, the loss the mean of 1 - cos between
    the tokens and random features; random weights from seed 0 (the
    attention's layer scale 1), images and features from seed 1."""
    params, cfg0 = D.load_params(None, cfg or D.DinoConfig(smaller_edge_size=edge))
    params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    params = D.map_params(params, lambda a: a.to(device, dtype))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((frames, 3, edge, edge), generator=gen).to(device, dtype)
    gt = torch.randn((frames, (edge // cfg0.patch_size) ** 2, cfg0.embed_dim), generator=gen)
    gt = gt.to(device)

    def make(cfg):
        def grad():
            img = x.clone().requires_grad_(True)
            feats = D.forward_tokens(params, img, cfg, remat="frozen").float()
            cos = (gt * feats).sum(-1) / (
                torch.linalg.norm(gt, dim=-1) * torch.linalg.norm(feats, dim=-1) + 1e-6)
            (1.0 - cos).mean().backward()
            return img.grad

        return grad

    return {name: make(dataclasses.replace(cfg0, **VARIANTS[name]))
            for name in (names or list(VARIANTS))}


def run(device=None, frames: int = 8, edge: int = 518, iters: int = 10, names=None,
        out=print) -> dict:
    """{variant: {"ms", "first_ms", "max_grad_diff", "rel_grad_diff"}},
    timed on the card."""
    dev = resolve_device(device)
    fns = pieces(dev, frames, edge, names=names)
    res, ref = {}, None
    for name, fn in fns.items():
        first, ms = first_and_mean_ms(fn, dev, iters)
        g = fn().float()
        if name == "xla":
            ref = g
        diff = float((g - ref).abs().max())
        rel = diff / float(ref.abs().max())
        res[name] = {"ms": ms, "first_ms": first, "max_grad_diff": diff, "rel_grad_diff": rel}
        out(f"{name:16s} f+b {ms:7.1f} ms  (first call {first / 1e3:5.1f} s, "
            f"max|grad Δ| vs xla {diff:.2e}, {rel:.2e} of max|grad|)")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--edge", type=int, default=518)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, args.frames, args.edge, args.iters,
               selected(os.environ.get("DYNHOR_PROBE_ONLY")),
               out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
