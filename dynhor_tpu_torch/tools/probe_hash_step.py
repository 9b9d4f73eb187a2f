"""Stage-level timing of the NeuS train step, PE against hash encoder:
``render_rays`` forward, the RGB + Eikonal loss forward, its gradient to
the field's parameters, and the whole train step.

    python -m dynhor_tpu_torch.tools.probe_hash_step [--batch 4096] [--sampler occgrid]
        [--encoders pe hash]

Twin of ``tools/probe_hash_step.py``: the same pieces and labels, on
``tools.bench_neus.synthetic_data`` (4 frames at 128²).  ``pieces`` builds
one encoder's named callables; ``run`` times them on the card by CUDA
events (mean of 5 calls after the first, which is reported apart).
"""
from __future__ import annotations

import argparse

import torch

from ..neus import trainer as T
from ..neus.draws import Key
from ..neus.fields import SDFConfig
from ..neus.rendering import RenderConfig, occupancy_from_sdf, render_rays
from ..utils.device import resolve_device
from ._timing import first_and_mean_ms
from .bench_neus import synthetic_data


def pieces(device, encoder: str, batch: int = 4096, sampler: str = "occgrid",
           sdf_cfg: SDFConfig | None = None, data=None, rcfg: RenderConfig | None = None) -> dict:
    """{label: fn} for one encoder, and "_inputs": (state, key, data, occ,
    rays, rgb_gt, rcfg, tcfg).  ``sdf_cfg``, ``data`` and ``rcfg`` default
    to the JAX tool's (the encoder's SDFConfig, the synthetic frames, the
    sampler with 16 shaded sections)."""
    sdf_cfg = sdf_cfg or SDFConfig(encoder=encoder)
    rcfg = rcfg or RenderConfig(sampler=sampler, n_shade=16)
    tcfg = T.TrainConfig(batch_rays=batch, num_steps=20)
    data = data if data is not None else synthetic_data(device=device)
    state = T.init_train_state(Key(0, device), sdf_cfg, tcfg)
    occ = occupancy_from_sdf(state.field, rcfg) if sampler == "occgrid" else None
    key = Key(1, device)
    fr, xy, rgb_gt, _, _ = T.sample_ray_batch(key, data, batch)
    rays = T._rays_for(data, fr, xy, rcfg.bound)
    field = state.field
    params = [p for p in field.parameters() if p.requires_grad]

    def loss():
        o = render_rays(field, rcfg, rays, key, occ)
        return (o.rgb - rgb_gt).abs().mean() + o.eikonal

    step_fn = T.make_train_step(rcfg, tcfg)
    return {
        "render_rays fwd": lambda: render_rays(field, rcfg, rays, key, occ).rgb.detach(),
        "rgb+eik loss fwd": lambda: loss().detach(),
        "rgb+eik loss grad": lambda: torch.autograd.grad(loss(), params),
        "full train_step": lambda: step_fn(state, key, data, None, occ)["loss"],
        "_inputs": (state, key, data, occ, rays, rgb_gt, rcfg, tcfg),
    }


def run(device=None, batch: int = 4096, sampler: str = "occgrid", encoders=("pe", "hash"),
        iters: int = 5, out=print) -> dict:
    dev = resolve_device(device)
    res = {}
    for enc in encoders:
        out(f"--- encoder={enc} sampler={sampler} batch={batch}")
        ps = pieces(dev, enc, batch, sampler)
        ps.pop("_inputs")
        for name, fn in ps.items():
            first, ms = first_and_mean_ms(fn, dev, iters)
            res[(enc, name)] = {"ms": ms, "first_ms": first}
            out(f"[{ms:9.2f} ms | first call {first / 1e3:6.1f}s] {name}")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--sampler", default="occgrid")
    ap.add_argument("--encoders", nargs="+", default=["pe", "hash"])
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, args.batch, args.sampler, args.encoders, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
