"""NeuS training throughput on the card: rays/s of a whole train step.

Twin of ``tools/bench_neus.py`` (``BASELINE.json``'s "NeuS rays/sec/chip"):
a full training step (render forward, every loss, backward, Adam) on
synthetic supervision, timed over ``steps`` steps after 3 warm-up steps,
between two ``torch.cuda.synchronize`` calls; the last loss is read back
and must have moved.  Also the hash encoder's forward and backward alone
at a step's point count, by CUDA events.

    python -m dynhor_tpu_torch.tools.bench_neus [--encoders pe hash]
        [--batches 1024 4096] [--sampler occgrid] [--n_shade 16]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..neus.data import ReconData
from ..utils import geometry as G
from ..utils.device import resolve_device


def synthetic_data(frames: int = 4, h: int = 128, w: int = 128, device=None) -> ReconData:
    """Random rotations at distance 1.6, uniform random images, full masks."""
    gen = torch.Generator().manual_seed(0)
    R = G.random_rotations(frames, gen)
    Ts = torch.tensor([[0.0, 0.0, 1.6]]).repeat(frames, 1)
    f = 1.2 * min(h, w)
    K = torch.tensor([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    imgs = torch.rand((frames, h, w, 3), generator=gen)
    return ReconData(imgs, torch.ones((frames, h, w)), None, R, Ts, K).to(device)


def bench_encoder(encoder: str, batches, steps: int = 20, table_size: int | None = None,
                  sampler: str = "neus", n_shade: int = 16,
                  device=None) -> dict[int, float]:
    """rays/s of one train step per batch size, on the card (None = the
    CUDA card; a CPU device fails at the first synchronization)."""
    from ..neus import trainer as T
    from ..neus.draws import Key
    from ..neus.fields import SDFConfig
    from ..neus.rendering import RenderConfig, occupancy_from_sdf

    dev = resolve_device(device)
    kw = {"encoder": encoder}
    if table_size is not None:
        kw["hash_table_size"] = table_size
    sdf_cfg = SDFConfig(**kw)
    rcfg = RenderConfig(sampler=sampler, n_shade=n_shade)
    data = synthetic_data(device=dev)
    results = {}
    for batch in batches:
        tcfg = T.TrainConfig(batch_rays=batch, num_steps=steps)
        state = T.init_train_state(Key(0, dev), sdf_cfg, tcfg)
        step_fn = T.make_train_step(rcfg, tcfg)
        key = Key(1, dev)
        occ = occupancy_from_sdf(state.field, rcfg) if sampler == "occgrid" else None
        warm = [step_fn(state, key.fold_in(i), data, None, occ) for i in range(3)]
        first = float(warm[0]["loss"])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            logs = step_fn(state, key.fold_in(100 + i), data, None, occ)
        torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / steps
        last = float(logs["loss"])  # read back: the device did the work
        if last == first:
            raise RuntimeError(f"loss never moved ({first} -> {last})")
        results[batch] = batch / dt
        print(f"[{encoder:4s} {sampler}] batch {batch:6d}: {dt * 1000:8.2f} ms/step "
              f"-> {batch / dt / 1000.0:9.1f}K rays/s", flush=True)
    return results


def bench_hash_encoder(n_points: int = 65536, n: int = 20, device=None) -> tuple[float, float]:
    """ms of ``hash_encode`` forward, and of forward + backward into the
    table, at ``n_points`` points and the default SDFConfig (16 levels of
    2^19 x 2), by CUDA events."""
    from ..neus.fields import SDFConfig, hash_encode
    from ._timing import timeit

    dev = resolve_device(device)
    cfg = SDFConfig(encoder="hash")
    gen = torch.Generator(device=dev).manual_seed(0)
    table = (1e-4 * torch.rand((cfg.hash_levels, cfg.hash_table_size, cfg.hash_features),
                               generator=gen, device=dev)).requires_grad_(True)
    x01 = torch.rand((n_points, 3), generator=gen, device=dev)
    g = torch.rand((n_points, cfg.hash_levels * cfg.hash_features), generator=gen, device=dev)

    def fwd():
        with torch.no_grad():
            hash_encode(table, x01, cfg)

    def fwd_bwd():
        table.grad = None
        hash_encode(table, x01, cfg).backward(g)

    return timeit(fwd, dev, n), timeit(fwd_bwd, dev, n)


def main(argv: list[str] | None = None) -> dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoders", nargs="+", default=["pe", "hash"])
    ap.add_argument("--batches", nargs="+", type=int, default=[1024, 4096, 8192])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hash_table_size", type=int, default=None)
    ap.add_argument("--sampler", type=str, default="neus")
    ap.add_argument("--n_shade", type=int, default=16,
                    help="top-k shaded sections (0 = dense)")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    best = {}
    for enc in args.encoders:
        r = bench_encoder(enc, args.batches, args.steps, args.hash_table_size, args.sampler,
                          args.n_shade, device=dev)
        best[enc] = max(r.values())
    for enc, v in best.items():
        print(f"BEST {enc}: {v / 1000.0:.1f}K rays/s on one card")
    return best


if __name__ == "__main__":
    main()
