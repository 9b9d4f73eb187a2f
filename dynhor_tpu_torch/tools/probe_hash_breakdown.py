"""The hash-encoder SDF's layers one at a time: the encoder forward and
backward into the table, the SDF forward and forward + backward to its
parameters, the spatial gradient (one reverse pass over the points), the
second-order gradient (the Eikonal loss of the spatial gradient,
differentiated to the parameters: ``sdf_grad`` keeps its graph when
gradients are enabled), raw gathers and scatter-adds at the encoder's
aggregate shape, and the second order at smaller tables.

    python -m dynhor_tpu_torch.tools.probe_hash_breakdown [--points 262144] [--table-log2 19]

Twin of ``tools/probe_hash_breakdown.py``: the same pieces and labels.
``pieces`` builds the named callables; ``run`` times them on the card by
CUDA events (mean of 10 calls after one) and checks each result is
finite, as the JAX tool's checksum does.
"""
from __future__ import annotations

import argparse
import math

import torch

from ..neus import fields as F
from ..neus.draws import Key
from ..utils.device import resolve_device
from ._timing import timeit


def hash_field(log2: int, device, levels: int = 16) -> F.NeuSField:
    cfg = F.SDFConfig(encoder="hash", hash_table_size=2**log2, hash_levels=levels)
    return F.NeuSField(cfg, Key(0, device))


def _params_grad(loss, module):
    return torch.autograd.grad(loss, [p for p in module.parameters() if p.requires_grad],
                               materialize_grads=True)


def eikonal_grad(field: F.NeuSField, x):
    """d/d(SDF parameters) of mean((|grad_x sdf| - 1)^2)."""
    g = F.sdf_grad(field, x)
    return _params_grad(((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean(), field.sdf)


def pieces(device, points: int = 262144, table_log2: int = 19, small=(15, 13),
           levels: int = 16) -> dict:
    """{label: fn} in the JAX tool's order, and "_inputs": (field, points);
    points uniform in [-0.9, 0.9]^3."""
    field = hash_field(table_log2, device, levels)
    cfg = field.cfg
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((points, 3), generator=gen, device=device) * 1.8 - 0.9
    x01 = (x + 1.0) / 2.0
    table = field.sdf.table

    def enc_grad():
        return torch.autograd.grad(F.hash_encode(table, x01, cfg).sum(), table)

    def sdf_fwd():
        with torch.no_grad():
            return F.sdf_only(field, x).sum()

    n_lk = points * cfg.hash_levels * 8
    t_rows = cfg.hash_levels * cfg.hash_table_size
    idx = torch.randint(0, t_rows, (n_lk,), generator=gen, device=device)
    tab = torch.randn((t_rows, 2), generator=gen, device=device)
    g_rows = torch.randn((n_lk, 2), generator=gen, device=device)
    small_rows = 2**15
    idx_s = torch.randint(0, small_rows, (n_lk,), generator=gen, device=device)
    out = {
        "1 hash_encode fwd": lambda: F.hash_encode(table.detach(), x01, cfg),
        "2 hash_encode fwd+bwd(table)": enc_grad,
        "3a sdf_hash fwd": sdf_fwd,
        "3b sdf_hash fwd+bwd(params)": lambda: _params_grad(F.sdf_only(field, x).sum(), field.sdf),
        "4 spatial grad (one reverse pass)": lambda: F.sdf_grad(field, x).detach(),
        "5 grad(eikonal(grad-x)) [2nd order]": lambda: eikonal_grad(field, x),
        f"R1 raw gather {n_lk / 1e6:.1f}M rows of ({t_rows},2)": lambda: tab.index_select(0, idx),
        f"R2 raw scatter-add {n_lk / 1e6:.1f}M rows into ({t_rows},2)":
            lambda: torch.zeros((t_rows, 2), device=device).index_add_(0, idx, g_rows),
        f"R3 raw scatter-add {n_lk / 1e6:.1f}M rows into ({small_rows},2)":
            lambda: torch.zeros((small_rows, 2), device=device).index_add_(0, idx_s, g_rows),
    }
    for lg in small:
        f2 = hash_field(lg, device, levels)
        out[f"6 2nd-order @ table 2^{lg}"] = lambda f2=f2: eikonal_grad(f2, x)
    out["_inputs"] = (field, x)
    return out


def _finite(out) -> bool:
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    return all(math.isfinite(float(t.float().sum())) for t in leaves)


def run(device=None, points: int = 262144, table_log2: int = 19, n: int = 10, out=print) -> dict:
    dev = resolve_device(device)
    out(f"points={points}, table=2^{table_log2} x 16 levels x 2 feats")
    res = {}
    ps = pieces(dev, points, table_log2)
    ps.pop("_inputs")
    for name, fn in ps.items():
        res[name] = timeit(fn, dev, n, warmup=1)
        tag = "" if _finite(fn()) else "  [NONFINITE CHECKSUM]"
        out(f"[{res[name]:9.2f} ms] {name}{tag}")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=262144)  # 4096 rays x 64
    ap.add_argument("--table-log2", type=int, default=19)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, args.points, args.table_log2, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
