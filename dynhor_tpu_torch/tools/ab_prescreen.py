"""A/B: two-stage prescreened prior retrieval against single-stage scoring
at full resolution.

Twin of ``tools/ab_prescreen.py``: the same arguments, runs and print
lines.  ``track_sequence`` runs in-process once with
``system.prior.prescreen.enabled`` false (the reference's single stage) and
once per two-stage variant; it reports each run's wall clock and joint IoU
and each variant's agreement with the single stage's selected prior views.
``--views`` (not in the JAX tool; default: the config's) sets
``system.prior.num_views``.

    python -m dynhor_tpu_torch.tools.ab_prescreen --config configs/custom_shoes.yaml \
        [--variants 224:2:48] [--views N] [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np

from ..io.config import load_config
from ..models import dino as dino_mod
from ..tracker import pipeline as PL
from . import _ablation as A


def run(config: str, variants: str = "224:2:48", views: int | None = None,
        device=None) -> dict:
    """{run name: {"result", "wall", "iou"}} for "single-stage" and each
    "two-stage e<edge>/s<scale>/k<topk>", and "agreement": {variant: equal
    selected views}; prints as the JAX tool prints."""
    cfg = load_config(config)
    sysc = cfg["system"]
    if views is not None:
        sysc["prior"]["num_views"] = views
    seq, ann, mesh = A.load_inputs(cfg)
    dparams, dcfg = dino_mod.load_params(
        sysc["dino"].get("checkpoint"),
        dino_mod.DinoConfig(smaller_edge_size=int(sysc["dino"]["smaller_edge_size"])),
    )
    parsed = [tuple(int(x) for x in spec.strip().split(":")) for spec in variants.split(",")]
    runs = [("single-stage", None)] + [
        (f"two-stage e{e}/s{s}/k{k}", (e, s, k)) for e, s, k in parsed
    ]
    results = {}
    for name, var in runs:
        c = copy.deepcopy(cfg)
        ps = dict(c["system"]["prior"].get("prescreen") or {})
        if var is None:
            ps["enabled"] = False
        else:
            ps.update(enabled=True, edge=var[0], scale=var[1], topk=var[2])
        c["system"]["prior"]["prescreen"] = ps
        t0 = time.time()
        res = PL.track_sequence(c, seq, ann, mesh, dino_params=dparams, dino_cfg=dcfg,
                                device=device)
        dt = time.time() - t0
        iou = float(res.history["iou_object"][-1])
        results[name] = {"result": res, "wall": dt, "iou": iou}
        print(f"[{name}] wall {dt:.1f}s, joint IoU {iou:.4f}")

    a = results["single-stage"]["result"]
    n = len(a.selected_idx)
    iou_a = results["single-stage"]["iou"]
    print(f"single selected: {np.asarray(a.selected_idx).tolist()}")
    agreement = {}
    for name, _ in runs[1:]:
        b = results[name]["result"]
        same = int((np.asarray(a.selected_idx) == np.asarray(b.selected_idx)).sum())
        agreement[name] = same
        iou_b = results[name]["iou"]
        print(
            f"[{name}] selected-view agreement: {same}/{n}  "
            f"joint IoU {iou_b:.4f} (d={iou_b - iou_a:+.4f})  "
            f"wall {results[name]['wall']:.1f}s vs single {results['single-stage']['wall']:.1f}s"
        )
        if same != n:
            print(f"  {name} selected: {np.asarray(b.selected_idx).tolist()}")
    results["agreement"] = agreement
    return results


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_shoes.yaml")
    ap.add_argument(
        "--variants", default="224:2:48",
        help="comma list of two-stage prescreen variants edge:scale:topk;"
        " each is compared against the single-stage run's selected views",
    )
    ap.add_argument("--views", type=int, default=None,
                    help="override system.prior.num_views")
    ap.add_argument("--device", default=None, help="default: the CUDA card; cpu for the CPU")
    args = ap.parse_args(argv)
    return run(args.config, args.variants, args.views, args.device)


if __name__ == "__main__":
    main()
