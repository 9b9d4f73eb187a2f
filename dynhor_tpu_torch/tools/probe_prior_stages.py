"""Phase-level timing of the two-stage prior retrieval: the prescreen's
frame features, the counted cap, stage A (the prescreen of all views,
split into raster + crop and ViT + cosine) and stage B (the rescore at full
resolution of the union of each frame's top-k).

    python -m dynhor_tpu_torch.tools.probe_prior_stages \
        --config configs/custom_shoes.yaml [--views N]

Twin of ``tools/probe_prior_stages.py``: the same stages and print lines.
``context`` gathers the inputs, ``pieces`` builds the stages as named
callables that share their results (stage B ranks stage A's scores), and
``run`` clocks each on the card between two synchronizations.  The raster
+ crop split renders and crops one host batch of prescreen views chunk by
chunk, as the scoring does, and is extrapolated to all views; the ViT +
cosine share is the rest of stage A.
"""
from __future__ import annotations

import argparse
import dataclasses
import types

import numpy as np
import torch

from ..io.config import load_config
from ..models import dino as dino_mod
from ..tracker import pipeline as PL
from ..tracker import priors as P
from ..utils.device import resolve_device
from ._timing import wall_s


def context(dparams, dcfg, mesh, crop_images, target_masks, prior_cfg: P.PriorConfig,
            view_rots, edge: int = 224, scale: int = 2, topk: int = 48,
            host_batch: int = 1000, device=None):
    """Everything the stages read, on ``device``: the full-resolution frame
    features, the windows and the prescreen's configs, as
    ``prior_scores_two_stage`` makes them."""
    dev = resolve_device(device)
    verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
    radius, center = P.mesh_radius_center(verts)
    norm_r = float(P.mesh_norm_radius(verts))
    distance = float(prior_cfg.distance_scale * radius)
    cfg_lo = dataclasses.replace(
        prior_cfg, render_h=prior_cfg.render_h // scale, render_w=prior_cfg.render_w // scale,
        crop_size=prior_cfg.crop_size // scale, view_chunk=prior_cfg.view_chunk * scale,
    )
    gt_feats, cos_masks = P.frame_gt_features(dparams, dcfg, crop_images, target_masks,
                                              prior_cfg.dino_dtype, dev)
    return types.SimpleNamespace(
        dev=dev, dparams=dparams, dcfg=dcfg,
        dcfg_lo=dataclasses.replace(dcfg, smaller_edge_size=edge),
        verts=verts, faces=torch.as_tensor(mesh.faces, device=dev).long(),
        face_uvs=torch.as_tensor(mesh.face_uvs, dtype=torch.float32, device=dev),
        texture=torch.as_tensor(mesh.texture, dtype=torch.float32, device=dev),
        crops=crop_images, masks=target_masks, cfg=prior_cfg, cfg_lo=cfg_lo,
        view_rots=torch.as_tensor(view_rots, dtype=torch.float32, device=dev),
        window=P.compute_window(prior_cfg, norm_r, distance),
        window_lo=P.compute_window(cfg_lo, norm_r, float(cfg_lo.distance_scale * radius)),
        distance=distance, center=center, gt_feats=gt_feats, cos_masks=cos_masks,
        topk=topk, host_batch=host_batch, state={},
    )


def pieces(c) -> dict:
    """The stages in order, as {label: fn}; results go to ``c.state``
    ("gt_lo", "cm_lo", "cap", "scores_lo", "idx", "scores_b")."""
    st = c.state
    mesh = (c.verts, c.faces, c.face_uvs, c.texture)

    def features_lo():
        st["gt_lo"], st["cm_lo"] = P.frame_gt_features(
            c.dparams, c.dcfg_lo, c.crops, c.masks, c.cfg.dino_dtype, c.dev)
        return st["gt_lo"]

    def cap():
        st["cap"] = P.required_prior_cap(c.verts, c.faces, c.view_rots, c.cfg, c.window,
                                         c.distance, c.center)
        return st["cap"]

    def stage_a():
        st["scores_lo"] = P.prior_scores_batched(
            c.dparams, c.dcfg_lo, *mesh, c.view_rots, st["gt_lo"], st["cm_lo"], c.cfg_lo,
            c.window_lo, c.host_batch, c.dev)
        return st["scores_lo"]

    @torch.inference_mode()
    def raster_crop():
        rots = c.view_rots[: c.host_batch]
        cap_lo = P.required_prior_cap(c.verts, c.faces, rots, c.cfg_lo, c.window_lo,
                                      c.distance, c.center)
        k_win = P._window_camera(c.cfg_lo, c.window_lo, c.dev)
        dist = torch.tensor(c.distance, device=c.dev)
        total = torch.zeros((), device=c.dev)
        for i in range(0, rots.shape[0], c.cfg_lo.view_chunk):
            R = rots[i : i + c.cfg_lo.view_chunk]
            rgba, _, _ = P._render_views(*mesh, R, P._view_translations(R, dist, c.center),
                                         k_win, c.window_lo, cap_lo)
            crop, _, _ = P._crop_view(rgba, c.cfg_lo.crop_size, c.cfg_lo.bbox_expansion)
            total = total + crop.sum()
        return total

    def stage_b():
        scores_lo = st["scores_lo"].cpu().numpy()
        k = min(c.topk, scores_lo.shape[1])
        top = np.argpartition(-scores_lo, k - 1, axis=1)[:, :k]
        st["idx"] = np.unique(top.reshape(-1))
        st["scores_b"] = P.prior_scores_batched(
            c.dparams, c.dcfg, *mesh, c.view_rots[torch.as_tensor(st["idx"], device=c.dev)],
            c.gt_feats, c.cos_masks, c.cfg, c.window, c.host_batch, c.dev)
        return st["scores_b"]

    return {
        "frame features (prescreen res)": features_lo,
        "required_prior_cap (full window)": cap,
        "stage A: prescreen ALL views": stage_a,
        "  stage A split: raster+crop only": raster_crop,
        "stage B: full-res rescore": stage_b,
    }


def context_from_config(config: str, views: int = 0, device=None):
    cfg = load_config(config)
    sysc = cfg["system"]
    seq = PL.load_sequence(cfg["data_info"]["dataroot"])
    ann = PL.process_frames(seq, int(sysc["crop_size"]), float(sysc["bbox_expansion"]))
    mesh = PL.load_mesh(cfg["data_info"]["obj_path"], bool(cfg["data_info"]["normalize_mesh"]))
    dparams, dcfg = dino_mod.load_params(
        sysc["dino"].get("checkpoint"),
        dino_mod.DinoConfig(smaller_edge_size=int(sysc["dino"]["smaller_edge_size"])),
    )
    pc = sysc["prior"]
    prior_cfg = P.PriorConfig(
        num_views=views or int(pc["num_views"]), render_h=int(pc["render_hw"][0]),
        render_w=int(pc["render_hw"][1]), distance_scale=float(pc["distance_scale"]),
        crop_size=int(sysc["crop_size"]), bbox_expansion=float(sysc["bbox_expansion"]),
        view_chunk=int(pc["view_chunk"]),
        max_faces_per_tile=int(pc.get("max_faces_per_tile", 1280)),
    )
    view_rots = P.prior_view_rotations(prior_cfg,
                                       torch.Generator().manual_seed(int(pc.get("seed", 0))))
    ps = pc.get("prescreen") or {}
    return context(dparams, dcfg, PL._mesh_arrays(mesh, resolve_device(device)),
                   ann.crop_images, ann.target_masks, prior_cfg, view_rots,
                   int(ps.get("edge", 224)), int(ps.get("scale", 2)), int(ps.get("topk", 48)),
                   int(pc.get("host_batch", 1000)), device)


def run(config: str, views: int = 0, device=None, out=print) -> dict:
    """{stage: seconds} on the card, printed as the JAX tool prints."""
    c = context_from_config(config, views, device)
    n = int(c.view_rots.shape[0])
    out(f"[{n} views; window {c.window} -> prescreen {c.window_lo}; crop {c.cfg.crop_size} -> "
        f"{c.cfg_lo.crop_size}; DINO edge {c.dcfg.smaller_edge_size} -> "
        f"{c.dcfg_lo.smaller_edge_size}]")
    secs = {}
    for name, fn in pieces(c).items():
        _, secs[name] = wall_s(fn, c.dev)
        if name.strip().startswith("stage A split"):
            secs[name] *= n / min(c.host_batch, n)
            out(f"{name:42s} {secs[name]:7.1f} s (extrapolated)")
            split = "  stage A split: DINO+cosine (residual)"
            secs[split] = secs["stage A: prescreen ALL views"] - secs[name]
            out(f"{split:42s} {secs[split]:7.1f} s")
        else:
            out(f"{name:42s} {secs[name]:7.1f} s")
    out(f"[stage B rescored {len(c.state['idx'])} unique views]")
    secs["TOTAL (cap + A + B)"] = (secs["required_prior_cap (full window)"]
                                   + secs["stage A: prescreen ALL views"]
                                   + secs["stage B: full-res rescore"])
    out(f"{'TOTAL (cap + A + B)':42s} {secs['TOTAL (cap + A + B)']:7.1f} s")
    return secs


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/custom_shoes.yaml")
    ap.add_argument("--views", type=int, default=0, help="override num_views")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(args.config, args.views, dev, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
