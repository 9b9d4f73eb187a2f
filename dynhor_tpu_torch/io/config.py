"""YAML config loading with defaults (reference: run.py:91-95 + SURVEY.md §5).

A copy of ``dynhor_tpu/io/config.py`` (the port imports nothing of the JAX
package).  PyYAML is imported by ``load_config`` alone, so the defaults
import without it.

The reference's flat schema (seq_name, exp_name, data_info.*, random_render,
system.*) is honored verbatim; knobs the reference hard-codes (prior view
count, distances, DINO model/edge size, gating thresholds, ...) are
surfaced under the same tree with reference-matching defaults.
"""
from __future__ import annotations

import copy
import os
from typing import Any

DEFAULTS: dict[str, Any] = {
    "seq_name": None,
    "exp_name": "pred",
    "data_info": {
        "dataroot": None,
        "obj_path": None,
        "normalize_mesh": True,
    },
    "random_render": True,  # run.py:130
    "system": {
        "init_num_iterations": 100,  # custom_shoes.yaml:12
        "init_lr": 0.01,
        "joint_num_iterations": 200,
        "joint_lr": 0.0001,
        "loss": {"lw_sil_obj": 1.0, "lw_smooth_obj": 10.0},
        # --- knobs hard-coded in the reference (SURVEY.md §5) ---
        "prior": {
            "num_views": 6000,  # run.py:132
            "distance_scale": 3.5,  # run.py:133
            "grid": [30, 10, 13],  # run.py:136 (used if random_render false)
            "render_hw": [384, 384],  # constants.py:4
            "view_chunk": 25,
            "host_batch": 1000,  # views per device launch (watchdog safety)
            "seed": 0,
            # Two-stage retrieval (tracker/priors.prior_scores_two_stage):
            # prescreen all views at reduced window/DINO edge, rescore the
            # per-frame top-K union at full res.  Gate-equivalence A/B'd on
            # the demo clip (tools/ab_prescreen.py, round 4: e112/s2/k24 and
            # e224/s2/k48 both select 12/12 views identical to single-stage;
            # 112/24 is ~4 s faster warm; scale 4 REJECTED — quarter-window
            # tiles pack denser, slowing the raster more than the smaller
            # ViT saves).  Disable for exact single-stage parity.
            "prescreen": {
                "enabled": True,
                "edge": 112,  # DINO smaller_edge_size for the prescreen
                "scale": 2,  # window/crop divisor for the prescreen render
                "topk": 24,  # per-frame candidates rescored at full res
            },
        },
        "dino": {
            "checkpoint": None,  # path to torch .pth / .npz; random if None
            # torch.hub family name (reference dino.py:5 hard-codes vitb14);
            # vits14 / vitl14 supported too — checkpoints auto-infer their
            # architecture at load (models/dino.convert_torch_state_dict).
            "model": "dinov2_vitb14",
            "smaller_edge_size": 518,  # dino.py:5
        },
        # Multi-hypothesis initialization: the reference plumbs
        # num_initializations everywhere but effectively always runs 1
        # (pose_initializtion.py:258,390, SURVEY.md quirks).  K > 1 refines
        # K inits per frame — the gate pick, its 180-degree silhouette
        # flips, and silhouette-IoU-retrieved diverse views — and selects
        # the per-frame winner by total loss after a short tournament
        # (tracker/selection.build_hypotheses, refine.refine_poses_multihyp).
        # Cost: ~(K x tournament_iters + init_num_iterations) frame-iters.
        "num_initializations": 1,
        "hypotheses": {
            "flips": True,  # include 180-deg camera-X/Y flips of the gate pick
            "sil_retrieval": True,  # silhouette-IoU channel fills spare slots
            "min_angle_deg": 30.0,  # diversity radius among hypotheses
            "tournament_iters": 25,  # steps before winner selection (None=full)
            # Winner selection: "viterbi" = temporally-consistent path over
            # the (frames x K) lattice (unary = z-normed loss, pairwise =
            # smooth_weight x geodesic deg between refined neighbours) —
            # resolves silhouette-flip ties per-frame loss cannot;
            # "loss" = per-frame argmin (r4 behavior).
            "select": "viterbi",
            "smooth_weight": 0.0222,  # loss-sigmas per degree (1/45)
            # Extra tournament rounds re-seeding each frame's slots from
            # its neighbours' current winners (tracking prior): a frame
            # whose hypothesis set missed the true pose inherits it.
            # Conversion advances ~1 frame per round from the recovered
            # prefix (a converted frame only seeds neighbours NEXT round),
            # so use ~F/2 rounds when a full-sequence silhouette flip is
            # suspected (shoes2: rounds 1/3/5 left 6/2/0 of 10 frames
            # flipped — BASELINE.md round-5 multi-hypothesis table).
            "propagate_rounds": 1,
        },
        "crop_size": 256,  # constants.py:2
        "bbox_expansion": 0.3,  # constants.py:3
        "focal_factor": 1.2,  # run.py:121
        "offscreen_weight": 1.0e5,  # pose_initializtion.py:154,185
        "parallel_refine": True,  # vmapped pipeline; False = sequential parity
        "outlier_voting": {
            # DKM-correspondence trajectory voting (tracker/outliers.py):
            # runs iff <dataroot>/correspondence_infos exists and enabled.
            "enabled": True,
            "threshold_px": 8.0,
            "rejoint": True,  # re-run a short joint opt after pose repair
        },
        "sigma": 0.25,  # soft-silhouette edge band (ours)
        # Refine/joint per-tile face cap is COUNTED per scene at the init
        # poses (tracker/pipeline._counted_refine_cap) times this headroom
        # factor (poses move during optimization).  Set max_faces_per_tile
        # to force an explicit cap instead of the counted one.
        "cap_headroom": 1.5,
        "max_faces_per_tile": None,
        "face_chunk": 512,
        "frame_chunk": None,  # optional microbatching of frames
        "devices": None,  # ranks the prior views are sharded over; None = every rank
        # Validate the dataroot against the README.md:27-44 convention
        # before loading (io/ingest.py) — errors raise, warnings print.
        "validate_data": True,
    },
}


def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(path: str) -> dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        user = yaml.safe_load(f) or {}
    cfg = copy.deepcopy(DEFAULTS)
    _merge(cfg, user)
    cfg["_config_path"] = os.path.abspath(path)
    return cfg


def experiment_dir(cfg: dict[str, Any], root: str = "exps") -> str:
    """exps/<seq>/<exp> (run.py:125-128 contract)."""
    return os.path.join(root, str(cfg["seq_name"]), str(cfg["exp_name"]))
