"""Multi-sequence pose tracking, the port's ``run_multi.py``: several videos
tracked together, their frames pooled into one refine.

    python -m dynhor_tpu_torch.run_multi --config_paths A.yaml B.yaml [--exps_root exps]
    python -m dynhor_tpu_torch.run_multi --config_paths ... --device cpu

Per sequence: host preprocessing, the frame features, single-stage prior
scoring (K3 once per view chunk), gating and the autodepth translation
init.  Then ALL sequences' frames refine in one batched loop with a mesh
per frame (parallel/multiseq.py: K1/K2 once per step of each group of
``FRAMES_PER_CARD`` frames), at face and active-tile caps counted over
every pooled frame at its init pose.  Then, per sequence, the joint
temporal optimization at those caps and the artifacts: per-frame {R, T, K}
npz files under <exps_root>/<seq>/<exp>/obj_infos/, board/ and the config,
as ``run_multi.py`` writes them.  It runs on the CUDA card and raises
without one, unless ``--device cpu`` asks for the CPU.

On N cards, one process a card (``python -m torch.distributed.run
--nproc-per-node N -m dynhor_tpu_torch.run_multi ...``; NCCL on the card,
gloo with ``--device cpu``), with ``system.devices`` unset or N: the prior
views and the pooled frames are sharded over the ranks (groups of
FRAMES_PER_CARD x N frames, FRAMES_PER_CARD a card), the joints run on
every rank alike, and rank 0 writes the artifacts.
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np
import torch


class MultiRunResult(NamedTuple):
    cap: int  # pooled per-tile face cap
    act_cap: int | None  # pooled active-tile cap (None = dense)
    worst_load: int  # the largest per-tile candidate count, before headroom
    refine: object  # tracker.refine.RefineResult of the pooled refine
    sequences: list[dict]  # per sequence: name, exp_dir, rotations_row, translations, history
    seconds: dict[str, float]  # per phase, summed over the sequences


def main(argv: list[str] | None = None) -> MultiRunResult:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_paths", type=str, nargs="+", required=True)
    parser.add_argument("--exps_root", type=str, default="exps")
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device; the default is the CUDA card (no CPU fallback)",
    )
    args = parser.parse_args(argv)

    from .io.artifacts import Board, copy_config, save_pose_npzs
    from .io.config import experiment_dir, load_config
    from .models import dino as dino_mod
    from .parallel import mesh as PM
    from .parallel import multiseq as MS
    from .parallel.multihost import init_from_env
    from .tracker import jointopt as J
    from .tracker import pipeline as PL
    from .tracker import priors as P
    from .tracker import refine as RF
    from .tracker import selection as S
    from .utils import camera as cam
    from .utils import geometry as G
    from .utils.device import resolve_device
    from .utils.profiling import Profiler

    dev = resolve_device(args.device)
    configs = [load_config(p) for p in args.config_paths]
    init_from_env("gloo" if dev.type == "cpu" else "nccl")
    prof = Profiler(device=dev)
    base = configs[0]["system"]
    n_dev = PL.view_devices(base)
    view_mesh = frame_mesh = None
    if n_dev > 1:  # every rank makes the meshes; ranks past n_dev run unsharded
        view_mesh, frame_mesh = PM.make_mesh(n_dev, "views"), PM.make_mesh(n_dev, "frames")
        if not view_mesh.is_member:
            view_mesh = frame_mesh = None
    writer = PM.world()[0] == 0
    dino_params, dino_cfg = dino_mod.load_params(
        base["dino"].get("checkpoint"),
        dino_mod.DinoConfig(smaller_edge_size=int(base["dino"]["smaller_edge_size"])),
    )

    # ---- per-sequence preprocessing + prior scoring + gating ----
    seqs, meshes, mesh_arrays, targets_list, rot_inits, trans_inits, K_fulls = (
        [], [], [], [], [], [], []
    )
    for config in configs:
        sysc = config["system"]
        s = int(sysc["crop_size"])
        with prof.phase("host-prep"):
            seq = PL.load_sequence(config["data_info"]["dataroot"])
            ann = PL.process_frames(seq, s, float(sysc["bbox_expansion"]))
            mesh = PL.load_mesh(
                config["data_info"]["obj_path"],
                bool(config["data_info"].get("normalize_mesh", True)),
            )
        f_frames, h, w = seq.obj_masks.shape
        K_full = cam.intrinsics_from_image(h, w, float(sysc["focal_factor"]), device=dev)
        ma = PL._mesh_arrays(mesh, dev)
        target_masks = torch.as_tensor(ann.target_masks, device=dev)

        pc = sysc["prior"]
        prior_cfg = P.PriorConfig(
            num_views=int(pc["num_views"]),
            distance_scale=float(pc["distance_scale"]),
            crop_size=s,
            bbox_expansion=float(sysc["bbox_expansion"]),
            view_chunk=int(pc["view_chunk"]),
        )
        view_rots = P.prior_view_rotations(
            prior_cfg, torch.Generator().manual_seed(int(pc.get("seed", 0)))
        )
        view_rots = torch.as_tensor(view_rots, dtype=torch.float32, device=dev)
        with prof.phase("frame-features"):
            gt_feats, cos_masks = P.frame_gt_features(
                dino_params, dino_cfg, torch.as_tensor(ann.crop_images, device=dev),
                target_masks, device=dev,
            )
        radius, _ = P.mesh_radius_center(ma.verts)  # camera-distance radius
        window = P.compute_window(
            prior_cfg, float(P.mesh_norm_radius(ma.verts)),
            float(prior_cfg.distance_scale * radius),
        )
        with prof.phase("prior-scoring"):
            scores = P.prior_scores_batched(
                dino_params, dino_cfg, ma.verts, ma.faces, ma.face_uvs, ma.texture,
                view_rots, gt_feats, cos_masks, prior_cfg, window,
                host_batch=int(pc.get("host_batch", 1000)), device=dev, view_mesh=view_mesh,
            )
        with prof.phase("gating+autodepth"):
            gate = S.gate_all_frames(scores, view_rots.transpose(-1, -2))
            pts = torch.einsum("vj,bjk->bvk", ma.verts, gate.rotation_init)
            K_seq = K_full.expand(f_frames, 3, 3)
            trans0 = cam.tco_init_from_boxes_autodepth(
                torch.as_tensor(ann.bbox_xywh, device=dev), pts, K_seq
            )
            K_rois = cam.get_K_crop_resize(
                K_seq, torch.as_tensor(ann.square_xyxy, device=dev), s
            )
        seqs.append(seq)
        meshes.append(mesh)
        mesh_arrays.append(ma)
        targets_list.append(RF.FrameTargets(target_masks, gt_feats, K_rois))
        rot_inits.append(gate.rotation_init)
        trans_inits.append(trans0)
        K_fulls.append(K_full)
        print(f"prepared {config['seq_name']}: {f_frames} frames", flush=True)

    # ---- pooled multi-sequence refine ----
    cfg0 = configs[0]["system"]
    s0 = int(cfg0["crop_size"])
    with prof.phase("pooled-refine"):
        batch = MS.build_batch(meshes, targets_list, device=dev)
        rot_all = torch.cat(rot_inits)
        trans_all = torch.cat(trans_inits)
        # Counted per-tile face cap over ALL pooled frames at their init
        # poses (fixed caps silently drop faces at edge-on poses).
        cap, act_cap, worst, active = MS.pooled_caps(
            batch, rot_all, trans_all, s0, float(cfg0["sigma"])
        )
        print(
            f"pooled refine: per-tile face cap {cap}, active-tile cap {act_cap} (counted;"
            f" worst tile {worst} faces, {active} active tiles)", flush=True,
        )
        refine_cfg = RF.RefineConfig(
            num_iterations=int(cfg0["init_num_iterations"]),
            lr=float(cfg0["init_lr"]),
            crop_size=s0,
            sigma=float(cfg0["sigma"]),
            face_chunk=int(cfg0["face_chunk"]),
            mode="fine",
            max_faces_per_tile=cap,
            max_active_tiles=act_cap,
            offscreen_weight=float(cfg0["offscreen_weight"]),
        )
        if frame_mesh is None:
            res = MS.refine_poses_multi(
                batch, rot_all, trans_all, dino_params, dino_cfg, refine_cfg, device=dev
            )
        else:
            n_pool = rot_all.shape[0]
            idx, _ = PM.pad_to_multiple(torch.arange(n_pool), n_dev)
            local = MS.refine_poses_multi(
                MS.shard_batch(MS._frames(batch, idx), frame_mesh),
                *PM.shard_leading((rot_all[idx.to(dev)], trans_all[idx.to(dev)]), frame_mesh),
                dino_params, dino_cfg, refine_cfg, device=dev, frame_mesh=frame_mesh,
            )
            res = local._replace(**{
                k: PM.gather_leading(getattr(local, k), frame_mesh)[:n_pool]
                for k in RF.RefineResult._fields[:4]})
    print(
        f"pooled refine over {rot_all.shape[0]} frames from {len(configs)} sequences done;"
        f" max overflow {res.max_overflow}", flush=True,
    )

    # ---- per-sequence joint + export ----
    out = []
    off = 0
    for config, seq, ma, targets, K_full in zip(
        configs, seqs, mesh_arrays, targets_list, K_fulls
    ):
        sysc = config["system"]
        n = len(seq.frame_ids)
        rot6d = res.rot6d[off : off + n]
        trans = res.translations[off : off + n]
        off += n
        joint_cfg = J.JointConfig(
            num_iterations=int(sysc["joint_num_iterations"]),
            lr=float(sysc["joint_lr"]),
            lw_sil_obj=float(sysc["loss"]["lw_sil_obj"]),
            lw_smooth_obj=float(sysc["loss"]["lw_smooth_obj"]),
            crop_size=int(sysc["crop_size"]),
            sigma=float(sysc["sigma"]),
            face_chunk=int(sysc["face_chunk"]),
            max_faces_per_tile=cap,
            max_active_tiles=act_cap,
        )
        with prof.phase("joint-opt"):
            jres = J.joint_optimize(
                ma.verts, ma.faces, G.rot6d_to_matrix(rot6d), trans, targets.K_rois,
                targets.target_masks, joint_cfg, device=dev,
            )
        exp_dir = experiment_dir(config, args.exps_root)
        history = {k: np.asarray(v) for k, v in jres.history.items()}
        rots = G.rot6d_to_matrix(jres.rot6d).cpu().numpy()
        if writer:
            os.makedirs(exp_dir, exist_ok=True)
            if config.get("_config_path"):
                copy_config(exp_dir, config["_config_path"])
            board = Board(exp_dir)
            board.add_history(history)
            save_pose_npzs(
                exp_dir, seq.frame_ids, rots, jres.translations.cpu().numpy(),
                K_full.cpu().numpy()
            )
            board.close()
        print(
            f"{config['seq_name']}: joint iou {float(history['iou_object'][-1]):.4f}"
            f" -> {exp_dir}/obj_infos", flush=True,
        )
        out.append(dict(name=config["seq_name"], exp_dir=exp_dir, rotations_row=rots,
                        translations=jres.translations.cpu().numpy(), history=history))
    seconds = prof.summary()
    return MultiRunResult(cap, act_cap, worst, res, out, seconds)


if __name__ == "__main__":
    main()
