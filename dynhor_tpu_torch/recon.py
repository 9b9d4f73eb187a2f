"""SDF reconstruction entry point of the port (reference: ``recon.py``).

    python -m dynhor_tpu_torch.recon --config_path configs/neus_shoes_fast.yaml
    python -m dynhor_tpu_torch.recon --config_path ... --device cpu

Reads the config's ``system.recon`` block with ``recon.py``'s keys and
defaults, trains the SDF field (positional-encoding NeuS, the hash grid, or
instant-nsr-pl's hash-grid field at its published widths, per
``system.recon.encoder``: "pe", "hash", "ngp") from the stage-1 pose npz files, checkpoints
to ``<exps_root>/<seq>/<exp>/recon/checkpoints/step_<N>.pt``, extracts a
mesh with marching tetrahedra (the native library) to ``recon/mesh.obj``,
and reports the Chamfer distance to ``gt_mesh`` when one is configured.
It runs on the CUDA card and raises without one, unless ``--device cpu``
asks for the CPU.  Seconds per phase are printed as ``[profile]`` lines
(load, train, occupancy refreshes, grid SDF, marching, Chamfer).
"""
from __future__ import annotations

import argparse
import os
from typing import NamedTuple

import numpy as np


class ReconResult(NamedTuple):
    state: object  # neus.trainer.TrainState
    history: dict
    verts: np.ndarray
    faces: np.ndarray
    chamfer: float | None
    mesh_path: str
    seconds: dict[str, float]  # per phase


def main(argv: list[str] | None = None) -> ReconResult:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--exps_root", type=str, default="exps")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device; the default is the CUDA card (no CPU fallback)",
    )
    args = parser.parse_args(argv)

    import torch

    from .io.artifacts import Board
    from .io.config import experiment_dir, load_config
    from .neus import data as ND
    from .neus import extract as EX
    from .neus import fields as F
    from .neus import rendering as R
    from .neus import trainer as T
    from .utils.device import resolve_device
    from .utils.profiling import Profiler

    dev = resolve_device(args.device)
    config = load_config(args.config_path)
    rc = config["system"].get("recon", {})
    prof = Profiler(device=dev)

    exp_dir = experiment_dir(config, args.exps_root)
    poses_dir = rc.get("poses_dir") or os.path.join(exp_dir, "obj_infos")
    downscale = int(rc.get("downscale", 2))
    with prof.phase("load"):
        data, frame_ids = ND.load_recon_data(config["data_info"]["dataroot"], poses_dir, downscale)
        corr = ND.load_correspondences(config["data_info"]["dataroot"], frame_ids, downscale)
    print(
        f"recon: {len(frame_ids)} frames at {data.images.shape[2]}x{data.images.shape[1]}"
        f", normals={'yes' if data.normals is not None else 'no'}"
        f", correspondences={'yes' if corr is not None else 'no'}"
    )

    encoder = str(rc.get("encoder", "pe"))
    if encoder == "hash":
        print(
            "WARNING: system.recon.encoder='hash' is the instant-nsr-pl PARITY path;"
            " encoder='pe' with the occgrid sampler is the fast path"
            " (python -m dynhor_tpu_torch.tools.bench_neus measures both)",
            flush=True,
        )
    sdf_cfg = F.config_for(encoder)
    rcfg = R.RenderConfig(
        n_coarse=int(rc.get("n_coarse", 64)),
        n_importance=int(rc.get("n_importance", 64)),
        up_sample_steps=int(rc.get("up_sample_steps", 4)),
        sampler=str(rc.get("sampler", "neus")),
        n_candidates=int(rc.get("n_candidates", 192)),
        n_occ_samples=int(rc.get("n_occ_samples", 64)),
        occ_res=int(rc.get("occ_res", 64)),
        n_shade=int(rc.get("n_shade", 16)),
    )
    tcfg = T.TrainConfig(
        num_steps=int(rc.get("num_steps", 20000)),
        batch_rays=int(rc.get("batch_rays", 1024)),
        lr=float(rc.get("lr", 5e-4)),
        lw_rgb=float(rc.get("lw_rgb", 1.0)),
        lw_mask=float(rc.get("lw_mask", 0.1)),
        lw_eikonal=float(rc.get("lw_eikonal", 0.1)),
        lw_normal=float(rc.get("lw_normal", 0.1)),
        lw_corr=float(rc.get("lw_corr", 0.0 if corr is None else 0.01)),
        log_every=int(rc.get("log_every", 500)),
        checkpoint_every=int(rc.get("checkpoint_every", 5000)),
        grid_lr_mult=float(rc.get("grid_lr_mult", 20.0)),
    )

    board = Board(exp_dir)
    ckpt_dir = os.path.join(exp_dir, "recon", "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    with prof.phase("train"):
        state, history = T.train(
            data, sdf_cfg, rcfg, tcfg, corr=corr, board=board, checkpoint_dir=ckpt_dir,
            resume=not args.no_resume, device=dev, profiler=prof,
        )

    resolution = int(rc.get("mesh_resolution", 192))
    with prof.phase("grid-sdf"):
        grid = EX.sdf_grid_from_field(lambda p: F.sdf_only(state.field, p), resolution,
                                      bound=0.7, device=dev)
    with prof.phase("marching"):
        verts, faces = EX.mesh_from_sdf_grid(grid, bound=0.7)
    mesh_path = os.path.join(exp_dir, "recon", "mesh.obj")
    EX.save_obj(mesh_path, verts, faces)
    print(f"extracted mesh: {len(verts)} verts / {len(faces)} faces -> {mesh_path}")

    cd = None
    gt_mesh_path = rc.get("gt_mesh")
    if gt_mesh_path and os.path.exists(gt_mesh_path):
        from .utils import geometry as G
        from .utils.objio import load_obj

        with prof.phase("chamfer"):
            gt = load_obj(gt_mesh_path)
            gt_verts = G.center_and_normalize_verts(torch.as_tensor(gt.verts)).numpy()
            cd = EX.chamfer_distance(verts, faces, gt_verts, gt.faces)
        print(f"chamfer vs {gt_mesh_path}: {cd:.5f}")
        board.add_scalar("neus/chamfer", cd, state.step)
    if history.get("psnr"):
        print(f"final psnr {history['psnr'][-1]:.2f} dB")
    board.close()
    seconds = prof.summary()
    return ReconResult(state, history, verts, faces, cd, mesh_path, seconds)


if __name__ == "__main__":
    main()
