"""Overlay-render saved poses (the port's ``vis.py``; reference:
ObjTracker/vis.py).

    python -m dynhor_tpu_torch.vis --config_path exps/<seq>/<exp>/config.yaml
    python -m dynhor_tpu_torch.vis --config_path ... --device cpu

Reads the per-frame npz poses from <exps_root>/<seq>/<exp>/obj_infos/ and
writes composited jpgs to <exps_root>/<seq>/<exp>/render_res/, as
``vis.py`` does.  It renders on the CUDA card and raises without one, unless
``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch
from PIL import Image

from .io.config import load_config
from .utils import geometry as G
from .utils.device import resolve_device
from .utils.objio import load_obj
from .visualizer import Visualizer


def main(argv: list[str] | None = None) -> list[str]:
    """Returns the paths of the written overlays."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--exps_root", type=str, default="exps")
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device; the default is the CUDA card (no CPU fallback)",
    )
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    config = load_config(args.config_path)

    dataroot = config["data_info"]["dataroot"]
    paths = sorted(glob.glob(os.path.join(dataroot, "rgb", "*.jpg")))
    if not paths:
        paths = sorted(glob.glob(os.path.join(dataroot, "rgb", "*.png")))
    sample_folder = os.path.join(
        args.exps_root, str(config["seq_name"]), str(config["exp_name"])
    )
    assert os.path.exists(sample_folder), "Please run the pose optimizer first"
    print(len(paths))

    mesh = load_obj(config["data_info"]["obj_path"])
    # vis.py:28-29: always centroid-normalize, even when the run's config
    # said otherwise (a reference quirk, kept).
    verts = G.center_and_normalize_verts(torch.as_tensor(np.asarray(mesh.verts))).numpy()

    first = np.asarray(Image.open(paths[0]))
    height, width = first.shape[:2]
    focal = 1.2 * min(height, width)
    vis = Visualizer((height, width))
    out_dir = os.path.join(sample_folder, "render_res")
    os.makedirs(out_dir, exist_ok=True)

    written = []
    for p in paths:
        fid = os.path.basename(p)[:-4]
        npz_path = os.path.join(sample_folder, "obj_infos", f"{fid}.npz")
        if not os.path.exists(npz_path):
            continue
        info = np.load(npz_path)
        R, T = info["R"], info["T"]
        scale = float(info["obj_scale"]) if "obj_scale" in info.files else 1.0
        verts_cam = (scale * verts) @ R.T + T
        img = np.asarray(Image.open(p).convert("RGB")).astype(np.float32) / 255.0
        out = vis.draw_mesh(
            img, verts_cam, mesh.faces, (focal, focal, width // 2, height // 2),
            device=dev,
        )
        path = os.path.join(out_dir, f"{fid}.jpg")
        Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8)).save(path)
        written.append(path)
    return written


if __name__ == "__main__":
    main()
