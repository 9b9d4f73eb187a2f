"""Weak scaling of the frame-sharded fine refine step: one process a
device, one frame a process (frames = processes), at 1, 2, 4 and 8
processes.

    python -m dynhor_tpu_torch.tools.weak_scaling [--edge 126] [--iters 3]
        [--devices 1 2 4 8] [--device cpu]

Twin of ``tools/weak_scaling.py``: the production scene (the shoes mesh,
256² crops, the full ViT-B/14 architecture with random weights at a
126-pixel edge, 9² tokens, f32), the refine's frames sharded over the
processes (``refine_poses(frame_mesh=...)``: each process steps its own
frames, the overflow is reduced across them).  On cards each process takes
one card and the group runs NCCL (``--devices`` at most the card count);
with ``--device cpu`` the processes are gloo ranks on the CPU's cores.
The JAX tool's virtual CPU mesh serializes its devices on one core, so it
reports overhead(n) = t(n) / (n t(1)); here the processes run at once, and
the table gives t(n), that overhead and the weak-scaling efficiency t(1) /
t(n).  A rank is ``python -m dynhor_tpu_torch.tools.weak_scaling --rank R
...``, started by ``run``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..models import dino as D
from ..ops import rasterize as rz
from ..parallel import mesh as PM
from ..parallel import multihost as MH
from ..tracker import refine as RF
from ..utils import geometry as G
from ..utils.objio import load_obj

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHOES = os.path.join(REPO, "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
# Head dim 16, which K5 does not take: the attention written out.
TINY_VIT = dict(patch_size=14, embed_dim=64, depth=2, num_heads=4, pos_grid=4, attn_impl="xla")


def setup(frames: int, edge: int, device, crop: int = 256, dino: str = "full"):
    """The production-shape scene of ``frames`` frames (``__graft_entry__.
    _prod_setup``'s, with seeded numpy draws): (mesh, targets, rot, trans,
    dparams, dcfg, cfg).  ``dino="tiny"`` is a depth-2, 64-wide ViT."""
    m = load_obj(SHOES)
    mesh = RF.MeshArrays(G.center_and_normalize_verts(torch.as_tensor(m.verts)),
                         torch.as_tensor(m.faces).long(), torch.as_tensor(m.face_uvs),
                         torch.as_tensor(m.texture))
    base = D.DinoConfig(**TINY_VIT) if dino == "tiny" else D.DinoConfig()
    dcfg = dataclasses.replace(base, smaller_edge_size=edge)
    dparams = D.init_params(dcfg, torch.Generator().manual_seed(0))
    s = crop
    K = torch.tensor([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(1)
    rot = G.rotations_from_uniforms(torch.as_tensor(rng.random((3, frames), dtype=np.float32)))
    trans = torch.tensor([[0.0, 0.0, 1.9]]).repeat(frames, 1)
    dev_mesh = RF.MeshArrays(*(x.to(device) for x in mesh))
    vp = rz.project_perspective(
        torch.einsum("vj,bjk->bvk", dev_mesh.verts, rot.to(device)) + trans.to(device)[:, None],
        K.to(device))
    with torch.no_grad():
        masks = (rz.rasterize(vp, dev_mesh.faces, (s, s), face_chunk=512).pix_to_face >= 0)
    gt = torch.randn((frames, dcfg.feat_size**2, dcfg.embed_dim),
                     generator=torch.Generator().manual_seed(2))
    gt = gt / torch.linalg.norm(gt, dim=-1, keepdim=True)
    targets = RF.FrameTargets(masks.float().cpu(), gt, K.expand(frames, 3, 3))
    cfg = RF.RefineConfig(num_iterations=1, crop_size=s, mode="fine", sigma=0.25,
                          max_faces_per_tile=1792, dino_dtype="float32", face_chunk=512)
    return mesh, targets, rot, trans, dparams, dcfg, cfg


def rank_step(args) -> dict:
    """One rank: its frame's refine, one warm-up step, then ``iters`` steps
    timed between two synchronizations; returns {"ms", "losses"} (the
    losses of every frame, gathered)."""
    dev = torch.device("cpu") if args.device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    mesh, targets, rot, trans, dparams, dcfg, cfg = setup(
        args.world, args.edge, dev, args.crop, args.dino)
    # The collectives run on the group's device (NCCL takes CUDA tensors).
    mesh = RF.MeshArrays(*(x.to(dev) for x in mesh))
    targets = RF.FrameTargets(*(x.to(dev) for x in targets))
    rot, trans, dparams = rot.to(dev), trans.to(dev), D.map_params(dparams, lambda a: a.to(dev))
    fm = PM.make_mesh(axis_name="frames")
    local = (PM.replicate(mesh, fm), RF.FrameTargets(*PM.shard_leading(tuple(targets), fm)),
             PM.shard_leading(rot, fm), PM.shard_leading(trans, fm))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    RF.refine_poses(*local, dparams, dcfg, cfg, device=dev, frame_mesh=fm)  # warm-up
    sync()
    t0 = time.perf_counter()
    res = RF.refine_poses(*local, dparams, dcfg,
                          dataclasses.replace(cfg, num_iterations=args.iters),
                          device=dev, frame_mesh=fm)
    sync()
    ms = (time.perf_counter() - t0) / args.iters * 1e3
    losses = PM.gather_leading(res.final_loss.to(dev), fm)
    return {"ms": ms, "losses": losses.cpu().tolist()}


def run(devices=(1, 2, 4, 8), edge: int = 126, iters: int = 3, device=None,
        crop: int = 256, dino: str = "full", timeout: float = 1800, out=print) -> list[dict]:
    """Per process count: {"devices", "ms" (the slowest rank's), "overhead",
    "efficiency", "losses"}; the table printed at the end."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' for gloo ranks")
        if max(devices) > torch.cuda.device_count():
            raise ValueError(f"{max(devices)} processes need as many cards "
                             f"({torch.cuda.device_count()} present): NCCL takes one a card")
    rows, t1 = [], None
    for n in devices:
        with tempfile.TemporaryDirectory(prefix="weak_scaling_") as tmp:
            env = {**os.environ, "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // n))}
            env.pop("WORLD_SIZE", None)
            procs = [subprocess.Popen(
                [sys.executable, "-m", "dynhor_tpu_torch.tools.weak_scaling", "--rank", str(r),
                 "--world", str(n), "--rendezvous", f"file://{tmp}/rendezvous",
                 "--out", os.path.join(tmp, f"rank{r}.json"), "--edge", str(edge),
                 "--iters", str(iters), "--crop", str(crop), "--dino", dino,
                 "--device", "cpu" if device == "cpu" else "cuda"],
                cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ) for r in range(n)]
            try:
                logs = [p.communicate(timeout=timeout)[0] for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            for r, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {n} failed:\n{log[-4000:]}")
            ranks = []
            for r in range(n):
                with open(os.path.join(tmp, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
        ms = max(r["ms"] for r in ranks)
        t1 = t1 or ms
        row = {"devices": n, "ms": ms, "overhead": ms / (n * t1), "efficiency": t1 / ms,
               "losses": ranks[0]["losses"]}
        rows.append(row)
        out(f"devices={n}: step {ms:8.1f} ms  overhead {row['overhead']:5.2f}x  "
            f"efficiency {row['efficiency']:5.2f}  loss {float(np.sum(row['losses'])):.4f}")
    out("\n| devices | frames | step (ms) | overhead vs n x t(1) | efficiency t(1)/t(n) |")
    out("|---|---|---|---|---|")
    for r in rows:
        out(f"| {r['devices']} | {r['devices']} | {r['ms']:.1f} | {r['overhead']:.2f}x | "
            f"{r['efficiency']:.2f} |")
    return rows


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--edge", type=int, default=126, help="DINO edge (126 = 9x9 tokens)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--device", default=None, help="default: cards (NCCL); cpu for gloo ranks")
    ap.add_argument("--crop", type=int, default=256)
    ap.add_argument("--dino", default="full", choices=["full", "tiny"])
    ap.add_argument("--rank", type=int, default=None, help="run as this rank (started by run)")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rendezvous", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.rank is None:
        return run(args.devices, args.edge, args.iters, args.device, args.crop, args.dino,
                   out=lambda s: print(s, flush=True))
    MH.init_distributed(args.rendezvous, args.world, args.rank,
                        backend="gloo" if args.device == "cpu" else "nccl")
    try:
        result = rank_step(args)
    finally:
        torch.distributed.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
