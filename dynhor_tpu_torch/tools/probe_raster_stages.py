"""Stage-level timing of the fused raster (8 frames of the shoes at 256²,
a cap of 1792 faces a tile): binning, then the per-face records and the
row packing, then K1 on the packed rows (its work list is built on the
card inside the launch), and the whole fused raster forward, with the
barycentrics, and forward + backward.  With ``--bwd``: K2 on the packed
rows, the per-tile gather of the face records alone, and its backward.

    python -m dynhor_tpu_torch.tools.probe_raster_stages [--bwd]

Twin of ``tools/probe_raster_stages.py`` (``main`` and ``probe_bwd``).
``pieces`` builds the named callables; ``run`` times them on the card by
CUDA events (mean ms of 20 calls after 3 warm-up calls).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import rasterize as rz
from ..ops.raster_fused import (
    _face_rows, kernel_inputs, rasterize_silhouette, tile_mass_depth, tile_mass_grad,
)
from ..ops.rasterize_tiled import bin_faces
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.objio import load_obj
from ._timing import timeit

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"
FRAMES = 8
S = 256
CAP = 1792
SIGMA = 0.25
TILE = 16


def scene(device, frames: int = FRAMES, s: int = S, obj: str = SHOES):
    """(projected verts (B, V, 3), faces) at seeded random rotations, depth 2."""
    m = load_obj(obj)
    verts = G.center_and_normalize_verts(torch.as_tensor(m.verts)).to(device)
    faces = torch.as_tensor(m.faces).long().to(device)
    K = torch.tensor([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1.0]], device=device)
    rng = np.random.default_rng(0)
    rot = G.rotations_from_uniforms(
        torch.as_tensor(rng.random((3, frames), dtype=np.float32))).to(device)
    trans = torch.tensor([[0.0, 0.0, 2.0]], device=device)
    vp = rz.project_perspective(torch.einsum("vj,bjk->bvk", verts, rot) + trans, K)
    return vp, faces


def pieces(device, frames: int = FRAMES, s: int = S, cap: int = CAP, obj: str = SHOES,
           bwd: bool = False) -> dict:
    """{label: fn}; each fn returns what its stage makes."""
    vp, faces = scene(device, frames, s, obj)
    margin = 6.0 * SIGMA + 1.0
    x = f"x{frames}"
    rows, counts, tw = kernel_inputs(vp, faces, (s, s), SIGMA, TILE, cap)

    def fused(v):
        frag, sil, _ = rasterize_silhouette(v, faces, (s, s), SIGMA, TILE, cap)
        return sil, frag

    def fwd_zbuf():
        sil, frag = fused(vp)
        return sil.sum() + frag.zbuf.sum()

    def fwd_bary():
        sil, frag = fused(vp)
        return sil.sum() + frag.bary.sum()

    def fused_f_b():
        v = vp.detach().clone().requires_grad_(True)
        sil, frag = fused(v)
        (sil.sum() + frag.bary.sum()).backward()
        return v.grad

    if not bwd:
        return {
            f"bin_faces {x}": lambda: bin_faces(vp, faces, (s, s), TILE, cap, margin),
            f"bins+records+packing {x}": lambda: kernel_inputs(vp, faces, (s, s), SIGMA, TILE, cap),
            f"K1 on packed rows {x}": lambda: tile_mass_depth(rows, counts, TILE, tw, SIGMA, 1e-2),
            f"fused fwd (no bary) {x}": fwd_zbuf,
            f"fused fwd (+bary) {x}": fwd_bary,
            f"fused f+b {x}": fused_f_b,
        }
    g = torch.rand(rows.shape[:2] + (TILE * TILE,), generator=torch.Generator().manual_seed(3))
    g = g.to(device)
    bins = bin_faces(vp, faces, (s, s), TILE, cap, margin)

    def gathered(v):
        rows_all = _face_rows(v, faces, 1e-2)
        b, t, m = bins.indices.shape
        return torch.gather(rows_all, 1, bins.indices.reshape(b, -1, 1).expand(-1, -1, 16))

    def gather_f_b():
        v = vp.detach().clone().requires_grad_(True)
        (gathered(v) ** 2).sum().backward()
        return v.grad

    return {
        f"K2 on packed rows {x}": lambda: tile_mass_grad(rows, counts, g, TILE, tw, SIGMA),
        f"gather-only fwd {x}": lambda: gathered(vp),
        f"gather+scatter f+b {x}": gather_f_b,
    }


def run(device=None, bwd: bool = False, n: int = 20, out=print) -> dict:
    dev = resolve_device(device)
    res = {}
    for name, fn in pieces(dev, bwd=bwd).items():
        res[name] = timeit(fn, dev, n)
        out(f"{name + ':':30s} {res[name]:8.3f} ms")
    return res


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bwd", action="store_true", help="the backward's pieces")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, args.bwd, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
