"""Component-level timing of the fine refine step on the card.

    python -m dynhor_tpu_torch.tools.profile_fine_step

The twin of ``tools/profile_fine_step.py``: the same pieces, shapes and
print lines, for the port.  The 8-frame fine step is broken into its
pieces (binning, the fused raster forward and forward + backward, with
active-tile compaction, the older separate path, the shading with the
resize to the ViT's edge, the ViT, the whole step) and each is timed with
CUDA events, in ms per 8-frame batch, after warm-up calls.  The scene is
the shoes mesh at a 256² crop from numpy-seeded rotations, a box target
mask and a random-weight ViT-B/14 (``init_params``, as the JAX tool's
``load_params(None)``); the per-tile face cap and the active-tile cap are
counted as the JAX tool counts them.

The "OLD separate" piece is ``rasterize_tiled`` (plain PyTorch, ``tile_chunk``
tiles at a time) beside ``soft_silhouette_kernel``, whose forward and
backward are K4a and K4b; ``run`` returns their launches in that piece.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..models import dino as D
from ..ops import rasterize as rz
from ..ops.raster_fused import rasterize_silhouette
from ..ops.rasterize_tiled import bin_faces, max_active_tiles_load, max_tile_load, rasterize_tiled
from ..ops.resize import resize_bicubic_align_corners
from ..ops.shading import fine_lights, phong_shade
from ..ops.silhouette_kernel import soft_silhouette_kernel
from ..tracker import refine as RF
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.objio import load_obj
from ._timing import timeit

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"
FRAMES, CROP = 8, 256  # the JAX tool's batch and crop


def counted_caps(vp, faces, s: int, sigma: float = 0.25, tile: int = 16):
    """(cap, worst load, active-tile cap, worst active tiles), counted as
    tools/profile_fine_step.py counts them: the worst frame at the
    silhouette margin, times 1.5, the cap rounded up to 128 (at least 256,
    at most the face count), the active-tile cap up to 8."""
    margin = 6.0 * sigma + 1.0
    worst = int(max_tile_load(vp, faces, (s, s), tile, margin).max())
    n_act = int(max_active_tiles_load(vp, faces, (s, s), tile, margin).max())
    cap = max(256, min(-(-int(worst * 1.5) // 128) * 128, int(faces.shape[0])))
    act_cap = max(8, min(-(-int(n_act * 1.5) // 8) * 8, (-(-s // tile)) ** 2))
    return cap, worst, act_cap, n_act


def run(device=None, n: int = 20, out=print) -> dict:
    """Time every piece over ``n`` calls after 3 warm-up calls; returns
    {"ms": {piece: ms}, "caps": (cap, act_cap), "old_separate_launches":
    {"K4a": n, "K4b": n}}."""
    dev = resolve_device(device)
    dcfg = D.DinoConfig()
    s, b = CROP, FRAMES
    md = load_obj(SHOES)
    verts = G.center_and_normalize_verts(torch.as_tensor(md.verts)).to(dev)
    mesh = RF.MeshArrays(
        verts, torch.as_tensor(md.faces).long().to(dev),
        torch.as_tensor(md.face_uvs).to(dev), torch.as_tensor(md.texture).to(dev),
    )
    faces = mesh.faces
    rng = np.random.default_rng(0)
    rot = G.rotations_from_uniforms(torch.as_tensor(rng.random((3, b), dtype=np.float32))).to(dev)
    trans = torch.tensor([[0.0, 0.0, 2.0]], device=dev).repeat(b, 1)
    K = torch.tensor([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1.0]], device=dev)
    gen = torch.Generator().manual_seed(1)
    gt = torch.randn((b, dcfg.feat_size**2, dcfg.embed_dim), generator=gen)
    gt = (gt / torch.linalg.norm(gt, dim=-1, keepdim=True)).to(dev)
    tm = torch.zeros((b, s, s), device=dev)
    tm[:, s // 4 : 3 * s // 4, s // 4 : 3 * s // 4] = 1.0
    targets = RF.FrameTargets(tm, gt, K.expand(b, 3, 3))
    r6 = G.matrix_to_rot6d(rot)
    tr = trans[:, None, :]
    vt0 = torch.einsum("vj,bjk->bvk", verts, rot) + tr
    vp0 = rz.project_perspective(vt0, targets.K_rois)

    cap, worst, act_cap, n_act = counted_caps(vp0, faces, s)
    out(f"[counted per-tile face cap {cap} (worst load {worst}); active-tile cap {act_cap} "
        f"(worst {n_act})]")
    ms = {}

    def piece(label, fn, key=None):
        ms[key or label.strip()] = t = timeit(fn, dev, n)
        out(f"{label + ':':<28}{t:8.2f} ms")

    def grad_of(loss_fn, *leaves):
        xs = [x.detach().clone().requires_grad_(True) for x in leaves]
        loss_fn(*xs).backward()

    x8 = f"x{b}"
    with torch.no_grad():
        piece(f"bin_faces {x8} fwd", lambda: bin_faces(vp0, faces, (s, s), 16, cap, 3.0).indices)

    def fused(v, act=None):
        frag, sil, _ = rasterize_silhouette(v, faces, (s, s), max_faces=cap, max_active_tiles=act)
        return sil.sum() + frag.bary.sum()

    with torch.no_grad():
        piece(f"fused raster+sil {x8} fwd", lambda: fused(vp0))
    piece(f"fused raster+sil {x8} f+b", lambda: grad_of(fused, vp0))
    piece("  + active-tile compaction", lambda: grad_of(lambda v: fused(v, act_cap), vp0),
          key="fused raster+sil f+b, active-tile compaction")

    def old(v):
        frag = rasterize_tiled(v, faces, (s, s), max_faces=cap)
        sil = soft_silhouette_kernel(v, faces, (s, s), max_faces=cap)
        return sil.sum() + frag.bary.sum()

    before = (kernels.sil_mass_fwd.launches, kernels.sil_mass_bwd.launches)
    with torch.no_grad():
        piece(f"OLD separate {x8} fwd", lambda: old(vp0))
    piece(f"OLD separate {x8} f+b", lambda: grad_of(old, vp0))
    launches = {"K4a": kernels.sil_mass_fwd.launches - before[0],
                "K4b": kernels.sil_mass_bwd.launches - before[1]}

    edge = dcfg.smaller_edge_size

    def shade(vt, vp):
        vn = rz.compute_vertex_normals(vt, faces)
        frag, _, _ = rasterize_silhouette(vp, faces, (s, s), max_faces=cap)
        rgba = phong_shade(frag, faces, vt, vn, mesh.face_uvs, mesh.texture, fine_lights(dev))
        rgb = rgba[..., :3].permute(0, 3, 1, 2)
        return resize_bicubic_align_corners(rgb, edge, edge).sum()

    piece(f"raster+phong+resize {x8} f+b", lambda: grad_of(shade, vt0, vp0))

    dp16 = D.map_params(D.init_params(dcfg, torch.Generator().manual_seed(0)),
                        lambda a: a.to(dev, torch.bfloat16))
    imgs = torch.rand((b, 3, edge, edge), generator=torch.Generator().manual_seed(2)).to(dev)
    piece(f"ViT-B/14 {x8} fwd+bwd bf16",
          lambda: grad_of(lambda x: D.forward_tokens(dp16, x.to(torch.bfloat16), dcfg).float().sum(), imgs))

    cfg = RF.RefineConfig(num_iterations=1, crop_size=s, mode="fine", max_faces_per_tile=cap,
                          max_active_tiles=act_cap)

    def step():
        # One Adam step from the same poses each call, as the JAX tool's
        # step(params, ost) is timed on fixed inputs.
        r, t = r6.clone().requires_grad_(True), tr.clone().requires_grad_(True)
        opt = torch.optim.Adam([r, t], lr=0.01)
        losses, _, _ = RF._frame_loss(r, t, mesh, targets, dp16, dcfg, cfg)
        losses.sum().backward()
        opt.step()

    t = timeit(step, dev, max(n // 2, 1))
    ms["FULL fine step (fused)"] = t
    out(f"FULL fine step {x8} (fused):  {t:8.2f} ms  -> {b / (t / 1000.0) / 100.0:.3f} "
        "frames/s @100 iters")
    return {"ms": ms, "caps": (cap, act_cap), "old_separate_launches": launches}


def main() -> None:
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(dev), flush=True)
    run(dev, out=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
