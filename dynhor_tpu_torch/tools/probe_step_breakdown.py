"""Breakdown of the 8-frame fine refine step: the ViT's forward and
backward alone, a coarse-mode step and a fine step.

    python -m dynhor_tpu_torch.tools.probe_step_breakdown

Twin of ``tools/probe_step_breakdown.py``: the shoes mesh at a 256² crop,
8 frames at seeded random rotations at depth 1.75, target masks from the
hard raster at those poses, random unit ViT targets, a random-weight
ViT-B/14 in bf16; the per-tile face cap and the active-tile cap counted at
those poses as the JAX tool counts them (the worst frame x 1.5, the cap
rounded up to 128, at least 256, at most the face count; the tile cap up
to 8).  ``pieces`` builds the three callables (each step one Adam step from
the same poses, as the JAX tool times its step on fixed inputs, returning
the stepped rot6d and translations); ``run`` times them on the card by CUDA
events.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import dino as D
from ..ops import rasterize as rz
from ..ops.rasterize_tiled import max_active_tiles_load, max_tile_load
from ..tracker import refine as RF
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.objio import load_obj
from ._timing import first_and_mean_ms

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"
FRAMES = 8
CROP = 256


def counted_caps(vp, faces, s: int, sigma: float = 0.25) -> tuple[int, int]:
    """(per-tile face cap, active-tile cap) at the silhouette's margin."""
    margin = 6.0 * sigma + 1.0
    loads = int(max_tile_load(vp, faces, (s, s), 16, margin).max())
    actives = int(max_active_tiles_load(vp, faces, (s, s), 16, margin).max())
    cap = max(256, min(-(-int(loads * 1.5) // 128) * 128, int(faces.shape[0])))
    return cap, max(8, -(-int(actives * 1.5) // 8) * 8)


def scene(device, frames: int = FRAMES, crop: int = CROP, dcfg: D.DinoConfig = D.DinoConfig(),
          obj: str = SHOES):
    """(mesh, targets, rot (B, 3, 3), trans (B, 3), cap, act_cap)."""
    md = load_obj(obj)
    verts = G.center_and_normalize_verts(torch.as_tensor(md.verts)).to(device)
    mesh = RF.MeshArrays(verts, torch.as_tensor(md.faces).long().to(device),
                         torch.as_tensor(md.face_uvs).to(device),
                         torch.as_tensor(md.texture).to(device))
    s = crop
    K = torch.tensor([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1.0]], device=device)
    rng = np.random.default_rng(0)
    rot = G.rotations_from_uniforms(
        torch.as_tensor(rng.random((3, frames), dtype=np.float32))).to(device)
    trans = torch.tensor([[0.0, 0.0, 1.75]], device=device).repeat(frames, 1)
    vp = rz.project_perspective(torch.einsum("vj,bjk->bvk", verts, rot) + trans[:, None], K)
    with torch.no_grad():
        masks = (rz.rasterize(vp, mesh.faces, (s, s), face_chunk=512).pix_to_face >= 0).float()
    gen = torch.Generator().manual_seed(1)
    gt = torch.randn((frames, dcfg.feat_size**2, dcfg.embed_dim), generator=gen)
    gt = (gt / torch.linalg.norm(gt, dim=-1, keepdim=True)).to(device)
    targets = RF.FrameTargets(masks, gt, K.expand(frames, 3, 3))
    cap, act = counted_caps(vp, mesh.faces, s)
    return mesh, targets, rot, trans, cap, act


def step_config(mode: str, crop: int, cap: int, act: int) -> RF.RefineConfig:
    return RF.RefineConfig(num_iterations=1, crop_size=crop, mode=mode, face_chunk=512,
                           max_faces_per_tile=cap, max_active_tiles=act)


def pieces(device, frames: int = FRAMES, crop: int = CROP,
           dcfg: D.DinoConfig = D.DinoConfig(), obj: str = SHOES) -> dict:
    """{name: fn} of the three pieces and, under "_scene", what they ran on."""
    mesh, targets, rot, trans, cap, act = scene(device, frames, crop, dcfg, obj)
    dp16 = D.map_params(D.init_params(dcfg, torch.Generator().manual_seed(0)),
                        lambda a: a.to(device, torch.bfloat16))
    rgb = torch.rand((frames, 3, crop, crop), generator=torch.Generator().manual_seed(2)).to(device)

    def vit():
        x = rgb.clone().requires_grad_(True)
        f = D.forward_tokens_from_crop(dp16, x, dcfg, remat="frozen")
        (f.float() ** 2).mean().backward()
        return x.grad

    r6, tr = G.matrix_to_rot6d(rot), trans[:, None, :]

    def step(mode):
        cfg = step_config(mode, crop, cap, act)

        def one():
            r, t = r6.clone().requires_grad_(True), tr.clone().requires_grad_(True)
            opt = torch.optim.Adam([r, t], lr=cfg.lr)
            losses, _, _ = RF._frame_loss(r, t, mesh, targets, dp16 if mode == "fine" else None,
                                          dcfg, cfg)
            losses.sum().backward()
            opt.step()
            return r.detach(), t.detach()

        return one

    return {
        "ViT f+b (fused front, frozen)": vit,
        "coarse step (raster+sil+losses+adam)": step("coarse"),
        "fine step (all)": step("fine"),
        "_scene": (mesh, targets, rot, trans, cap, act, dp16),
    }


def run(device=None, n: int = 10, out=print) -> dict:
    """{piece: {"ms", "first_ms"}} on the card."""
    dev = resolve_device(device)
    ps = pieces(dev)
    *_, cap, act, _ = ps.pop("_scene")
    out(f"[counted caps: {cap} faces a tile, {act} active tiles]")
    res = {}
    for name, fn in ps.items():
        first, ms = first_and_mean_ms(fn, dev, n)
        res[name] = {"ms": ms, "first_ms": first}
        out(f"{name:38s} {ms:7.1f} ms  (first call {first / 1e3:5.1f} s)")
    return res


def main(argv: list[str] | None = None) -> dict:
    dev = resolve_device(None)
    print(torch.cuda.get_device_name(dev), flush=True)
    return run(dev, out=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
