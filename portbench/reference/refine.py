"""Plain reference of the fine pose refine: the per-frame loss, its
gradient by autograd and Adam, in float32 throughout.

Per frame (ObjTracker's pose_initializtion.py, as the tracker states it):
``1 - softIoU(keep * silhouette, object) + 1e5 * offscreen + sem``, where
the silhouette is ``1 - exp(-mass)`` of the soft raster, ``keep`` masks the
hand out, and ``sem`` is the object-masked mean of ``1 - cos`` between the
frame crop's ViT tokens and those of the textured Phong render at the same
pose.  The pose is a 6D rotation (two columns, Gram-Schmidt) and a
translation; Adam (0.9, 0.999, 1e-8) at ``lr``.  Frames are independent, so
the reference runs them a few at a time.  Plain PyTorch only; this file
imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import raster as RR
from . import shading as RS
from . import vit as RV

Tensor = torch.Tensor


def rot6d_to_matrix(r: Tensor) -> Tensor:
    a1, a2 = r[..., 0], r[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-12)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.stack((b1, b2, torch.linalg.cross(b1, b2, dim=-1)), dim=-1)


def offscreen(verts_cam: Tensor, K01: Tensor, far: float) -> Tensor:
    """Out-of-frustum penalty (B,): NDC x, y beyond [-1, 1], z behind the
    camera or past ``far``."""
    z = verts_cam[..., 2]
    x, y = verts_cam[..., 0] / (z + 1e-9), verts_cam[..., 1] / (z + 1e-9)
    uv = torch.einsum("bij,bvj->bvi", K01, torch.stack([x, y, torch.ones_like(z)], -1))
    u, v = 2.0 * (uv[..., 0] - 0.5), 2.0 * ((1.0 - uv[..., 1]) - 0.5)
    xy = torch.stack([u, v], -1)
    return (torch.relu(xy - 1.0).sum((-1, -2)) + torch.relu(-1.0 - xy).sum((-1, -2))
            + torch.relu(-z).sum(-1) + torch.relu(z - far).sum(-1))


def frame_loss(rot6d, trans, mesh, tex, target, gt_feats, K_rois, params, cfg, quant=None):
    """Per-frame losses (B,) of a few frames."""
    s = cfg["crop_size"]
    verts = mesh.verts @ rot6d_to_matrix(rot6d) + trans
    ref = (target > 0).float()
    keep = (target >= 0).float()
    vp = RS.project(verts, K_rois)
    sil = 1.0 - torch.exp(-RR.soft_mass(vp, mesh.faces, (s, s), cfg["sigma"]))
    sil = sil.reshape(-1, s, s)
    inter = (keep * sil * ref).sum((-1, -2))
    union = (ref + keep * sil - ref * keep * sil).sum((-1, -2))
    loss = 1.0 - inter / (union + 1e-6)
    K01 = torch.cat([K_rois[:, :2] / s, K_rois[:, 2:]], 1)
    loss = loss + cfg["offscreen_weight"] * offscreen(verts, K01, cfg["far"])
    p2f, _ = RR.hard_raster(vp.detach(), mesh.faces, (s, s))
    rgba = RS.shade(p2f, vp, verts, mesh.faces, mesh.face_uvs, tex, RS.FINE_LIGHTS, (s, s))
    vit = cfg["vit"]
    feats = RV.tokens_from_crop(params, rgba[..., :3].permute(0, 3, 1, 2), vit,
                                vit["smaller_edge_size"], quant)
    fs = vit["smaller_edge_size"] // vit["patch_size"]
    ref_small = F.interpolate(ref[:, None], size=(fs, fs), mode="nearest").reshape(ref.shape[0], -1)
    cos = (gt_feats * feats).sum(-1) / (
        torch.linalg.norm(gt_feats, dim=-1) * torch.linalg.norm(feats, dim=-1) + 1e-6)
    sem = (ref_small * (1.0 - cos)).sum(-1) / (ref_small.sum(-1) + 1e-6)
    return loss + cfg["lw_sem"] * sem


def run(R_row, t, n_steps, mesh, tex, frames, params, cfg, quant=None, chunk=4):
    """``n_steps`` Adam steps of every frame from (R_row (B, 3, 3), t (B, 3)).

    Returns {"loss": (n_steps, B) each step's loss before its update,
    "grad": the first step's gradients (rot6d (B, 3, 2), trans (B, 1, 3)),
    "rot6d", "trans": the parameters after the last update}."""
    vit = cfg["vit"]
    b = R_row.shape[0]
    with torch.no_grad():
        gt = torch.cat([RV.normalized_tokens(params, frames.crop_images[i:i + chunk], vit,
                                             vit["smaller_edge_size"], quant)
                        for i in range(0, b, chunk)])
    p = [R_row[..., :2].float().clone(), t.reshape(b, 1, 3).float().clone()]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    lr, b1, b2, eps = cfg["lr"], 0.9, 0.999, 1e-8
    losses, first = [], None
    for step in range(1, n_steps + 1):
        grads = [torch.zeros_like(x) for x in p]
        loss = torch.zeros((b,), device=R_row.device)
        for i in range(0, b, chunk):
            sl = slice(i, i + chunk)
            leaves = [x[sl].clone().requires_grad_(True) for x in p]
            li = frame_loss(leaves[0], leaves[1], mesh, tex,
                            frames.target_masks[sl], gt[sl], frames.K_rois[sl], params, cfg, quant)
            gi = torch.autograd.grad(li.sum(), leaves)
            for g, gv in zip(grads, gi):
                g[sl] = gv
            loss[sl] = li.detach()
        losses.append(loss)
        if first is None:
            first = [g.clone() for g in grads]
        for x, g, mi, vi in zip(p, grads, m, v):
            mi.mul_(b1).add_(g, alpha=1 - b1)
            vi.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (vi.sqrt() / (1 - b2**step) ** 0.5).add_(eps)
            x.addcdiv_(mi, denom, value=-lr / (1 - b1**step))
    return {"loss": torch.stack(losses), "grad": first, "rot6d": p[0], "trans": p[1]}
