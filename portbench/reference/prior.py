"""Plain reference of the tracker's two-stage prior scoring.

A view is the template mesh under a world-to-camera rotation, its centre
``distance_scale`` x its radius in front of the camera, rendered with the
prior lights in a central square window of the render (principal point
moved into it); its crop is the alpha mask's box (+5 px, clamped), squared
and grown by ``bbox_expansion``, ROI-aligned (half-pixel, 2 x 2 samples a
bin) to the crop size, white outside the crop's own mask.  Its score
against a frame is the mean over the frame's object tokens of the cosine
between the frame's and the view's L2-normalized ViT tokens.

Two stages: every view at half the render, crop and chunk, with the ViT at
``prescreen_edge`` (the low scores), then the union of each frame's
``topk`` views at full resolution.  Every other entry gets the frame's
low score mapped by the least-squares line from low to full scores over
the rescored views, kept 1e-4 below the frame's lowest rescored score.
Plain PyTorch and NumPy; this file imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import raster as RR
from . import shading as RS
from . import vit as RV

Tensor = torch.Tensor


def radius_center(verts: Tensor):
    """Per-axis radius (the largest |coordinate| of the box) and box centre."""
    vmin, vmax = verts.amin(0), verts.amax(0)
    return torch.maximum(vmin.abs(), vmax.abs()).max(), (vmin + vmax) / 2.0


def window_side(render: int, expansion: float, verts: Tensor, distance_scale: float) -> int:
    """Side of the central window that holds the silhouette with the box's
    padding and growth, a multiple of 8."""
    radius, center = radius_center(verts)
    norm_r = float(torch.linalg.norm(verts - center, dim=1).max())
    distance = float(distance_scale * radius)
    f = render / 2.0
    if distance <= norm_r:
        return render
    pix_r = f * norm_r / math.sqrt(max(distance**2 - norm_r**2, 1e-9))
    half = (pix_r + 8.0) * (1.0 + expansion) + 8.0
    return min(int(math.ceil(2.0 * half / 8.0) * 8), render)


def project_views(mesh, R_cv: Tensor, render: int, window: int, distance_scale: float):
    """(camera-space vertices, projected (u, v, z)) of C views, each (C, V, 3):
    the mesh's box centre ``distance_scale`` x its radius ahead, the
    principal point moved into the central window."""
    radius, center = radius_center(mesh.verts)
    dist = distance_scale * radius
    t = torch.cat([torch.zeros(2, device=R_cv.device), dist.reshape(1)]) - R_cv @ center
    verts_cam = mesh.verts @ R_cv.transpose(1, 2) + t[:, None]
    f, off = render / 2.0, (render - window) / 2.0
    K = torch.tensor([[f, 0.0, render / 2.0 - off], [0.0, f, render / 2.0 - off], [0, 0, 1.0]],
                     device=R_cv.device)
    return verts_cam, RS.project(verts_cam, K.expand(R_cv.shape[0], 3, 3))


def render_views(mesh, tex, R_cv: Tensor, render: int, window: int, distance_scale: float):
    """RGBA (C, window, window, 4) of C views."""
    verts_cam, vp = project_views(mesh, R_cv, render, window, distance_scale)
    p2f, _ = RR.hard_raster(vp, mesh.faces, (window, window))
    return RS.shade(p2f, vp, verts_cam, mesh.faces, mesh.face_uvs, tex, RS.PRIOR_LIGHTS,
                    (window, window))


def _axis_weights(start: Tensor, length: Tensor, out: int, ratio: int, size: int) -> Tensor:
    """(N, out * ratio, size) bilinear sampling weights along one axis."""
    i = torch.arange(out * ratio, device=start.device)
    binsz = (length / out)[:, None]
    pos = start[:, None] + (i // ratio) * binsz + ((i % ratio) + 0.5) * (binsz / ratio)
    valid = (pos >= -1.0) & (pos <= size)
    p = pos.clamp_min(0.0)
    i0 = torch.floor(p).clamp_max(size - 1).long()
    frac = torch.where(i0 >= size - 1, 0.0, p - i0)
    i1 = (i0 + 1).clamp_max(size - 1)
    w = torch.zeros((start.shape[0], out * ratio, size), device=start.device)
    w.scatter_add_(2, i0[..., None], torch.where(valid, 1.0 - frac, 0.0)[..., None])
    w.scatter_add_(2, i1[..., None], torch.where(valid, frac, 0.0)[..., None])
    return w


def roi_align(img: Tensor, boxes: Tensor, out: int, ratio: int = 2) -> Tensor:
    """(N, C, H, W) images, (N, 4) xyxy boxes -> (N, C, out, out)."""
    n, c, h, w = img.shape
    wy = _axis_weights(boxes[:, 1] - 0.5, boxes[:, 3] - boxes[:, 1], out, ratio, h)
    wx = _axis_weights(boxes[:, 0] - 0.5, boxes[:, 2] - boxes[:, 0], out, ratio, w)
    s = torch.einsum("nyh,nchw,nxw->ncyx", wy, img, wx)
    return s.reshape(n, c, out, ratio, out, ratio).mean((3, 5))


def crop_views(rgba: Tensor, crop: int, expansion: float):
    """(crops (C, 3, crop, crop), crop masks (C, crop, crop)) of rendered views."""
    mask = rgba[..., 3] > 0.5
    h, w = mask.shape[1:]
    rows, cols = mask.any(-1), mask.any(-2)
    big = 1 << 30
    r_idx, c_idx = torch.arange(h, device=mask.device), torch.arange(w, device=mask.device)
    y1 = (torch.where(rows, r_idx, big).amin(-1).float() - 5.0).clamp_min(0.0)
    y2 = (torch.where(rows, r_idx, -big).amax(-1).float() + 5.0).clamp_max(float(h))
    x1 = (torch.where(cols, c_idx, big).amin(-1).float() - 5.0).clamp_min(0.0)
    x2 = (torch.where(cols, c_idx, -big).amax(-1).float() + 5.0).clamp_max(float(w))
    cx, cy = x1 + (x2 - x1) / 2.0, y1 + (y2 - y1) / 2.0
    side = torch.maximum(x2 - x1, y2 - y1) * (1.0 + expansion)
    bx, by = cx - side / 2.0, cy - side / 2.0
    boxes = torch.stack([bx, by, bx + side, by + side], -1)
    crops = roi_align(rgba[..., :3].permute(0, 3, 1, 2), boxes, crop)
    cmask = roi_align(mask[:, None].float(), boxes, crop)[:, 0] >= 0.5
    return torch.where(cmask[:, None], crops, 1.0), cmask


def frame_features(params, vit, crops: Tensor, target_masks: Tensor, edge: int, quant=None):
    """(normalized tokens (F, P, D), object masks at token resolution (F, P))."""
    feats = RV.normalized_tokens(params, crops, vit, edge, quant)
    g = edge // vit["patch_size"]
    cos = F.interpolate((target_masks > 0).float()[:, None], size=(g, g), mode="nearest")
    return feats, cos.reshape(cos.shape[0], -1)


@torch.no_grad()
def view_scores(params, vit, mesh, tex, R_cv, gt, cos, render, crop, window, edge, expansion,
                distance_scale, quant=None, batch=250) -> Tensor:
    """(F, C) scores of C views against the frames' features."""
    out = []
    for i in range(0, R_cv.shape[0], batch):
        rgba = render_views(mesh, tex, R_cv[i:i + batch], render, window, distance_scale)
        crops, _ = crop_views(rgba, crop, expansion)
        feats = RV.normalized_tokens(params, crops, vit, edge, quant)
        sim = torch.einsum("fpd,cpd->fcp", gt, feats)
        out.append(torch.einsum("fcp,fp->fc", sim, cos) / cos.sum(1).clamp_min(1e-6)[:, None])
    return torch.cat(out, 1)


@torch.no_grad()
def two_stage(params, vit, mesh, tex, R_cv, crops, target_masks, prior: dict,
              union: np.ndarray | None = None, quant=None) -> dict:
    """The reference's low scores of every view (F, N), full scores of the
    views ``union`` (F, |union|) and the filled matrix (F, N) built on that
    union; with no ``union``, the union of each frame's ``topk`` low scores."""
    exp, ds, s = prior["bbox_expansion"], prior["distance_scale"], prior["prescreen_scale"]
    render, crop = prior["render_hw"], prior["crop_size"]
    lo_edge = prior["prescreen_edge"]
    gt_lo, cos_lo = frame_features(params, vit, crops, target_masks, lo_edge, quant)
    win_lo = window_side(render // s, exp, mesh.verts, ds)
    lo = view_scores(params, vit, mesh, tex, R_cv, gt_lo, cos_lo, render // s, crop // s, win_lo,
                     lo_edge, exp, ds, quant)
    if union is None:
        k = min(prior["topk"], lo.shape[1])
        union = np.unique(torch.topk(lo, k, dim=1).indices.cpu().numpy().reshape(-1))
    edge = vit["smaller_edge_size"]
    gt, cos = frame_features(params, vit, crops, target_masks, edge, quant)
    win = window_side(render, exp, mesh.verts, ds)
    idx = torch.as_tensor(union, device=R_cv.device)
    full = view_scores(params, vit, mesh, tex, R_cv[idx], gt, cos, render, crop, win, edge, exp, ds,
                       quant, batch=50)
    lo_np, full_np = lo.cpu().numpy(), full.cpu().numpy()
    return {"lo": lo_np, "full": full_np, "filled": fill(lo_np, full_np, union)}


def fill(lo: np.ndarray, full: np.ndarray, union: np.ndarray) -> np.ndarray:
    """Low scores mapped per frame by the least-squares line from low to
    full over ``union``, clamped 1e-4 below the frame's lowest full score;
    the union's entries are its full scores."""
    lo_u = lo[:, union]
    lo_mu, hi_mu = lo_u.mean(1, keepdims=True), full.mean(1, keepdims=True)
    lo_c = lo_u - lo_mu
    denom = (lo_c * lo_c).sum(1, keepdims=True)
    a = np.where(denom > 1e-12, ((full - hi_mu) * lo_c).sum(1, keepdims=True)
                 / np.maximum(denom, 1e-12), 1.0)
    out = np.minimum(a * lo + (hi_mu - a * lo_mu), full.min(1, keepdims=True) - 1e-4)
    out[:, union] = full
    return out
