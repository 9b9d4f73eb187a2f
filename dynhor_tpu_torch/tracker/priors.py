"""Prior-view rendering and DINO scoring, chunk by chunk (PyTorch).

Port of ``dynhor_tpu/tracker/priors.py``.  Behavioral reference:
ObjTracker/utils/render.py:125-285 (6,000 random, or azimuth x elevation x
roll grid, Phong renders of the template mesh at 384², distance 3.5 x
radius) and pose_initializtion.py:188-246, 294-297 (per-view square crop
-> 256² -> DINO features -> masked cosine against every frame).

Each chunk of views runs the whole chain on the device: one K3 launch
rasters the chunk (``ops/raster_fused.rasterize_depth``), then Phong
shading, the mask-driven crop, the ViT and the cosine against all frames;
only the (F, N) score matrix survives.  Views are rendered in a central
window with a principal-point-shifted K, pixel-identical to the full frame
followed by a crop.  The two-stage retrieval (``prior_scores_two_stage``)
prescreens every view at half resolution and rescores each frame's top
candidates at full resolution; its ranking and calibration stay in numpy
on the host, as in the reference.  ``with_sil`` adds the silhouette-IoU
channel of multi-hypothesis init: each view's crop mask at SIL_RES² against
the frames' masks, in the same chunk as its K3 launch.

Not ported here (ROADMAP): ``view_mesh`` sharding.  PyTorch has no static
shapes, so a short last chunk needs no identity padding views.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..models import dino as dino_mod
from ..ops import rasterize as rz
from ..ops.raster_fused import rasterize_depth
from ..ops.rasterize_tiled import max_tile_load
from ..ops.resize import resize_nearest
from ..ops.roi_align import crop_and_resize
from ..ops.shading import default_lights, phong_shade
from ..parallel import mesh as PM
from ..utils import bbox as bboxu
from ..utils import geometry as G
from ..utils import profiling as PF
from ..utils.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Prior rendering knobs (the reference hard-codes most of them)."""

    num_views: int = 6000  # run.py:132
    render_h: int = 384  # constants.py:4
    render_w: int = 384
    distance_scale: float = 3.5  # run.py:133
    focal_ndc: float = 1.0  # PyTorch3D PerspectiveCameras default focal
    crop_size: int = 256  # constants.py:2 REND_SIZE
    bbox_expansion: float = 0.3  # constants.py:3
    view_chunk: int = 25
    # Per-tile face cap of the prior raster; prior_scores_batched counts the
    # cap its views need and uses that instead.
    max_faces_per_tile: int = 1280
    grid: tuple[int, int, int] | None = None  # (azimuth, elevation, roll)
    # ViT compute dtype of the prior and frame features (forward only).
    dino_dtype: str = "bfloat16"


# Side of the square grid that the silhouette-IoU channel compares at: the
# prior view's crop mask and the frame's crop mask, both square boxes around
# the object's tight bbox with the same expansion, nearest-downsampled to
# SIL_RES² (a scale-normalized shape similarity).
SIL_RES = 32


def frame_sil_masks(target_masks: Tensor) -> Tensor:
    """(F, SIL_RES²) {0,1} object masks of the frames' tri-valued crop
    targets (F, S, S), the frame side of the silhouette-IoU channel."""
    m = resize_nearest((target_masks > 0).float(), SIL_RES, SIL_RES)
    return m.reshape(m.shape[0], -1)


def mesh_radius_center(verts: Tensor) -> tuple[Tensor, Tensor]:
    """radius = max |coordinate| of the bbox; center = bbox center
    (render.py:128-130)."""
    vmin = verts.amin(0)
    vmax = verts.amax(0)
    radius = torch.maximum(vmin.abs(), vmax.abs()).max()
    return radius, (vmin + vmax) / 2.0


def mesh_norm_radius(verts: Tensor) -> Tensor:
    """Max vertex 2-norm from the bbox center (the silhouette bound of
    ``compute_window``)."""
    center = (verts.amin(0) + verts.amax(0)) / 2.0
    return torch.linalg.norm(verts - center, dim=1).max()


def prior_camera(cfg: PriorConfig, device=None) -> Tensor:
    """Full-frame pixel intrinsics of the prior renders (PyTorch3D NDC
    focal -> pixels: f = focal_ndc * min(H, W) / 2, principal point at the
    image center)."""
    f = cfg.focal_ndc * min(cfg.render_h, cfg.render_w) / 2.0
    return torch.tensor(
        [[f, 0.0, cfg.render_w / 2.0], [0.0, f, cfg.render_h / 2.0], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def _window_camera(cfg: PriorConfig, window: int, device) -> Tensor:
    """``prior_camera`` with the principal point moved into the central
    ``window``-sided square."""
    off_x = (cfg.render_w - window) / 2.0
    off_y = (cfg.render_h - window) / 2.0
    shift = torch.tensor(
        [[0.0, 0.0, off_x], [0.0, 0.0, off_y], [0.0, 0.0, 0.0]], device=device
    )
    return prior_camera(cfg, device) - shift


def compute_window(cfg: PriorConfig, radius: float, distance: float) -> int:
    """Side of the central square window that holds the silhouette plus the
    bbox padding and expansion, rounded up to a multiple of 8.

    ``radius`` must bound the vertex 2-norm from the mesh center
    (``mesh_norm_radius``), not the per-axis radius of the camera distance.
    """
    f = cfg.focal_ndc * min(cfg.render_h, cfg.render_w) / 2.0
    if distance <= radius:
        return min(cfg.render_h, cfg.render_w)
    pix_r = f * radius / math.sqrt(max(distance**2 - radius**2, 1e-9))
    # +5 px bbox pad (run.py:37-40), x(1+expansion) square growth, margin.
    half = (pix_r + 8.0) * (1.0 + cfg.bbox_expansion) + 8.0
    side = int(math.ceil(2.0 * half / 8.0) * 8)
    return min(side, min(cfg.render_h, cfg.render_w))


def prior_view_rotations(
    cfg: PriorConfig, generator: torch.Generator | None = None
) -> Tensor:
    """World-to-camera rotations of all prior views (N, 3, 3) on the CPU.

    Random mode (``cfg.grid`` None): uniform on SO(3) (render.py:56-93
    Avro'92), drawn from ``generator``.  Grid mode: the azimuth x elevation
    look-at grid, each view rolled in the camera frame (render.py:95-123,
    221-234); it draws nothing."""
    if cfg.grid is None:
        return G.random_rotations(cfg.num_views, generator)
    na, ne, nr = cfg.grid
    base = G.spherical_camera_rotations(na, ne)  # (na*ne+2, 3, 3)
    rolls = G.roll_matrices(nr)  # (nr, 3, 3)
    # Roll in the camera frame: R' = R_roll @ R.
    return torch.einsum("rij,njk->rnik", rolls, base).reshape(-1, 3, 3)


def _view_translations(R_cv: Tensor, distance: Tensor, center: Tensor) -> Tensor:
    """(C, 3) translations that put the mesh center at (0, 0, distance)."""
    base = torch.cat([torch.zeros(2, device=R_cv.device), distance.reshape(1)])
    return base - torch.einsum("nij,j->ni", R_cv, center)


def _render_views(
    verts: Tensor,
    faces: Tensor,
    face_uvs: Tensor,
    texture: Tensor,
    R_cv: Tensor,
    t_cv: Tensor,
    K_win: Tensor,
    window: int,
    max_faces: int,
):
    """Render a chunk of C prior views in the window: one K3 launch, then
    Phong shading under the reference's prior lights.

    Returns (rgba (C, S, S, 4), zbuf (C, S, S), overflow (C,) int32);
    overflow counts face-tile pairs dropped by the per-tile cap, and nonzero
    means the image (and every score derived from it) is corrupted."""
    verts_cam = verts @ R_cv.transpose(1, 2) + t_cv[:, None]  # (C, V, 3)
    vn = rz.compute_vertex_normals(verts_cam, faces)
    vp = rz.project_perspective(verts_cam, K_win)
    frag, overflow = rasterize_depth(vp, faces, (window, window), max_faces=max_faces)
    img = phong_shade(
        frag, faces, verts_cam, vn, face_uvs, texture, default_lights(verts.device)
    )
    return img, frag.zbuf, overflow


def _crop_view(rgba: Tensor, crop_size: int, bbox_expansion: float):
    """Mask-driven square crops of rendered views (pose_initializtion.py:
    199-218): the alpha mask's tight box (+5 px), squared with expansion,
    ROI-cropped to ``crop_size``; pixels outside the crop mask turn white.

    rgba: (C, S, S, 4).  Returns (crop_img (C, 3, s, s), crop_mask (C, s, s)
    bool, box_xyxy (C, 4))."""
    mask = rgba[..., 3] > 0.5
    box = bboxu.mask_tight_bbox_xyxy(mask, pad=5.0)
    sq_xyxy = bboxu.bbox_wh_to_xy(
        bboxu.make_bbox_square(bboxu.bbox_xy_to_wh(box), bbox_expansion)
    )
    img = rgba[..., :3].permute(0, 3, 1, 2)
    crop_img = crop_and_resize(img, sq_xyxy, crop_size)
    crop_mask = crop_and_resize(mask[:, None].float(), sq_xyxy, crop_size)[:, 0] >= 0.5
    crop_img = torch.where(crop_mask[:, None], crop_img, 1.0)
    return crop_img, crop_mask, sq_xyxy


def _dino_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _dino_feats_of_crops(
    dino_params, dino_cfg, crop_imgs: Tensor, dtype: str = "bfloat16"
) -> Tensor:
    """(B, 3, S, S) crops -> L2-normalized DINO patch tokens (B, P, D) f32
    (pose_initializtion.py:224-226: bicubic to 518, extract, normalize).
    The ViT runs in ``dtype``; the fused resize + normalize + patch-embed
    never materializes the upsampled image."""
    params = dino_mod.map_params(dino_params, lambda a: a.to(_dino_dtype(dtype)))
    feats = dino_mod.forward_tokens_from_crop(params, crop_imgs, dino_cfg).float()
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True).clamp_min(1e-6)


@torch.inference_mode()
def prior_scores_and_rotations(
    dino_params: dict[str, Any],
    dino_cfg: dino_mod.DinoConfig,
    verts: Tensor,
    faces: Tensor,
    face_uvs: Tensor,
    texture: Tensor,
    view_rotations: Tensor,
    gt_feats: Tensor,
    cos_masks: Tensor,
    cfg: PriorConfig,
    window: int,
    with_sil: bool = False,
    sil_masks: Tensor | None = None,
):
    """The (F, N) masked-cosine score matrix of all frames against all
    views, ``cfg.view_chunk`` views at a time, on the tensors' device.

    Args:
      view_rotations: (N, 3, 3) world-to-camera rotations.
      gt_feats: (F, P, D) L2-normalized DINO features of the frame crops.
      cos_masks: (F, P) {0,1} object masks at token resolution.
      window: render window side (``compute_window``).
      with_sil: also return the (F, N) silhouette-IoU matrix: each view's
        crop mask nearest-downsampled to SIL_RES², IoU = inter / max(union,
        1) against ``sil_masks``, computed in the chunk of its K3 launch.
      sil_masks: (F, SIL_RES²) {0,1} frame masks (``frame_sil_masks``),
        required iff with_sil.

    Returns (scores (F, N), overflow () int32, the max over views), or
    (scores, sil (F, N), overflow) when with_sil.
    """
    if with_sil and sil_masks is None:
        raise ValueError("with_sil=True requires sil_masks")
    radius, center = mesh_radius_center(verts)
    distance = cfg.distance_scale * radius
    K_win = _window_camera(cfg, window, verts.device)
    cos_sum = cos_masks.sum(1).clamp_min(1e-6)  # (F,)
    scores, sils, overflow = [], [], []
    for s in range(0, view_rotations.shape[0], cfg.view_chunk):
        R = view_rotations[s : s + cfg.view_chunk]
        with PF.span("prior.render"):
            rgba, _, ov = _render_views(
                verts, faces, face_uvs, texture, R, _view_translations(R, distance, center),
                K_win, window, cfg.max_faces_per_tile,
            )
        with PF.span("prior.crop"):
            crops, crop_masks, _ = _crop_view(rgba, cfg.crop_size, cfg.bbox_expansion)
        with PF.span("prior.vit"):
            feats = _dino_feats_of_crops(dino_params, dino_cfg, crops, cfg.dino_dtype)
        with PF.span("prior.score"):
            sim = torch.einsum("fpd,cpd->fcp", gt_feats, feats)  # cosine per token
            masked = torch.einsum("fcp,fp->fc", sim, cos_masks)
            scores.append(masked / cos_sum[:, None])
            overflow.append(ov.max())
            if with_sil:
                # Sums of {0,1} in f32 are exact, so the IoU is one division.
                m_sil = resize_nearest(crop_masks.float(), SIL_RES, SIL_RES)
                m_sil = m_sil.reshape(m_sil.shape[0], -1)  # (C, SIL_RES²)
                inter = torch.einsum("fp,cp->fc", sil_masks, m_sil)
                union = sil_masks.sum(1)[:, None] + m_sil.sum(1)[None, :] - inter
                sils.append(inter / union.clamp_min(1.0))
    ov_max = torch.stack(overflow).max()
    if with_sil:
        return torch.cat(scores, dim=1), torch.cat(sils, dim=1), ov_max
    return torch.cat(scores, dim=1), ov_max


@torch.inference_mode()
def required_prior_cap(
    verts: Tensor,
    faces: Tensor,
    view_rotations: Tensor,
    cfg: PriorConfig,
    window: int,
    distance: float,
    center: Tensor,
    chunk: int = 500,
    headroom: float = 1.05,
) -> int:
    """Smallest safe ``max_faces_per_tile`` for THESE views (rounded up to
    128): the most margin-0 candidate faces in any tile of any view, times
    ``headroom``.  Edge-on views can pack far more faces into a tile than
    any fixed default.  Reads the device once."""
    with PF.span("prior.cap"):
        K_win = _window_camera(cfg, window, verts.device)
        dist = torch.tensor(distance, dtype=torch.float32, device=verts.device)
        worst = torch.zeros((), dtype=torch.int32, device=verts.device)
        for i in range(0, view_rotations.shape[0], chunk):
            R = view_rotations[i : i + chunk]
            t = _view_translations(R, dist, center)
            vp = rz.project_perspective(verts @ R.transpose(1, 2) + t[:, None], K_win)
            loads = max_tile_load(vp, faces, (window, window), 16, margin=0.0)
            worst = torch.maximum(worst, loads.max())
        cap = int(-(-float(worst) * headroom // 128) * 128)
    return max(128, min(cap, int(faces.shape[0])))


def _place(dev, verts, faces, face_uvs, texture, view_rotations):
    return (
        torch.as_tensor(verts, dtype=torch.float32, device=dev),
        torch.as_tensor(faces, device=dev).long(),
        torch.as_tensor(face_uvs, dtype=torch.float32, device=dev),
        torch.as_tensor(texture, dtype=torch.float32, device=dev),
        torch.as_tensor(view_rotations, dtype=torch.float32, device=dev),
    )


def _place_params(dino_params, dtype: str, dev):
    return dino_mod.map_params(
        dino_params, lambda a: a.detach().to(device=dev, dtype=_dino_dtype(dtype))
    )


def _score_views(dino_params, dino_cfg, verts, faces, face_uvs, texture, view_rotations,
                 gt_feats, cos_masks, cfg: PriorConfig, window: int, with_sil: bool,
                 sil_masks, view_mesh):
    """``prior_scores_and_rotations`` of these views.  With ``view_mesh``,
    each rank renders (K3) and scores its contiguous slice of every chunk
    of ``cfg.view_chunk`` views, and the (F, N) matrices are gathered by a
    sum over the "views" ranks into which each wrote its columns (exact:
    the other ranks add zeros); the overflow is the ranks' maximum.  So
    every rank holds the whole result, as one process computes it."""
    if view_mesh is None:
        return prior_scores_and_rotations(
            dino_params, dino_cfg, verts, faces, face_uvs, texture, view_rotations,
            gt_feats, cos_masks, cfg, window, with_sil, sil_masks,
        )
    index, size = PM.axis_index(view_mesh, "views"), PM.axis_size(view_mesh, "views")
    n = view_rotations.shape[0]
    dev = view_rotations.device
    buf = torch.zeros((2 if with_sil else 1, gt_feats.shape[0], n), device=dev)
    ov = torch.zeros((), dtype=torch.int32, device=dev)
    for c in range(0, n, cfg.view_chunk):
        per = -(-min(cfg.view_chunk, n - c) // size)
        lo, hi = c + index * per, min(c + cfg.view_chunk, n, c + (index + 1) * per)
        if lo >= hi:
            continue
        *mats, ov_c = prior_scores_and_rotations(
            dino_params, dino_cfg, verts, faces, face_uvs, texture, view_rotations[lo:hi],
            gt_feats, cos_masks, dataclasses.replace(cfg, view_chunk=hi - lo), window,
            with_sil, sil_masks,
        )
        for j, m in enumerate(mats):
            buf[j, :, lo:hi] = m
        ov = torch.maximum(ov, ov_c)
    buf = PM.all_reduce(buf, view_mesh, "views")
    return (*buf, PM.all_reduce(ov, view_mesh, "views", op="max"))


def prior_scores_batched(
    dino_params,
    dino_cfg,
    verts,
    faces,
    face_uvs,
    texture,
    view_rotations,
    gt_feats,
    cos_masks,
    cfg: PriorConfig,
    window: int,
    host_batch: int = 1000,
    device: str | torch.device | None = None,
    with_sil: bool = False,
    sil_masks=None,
    view_mesh=None,
):
    """``prior_scores_and_rotations`` over all views in host batches of
    ``host_batch`` views, at a per-tile cap counted for these views.

    The overflow is read once per host batch.  If a batch still overflows,
    every view is rerun at twice the cap (up to the face count), and a
    persisting overflow warns.

    Args: as ``prior_scores_and_rotations``; tensors or arrays on any
    device, moved to ``device`` (None = the CUDA card; "cpu" runs the
    kernels' plain versions).  ``view_mesh``: a ``parallel.mesh`` mesh with
    a "views" axis; each rank then renders and scores its slice of every
    chunk, every input replicated (``_score_views``).

    Returns (F, N) scores on ``device``, or (scores, sil scores) when
    with_sil; the whole matrices on every rank when sharded.
    """
    dev = resolve_device(device)
    verts, faces, face_uvs, texture, view_rotations = _place(
        dev, verts, faces, face_uvs, texture, view_rotations
    )
    dino_params = _place_params(dino_params, cfg.dino_dtype, dev)
    gt_feats = torch.as_tensor(gt_feats, dtype=torch.float32, device=dev)
    cos_masks = torch.as_tensor(cos_masks, dtype=torch.float32, device=dev)
    if sil_masks is not None:
        sil_masks = torch.as_tensor(sil_masks, dtype=torch.float32, device=dev)
    n = view_rotations.shape[0]
    host_batch = min(host_batch, n)
    f_total = int(faces.shape[0])
    radius, center = mesh_radius_center(verts)
    cap = required_prior_cap(
        verts, faces, view_rotations, cfg, window,
        float(cfg.distance_scale * radius), center,
    )
    if cap != cfg.max_faces_per_tile:
        print(f"prior rendering: per-tile face cap {cap} (counted)", flush=True)
    cfg_l = dataclasses.replace(cfg, max_faces_per_tile=cap)
    while True:
        outs = []
        max_ov = 0
        for i in range(0, n, host_batch):
            *mats, ov = _score_views(
                dino_params, dino_cfg, verts, faces, face_uvs, texture,
                view_rotations[i : i + host_batch], gt_feats, cos_masks, cfg_l, window,
                with_sil, sil_masks, view_mesh,
            )
            outs.append(mats)
            max_ov = max(max_ov, int(ov))
        if max_ov == 0 or cfg_l.max_faces_per_tile >= f_total:
            break
        new_cap = min(cfg_l.max_faces_per_tile * 2, f_total)
        PF.count("prior.cap_reruns")
        print(
            f"prior rendering: tile-bin overflow (max {max_ov} dropped) —"
            f" rerunning all views at max_faces_per_tile={new_cap}",
            flush=True,
        )
        cfg_l = dataclasses.replace(cfg_l, max_faces_per_tile=new_cap)
    if max_ov > 0:
        print(
            f"WARNING: tile-bin overflow in prior rendering persists at the"
            f" full-mesh cap ({max_ov} dropped) — scores may be corrupted",
            flush=True,
        )
    cat = tuple(torch.cat([o[j] for o in outs], dim=1) for j in range(len(outs[0])))
    return cat if with_sil else cat[0]


def prior_scores_two_stage(
    dino_params,
    dino_cfg,
    verts,
    faces,
    face_uvs,
    texture,
    view_rotations,
    crop_images,
    target_masks,
    gt_feats,
    cos_masks,
    cfg: PriorConfig,
    window: int,
    host_batch: int = 1000,
    prescreen_edge: int = 112,
    prescreen_scale: int = 2,
    topk: int = 24,
    device: str | torch.device | None = None,
    with_sil: bool = False,
    view_mesh=None,
):
    """Two-stage prior retrieval: a cheap prescreen of ALL views, then a
    full-resolution rescore of the union of each frame's top ``topk``.

      stage A  every view at 1/``prescreen_scale`` of the window and crop,
               DINO at ``prescreen_edge``: a full (F, N) cheap score matrix;
      stage B  full-resolution scores of the union of the per-frame top-k;
      fill     the other entries get per-frame affine-calibrated prescreen
               scores (least squares of full on prescreen over the rescored
               views), clamped strictly below the frame's rescored minimum,
               so the gate's top-k are full-resolution scores.

    Ranking and calibration run in numpy on the host, on the f32 scores.

    Args:
      crop_images: (F, 3, S, S) frame crops in [0, 1].
      target_masks: (F, S, S) tri-valued masks.
      gt_feats/cos_masks: full-resolution frame features (stage B).
      device: None = the CUDA card; "cpu" runs the plain versions.
      with_sil: also return the (F, N) silhouette-IoU matrix, from the
        prescreen pass (the SIL_RES grid does not depend on the render's
        resolution).
      view_mesh: shards both stages' views over its "views" ranks
        (``prior_scores_batched``); the gathered scores are ranked, so
        every rank makes the same choices.

    Returns (F, N) scores on the full-resolution scale, on ``device`` (and
    the sil scores if with_sil).
    """
    dev = resolve_device(device)
    n = int(view_rotations.shape[0])
    f_frames = int(gt_feats.shape[0])
    common = (dino_params, dino_cfg, verts, faces, face_uvs, texture)
    sil_masks = None
    if with_sil:
        sil_masks = frame_sil_masks(torch.as_tensor(target_masks, device=dev))
    # Prescreen only pays off when it prunes: below ~2 candidate sets'
    # worth of views, score everything at full resolution directly.
    if n <= 2 * topk * max(f_frames, 1) or n <= 4 * topk:
        return prior_scores_batched(
            *common, view_rotations, gt_feats, cos_masks, cfg, window, host_batch, dev,
            with_sil=with_sil, sil_masks=sil_masks, view_mesh=view_mesh,
        )

    # ---- stage A: low-resolution prescreen of all N views ----
    PF.count("prior.views_prescreened", n)
    with PF.span("prior.prescreen"):
        cfg_lo = dataclasses.replace(
            cfg,
            render_h=cfg.render_h // prescreen_scale,
            render_w=cfg.render_w // prescreen_scale,
            crop_size=cfg.crop_size // prescreen_scale,
            view_chunk=cfg.view_chunk * prescreen_scale,
        )
        dino_cfg_lo = dataclasses.replace(dino_cfg, smaller_edge_size=prescreen_edge)
        verts_t = torch.as_tensor(verts, dtype=torch.float32, device=dev)
        radius, _ = mesh_radius_center(verts_t)
        window_lo = compute_window(
            cfg_lo, float(mesh_norm_radius(verts_t)), float(cfg_lo.distance_scale * radius)
        )
        gt_feats_lo, cos_masks_lo = frame_gt_features(
            dino_params, dino_cfg_lo, crop_images, target_masks, cfg.dino_dtype, dev
        )
        out_lo = prior_scores_batched(
            dino_params, dino_cfg_lo, verts, faces, face_uvs, texture, view_rotations,
            gt_feats_lo, cos_masks_lo, cfg_lo, window_lo, host_batch, dev,
            with_sil=with_sil, sil_masks=sil_masks, view_mesh=view_mesh,
        )
        scores_lo, sil_scores = out_lo if with_sil else (out_lo, None)
        scores_lo_np = scores_lo.cpu().numpy()

    # ---- stage B: full-resolution rescore of the per-frame top-K union ----
    with PF.span("prior.rescore"):
        k = min(topk, n)
        top_idx = np.argpartition(-scores_lo_np, k - 1, axis=1)[:, :k]
        idx = np.unique(top_idx.reshape(-1))
        PF.count("prior.views_rescored", idx.size)
        rots = torch.as_tensor(view_rotations)[torch.as_tensor(idx)]
        sub = prior_scores_batched(
            *common, rots, gt_feats, cos_masks, cfg, window, host_batch, dev, view_mesh=view_mesh
        )
        sub_np = sub.cpu().numpy()  # (F, |idx|)

    # ---- per-frame affine calibration of the non-rescored tail ----
    with PF.span("prior.calibrate"):
        lo_sub = scores_lo_np[:, idx]
        lo_mu = lo_sub.mean(axis=1, keepdims=True)
        hi_mu = sub_np.mean(axis=1, keepdims=True)
        lo_c = lo_sub - lo_mu
        denom = (lo_c * lo_c).sum(axis=1, keepdims=True)
        a = np.where(
            denom > 1e-12, ((sub_np - hi_mu) * lo_c).sum(axis=1, keepdims=True)
            / np.maximum(denom, 1e-12), 1.0,
        )
        b = hi_mu - a * lo_mu
        scores = a * scores_lo_np + b
        # The fill sits strictly below each frame's rescored minimum: the gate's
        # top-k come from full-resolution scores by construction, while its
        # max/std statistics stay on the full-resolution scale.
        scores = np.minimum(scores, sub_np.min(axis=1, keepdims=True) - 1e-4)
        scores[np.arange(f_frames)[:, None], idx[None, :]] = sub_np
        if with_sil:
            return torch.as_tensor(scores, device=dev), sil_scores
        return torch.as_tensor(scores, device=dev)


def render_mesh_opencv_pose(
    verts,
    faces,
    face_uvs,
    texture,
    R_cv,
    t_cv,
    K,
    h: int,
    w: int,
    face_chunk: int = 512,
    device: str | torch.device | None = None,
) -> tuple[Tensor, Tensor]:
    """Render a mesh under an explicit OpenCV pose (the parity surface of
    ObjTracker/utils/render.py:193-219 render_mesh_opencv_pose): the dense
    hard raster, Phong shading under the prior views' lights.

    Args: verts (V, 3), faces (F, 3), face_uvs (F, 3, 2), texture (Ht, Wt,
    3), R_cv (3, 3), t_cv (3,), K (3, 3) pixel intrinsics; tensors or
    arrays.  device: None = the CUDA card; "cpu" runs on the CPU.

    Returns (rgba (H, W, 4), depth (H, W) with -1 background) on ``device``.
    """
    dev = resolve_device(device)

    def put(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    faces = torch.as_tensor(faces, device=dev).long()
    verts_cam = (put(verts) @ put(R_cv).T + put(t_cv))[None]  # (1, V, 3)
    vn = rz.compute_vertex_normals(verts_cam, faces)
    vp = rz.project_perspective(verts_cam, put(K))
    frag = rz.rasterize(vp, faces, (h, w), face_chunk=face_chunk)
    img = phong_shade(
        frag, faces, verts_cam, vn, put(face_uvs), put(texture), default_lights(dev)
    )
    return img[0], frag.zbuf[0]


def frame_gt_features(
    dino_params,
    dino_cfg,
    crop_images,
    target_masks,
    dino_dtype: str = "bfloat16",
    device: str | torch.device | None = None,
) -> tuple[Tensor, Tensor]:
    """Per-frame DINO features and token-resolution cosine masks
    (pose_initializtion.py:286-294: crop bicubic -> 518, extract,
    normalize; mask > 0 nearest -> 37²).

    Args:
      crop_images: (F, 3, S, S) in [0, 1].
      target_masks: (F, S, S) tri-valued {-1, 0, 1}.
      device: None = the CUDA card; "cpu" runs on the CPU.

    Returns (gt_feats (F, P, D), cos_masks (F, P)) on ``device``.
    """
    with PF.span("prior.frame_features"):
        dev = resolve_device(device)
        params = _place_params(dino_params, dino_dtype, dev)
        crops = torch.as_tensor(crop_images, dtype=torch.float32, device=dev)
        masks = torch.as_tensor(target_masks, dtype=torch.float32, device=dev)
        with torch.inference_mode():
            feats = _dino_feats_of_crops(params, dino_cfg, crops, dino_dtype)
        fs = dino_cfg.feat_size
        cos = resize_nearest((masks > 0).float(), fs, fs)
        # A copy made outside inference mode: the refine's loss saves the frame
        # features for its backward.
        return feats.clone(), cos.reshape(cos.shape[0], -1)
