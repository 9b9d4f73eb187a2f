"""Per-frame pose refinement, batched across the whole video (Adam).

Port of ``dynhor_tpu/tracker/refine.py`` (``refine_poses``).  Behavioral
reference: ObjTracker/pose_initializtion.py — the ObjTracker module
(32-186) and its 100-step Adam loop (347-356).  Loss terms per frame:
  * iou: 1 - soft-IoU of (keep_mask * silhouette) vs the object mask;
  * sem: masked DINO-cosine between the textured Phong render and the
    frame crop's features, gradients THROUGH the frozen ViT (164-184);
  * offscreen: 1e5 x out-of-frustum vertex penalty (119-141).

Every step handles ALL frames at once: the frame axis is a batch axis of
every tensor, so one step runs one fused-raster kernel launch (K1), one ViT
forward/backward over B x 1370 tokens, and one K2 launch in the backward.
The silhouette is ``RefineConfig.silhouette_impl``: "pallas" (the default
through "auto") is the fused raster, its CUDA kernels for tensors on the
card and their plain PyTorch versions for tensors on the CPU; "tiled" and
"dense" are the JAX package's plain rasterizers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models import dino as dino_mod
from ..ops import rasterize as rz
from ..ops.raster_fused import rasterize_silhouette
from ..ops.rasterize_tiled import rasterize_tiled, soft_silhouette_tiled
from ..ops.resize import resize_nearest
from ..ops.shading import fine_lights, phong_shade, phong_shade_tiles
from ..ops.silhouette import soft_silhouette
from ..utils import camera as cam
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.masks import batch_mask_iou

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    num_iterations: int = 100  # configs/custom_shoes.yaml:12
    lr: float = 0.01  # configs/custom_shoes.yaml:13
    crop_size: int = 256  # constants.py:2
    lw_sem: float = 1.0  # pose_initializtion.py:51
    offscreen_weight: float = 1e5  # pose_initializtion.py:154,185
    far: float = 100.0  # neural_renderer Renderer default far plane
    mode: str = "fine"  # "fine" | "coarse" (pose_initializtion.py:349-352)
    sigma: float = 0.25  # soft-silhouette edge band (ours; nr is hard)
    face_chunk: int = 512  # faces per loop step of the dense rasterizers
    # Tile-binned rasterization; False puts the "dense" path's hard raster
    # on the dense ops/rasterize.rasterize.
    use_tiled: bool = True
    tile_size: int = 16
    # Per-tile face cap and active-tile cap of the fused raster, counted
    # per scene (ops/rasterize_tiled.max_tile_load / max_active_tiles_load);
    # max_active_tiles None = dense over all tiles.
    max_faces_per_tile: int = 640
    max_active_tiles: int | None = None
    # Silhouette: "pallas" = the fused raster (K1/K2), "tiled" =
    # rasterize_tiled + soft_silhouette_tiled, "dense" = the hard raster
    # (tiled if use_tiled) + the dense soft_silhouette.  "auto" is "pallas"
    # on every device when use_tiled, else "dense": the fused raster's CPU
    # path is its plain versions, where the JAX package's CPU "auto" picks
    # "tiled".
    silhouette_impl: str = "auto"
    # ViT compute dtype of the sem loss; the backbone is frozen and only the
    # direction of the image gradient matters.
    dino_dtype: str = "bfloat16"


class MeshArrays(NamedTuple):
    verts: Tensor  # (V, 3) canonical (normalized) vertices
    faces: Tensor  # (F, 3) int64
    face_uvs: Tensor  # (F, 3, 2)
    texture: Tensor  # (Ht, Wt, 3)


class FrameTargets(NamedTuple):
    target_masks: Tensor  # (B, S, S) tri-valued {-1, 0, 1}
    gt_feats: Tensor  # (B, P, D) frame DINO features
    K_rois: Tensor  # (B, 3, 3) crop intrinsics in PIXEL units (S-scale)


class RefineResult(NamedTuple):
    rot6d: Tensor  # (B, 3, 2)
    translations: Tensor  # (B, 1, 3)
    final_loss: Tensor  # (B,) — the last step's loss, before its update
    final_iou: Tensor  # (B,)
    # Max face-tile pairs (or active tiles) dropped by a raster in any
    # frame and step (0 = every raster was exact).
    max_overflow: int = 0


def offscreen_penalty(verts_cam: Tensor, K01: Tensor, far: float) -> Tensor:
    """Out-of-frustum penalty (pose_initializtion.py:119-141); (B, V, 3),
    (B, 3, 3) -> (B,)."""
    ndc = cam.project_ndc(verts_cam, K01)
    xy = ndc[..., :2]
    z = ndc[..., 2]
    lower_right = torch.relu(xy - 1.0).sum((-1, -2))
    upper_left = torch.relu(-1.0 - xy).sum((-1, -2))
    behind = torch.relu(-z).sum(-1)
    too_far = torch.relu(z - far).sum(-1)
    return lower_right + upper_left + behind + too_far


def resolve_silhouette_impl(impl: str, use_tiled: bool) -> str:
    """The silhouette implementation that ``impl`` names ("auto" resolves
    to "pallas" when ``use_tiled``, else "dense")."""
    if impl == "auto":
        return "pallas" if use_tiled else "dense"
    if impl not in ("pallas", "tiled", "dense"):
        raise ValueError(f"silhouette_impl must be auto, pallas, tiled or dense, got {impl!r}")
    return impl


def _silhouettes(vp: Tensor, faces: Tensor, cfg: RefineConfig):
    """(Fragments, soft (B, S, S), overflow (B,) int32, CompactTiles or
    None) of the configured silhouette.  The fine mode with an active-tile
    cap also takes the fused raster's compacted tiles, so Phong shading
    runs on active tiles only; the plain paths report no overflow."""
    s = cfg.crop_size
    impl = resolve_silhouette_impl(cfg.silhouette_impl, cfg.use_tiled)
    if impl == "pallas":
        want_compact = cfg.mode == "fine" and cfg.max_active_tiles is not None
        out = rasterize_silhouette(
            vp, faces, (s, s), sigma=cfg.sigma, tile=cfg.tile_size,
            max_faces=cfg.max_faces_per_tile, max_active_tiles=cfg.max_active_tiles,
            return_compact=want_compact,
        )
        return out[0], out[1], out[2], out[3] if want_compact else None
    if impl == "tiled" or cfg.use_tiled:
        frag = rasterize_tiled(vp, faces, (s, s), tile=cfg.tile_size, max_faces=cfg.max_faces_per_tile)
    else:
        frag = rz.rasterize(vp, faces, (s, s), face_chunk=cfg.face_chunk)
    if impl == "tiled":
        soft = soft_silhouette_tiled(
            vp, faces, (s, s), sigma=cfg.sigma, tile=cfg.tile_size,
            max_faces=cfg.max_faces_per_tile,
        )
    else:
        soft = soft_silhouette(vp, faces, (s, s), sigma=cfg.sigma, face_chunk=cfg.face_chunk)
    overflow = torch.zeros((vp.shape[0],), dtype=torch.int32, device=vp.device)
    return frag, soft, overflow, None


def _frame_loss(
    rot6d: Tensor,
    trans: Tensor,
    mesh: MeshArrays,
    targets: FrameTargets,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RefineConfig,
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-frame losses of all B frames given (B, 3, 2) rot6d and (B, 1, 3)
    trans.  Returns (loss (B,), iou (B,) detached, overflow (B,))."""
    s = cfg.crop_size
    R = G.rot6d_to_matrix(rot6d)
    verts_t = mesh.verts @ R + trans  # (B, V, 3) row convention, camera space

    ref_mask = (targets.target_masks > 0).float()
    keep_mask = (targets.target_masks >= 0).float()

    vp = rz.project_perspective(verts_t, targets.K_rois)
    # The soft silhouette is the objective (a consistent value/gradient
    # pair); the reported IoU uses the hard mask (reference loss parity).
    frag, soft, overflow, compact = _silhouettes(vp, mesh.faces, cfg)
    hard = (frag.pix_to_face >= 0).float()
    loss = 1.0 - batch_mask_iou(keep_mask * soft, ref_mask)
    iou = batch_mask_iou(keep_mask * hard, ref_mask)

    K01 = torch.cat([targets.K_rois[:, :2] / s, targets.K_rois[:, 2:]], dim=1)
    loss = loss + cfg.offscreen_weight * offscreen_penalty(verts_t, K01, cfg.far)

    if cfg.mode == "fine":
        vn = rz.compute_vertex_normals(verts_t, mesh.faces)
        lights = fine_lights(device=verts_t.device)
        if compact is not None:
            rgba = phong_shade_tiles(
                compact, (s, s), cfg.tile_size, mesh.faces, verts_t, vn,
                mesh.face_uvs, mesh.texture, lights,
            )
        else:
            rgba = phong_shade(
                frag, mesh.faces, verts_t, vn, mesh.face_uvs, mesh.texture, lights
            )
        rgb = rgba[..., :3].permute(0, 3, 1, 2)  # (B, 3, S, S)
        # Fused resize(518) + ImageNet-normalize + patch-embed: the
        # upsampled image never exists.
        feats = dino_mod.forward_tokens_from_crop(dino_params, rgb, dino_cfg).float()
        fs = dino_cfg.feat_size
        ref_small = resize_nearest(ref_mask, fs, fs).reshape(ref_mask.shape[0], -1)
        gt = targets.gt_feats
        cos = (gt * feats).sum(-1) / (
            torch.linalg.norm(gt, dim=-1) * torch.linalg.norm(feats, dim=-1) + 1e-6
        )
        sem = (ref_small * (1.0 - cos)).sum(-1) / (ref_small.sum(-1) + 1e-6)
        loss = loss + cfg.lw_sem * sem

    return loss, iou.detach(), overflow


def _refine_launch(
    mesh: MeshArrays,
    targets: FrameTargets,
    rot_init_row: Tensor,
    trans_init: Tensor,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RefineConfig,
) -> tuple[RefineResult, Tensor]:
    """cfg.num_iterations Adam steps on device tensors.  Returns the result
    and the max overflow as a device tensor (no host sync in the loop)."""
    b = rot_init_row.shape[0]
    dev = rot_init_row.device
    rot6d = G.matrix_to_rot6d(rot_init_row).float().clone().requires_grad_(True)
    trans = trans_init.reshape(b, 1, 3).float().clone().requires_grad_(True)
    # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt.
    opt = torch.optim.Adam([rot6d, trans], lr=cfg.lr)
    losses = torch.zeros((b,), device=dev)
    ious = torch.zeros((b,), device=dev)
    max_ov = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.num_iterations):
        losses, ious, ov = _frame_loss(
            rot6d, trans, mesh, targets, dino_params, dino_cfg, cfg
        )
        opt.zero_grad(set_to_none=True)
        losses.sum().backward()
        opt.step()
        losses = losses.detach()
        max_ov = torch.maximum(max_ov, ov.max())
    result = RefineResult(rot6d.detach(), trans.detach(), losses, ious)
    return result, max_ov


def refine_poses(
    mesh: MeshArrays,
    targets: FrameTargets,
    rot_init_row: Tensor,
    trans_init: Tensor,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RefineConfig = RefineConfig(),
    iters_per_launch: int = 25,
    device: str | torch.device | None = None,
) -> RefineResult:
    """Refine all frames' poses, batched (independently parameterized).

    Args:
      mesh, targets: tensors (or arrays) on any device; moved to ``device``.
      rot_init_row: (B, 3, 3) row-convention rotation inits.
      trans_init: (B, 3) or (B, 1, 3) translation inits.
      dino_params: ViT parameters (models/dino.py), cast to ``dino_dtype``
        and frozen; unused in coarse mode.
      iters_per_launch: accepted for signature parity with the JAX package,
        whose host-chunked launches work around a TPU watchdog; the port
        runs one plain loop.
      device: None = the CUDA card (raises without one); "cpu" runs the
        kernels' plain versions.

    Returns: RefineResult (row-convention 6D rotations).  The overflow is
    read once, after the loop, and a nonzero value warns.
    """
    del iters_per_launch
    dev = resolve_device(device)

    def put(x, dtype=None):
        return torch.as_tensor(x, device=dev, dtype=dtype)

    mesh = MeshArrays(
        put(mesh.verts, torch.float32), put(mesh.faces, torch.int64),
        put(mesh.face_uvs, torch.float32), put(mesh.texture, torch.float32),
    )
    targets = FrameTargets(*(put(x, torch.float32) for x in targets))
    if dino_params is not None:
        dtype = torch.bfloat16 if cfg.dino_dtype == "bfloat16" else torch.float32
        dino_params = dino_mod.map_params(
            dino_params, lambda a: a.detach().to(device=dev, dtype=dtype)
        )
    result, max_ov = _refine_launch(
        mesh, targets, put(rot_init_row, torch.float32),
        put(trans_init, torch.float32), dino_params, dino_cfg, cfg,
    )
    max_overflow = int(max_ov)
    if max_overflow > 0:
        print(
            f"WARNING: tile-bin overflow DURING refinement (max {max_overflow}"
            " face-tile pairs or active tiles dropped in a step) — count both"
            " caps at the init poses (ops/rasterize_tiled.max_tile_load,"
            " max_active_tiles_load) with headroom",
            flush=True,
        )
    return result._replace(max_overflow=max_overflow)
