"""Joint all-frames temporal optimization (Adam over every frame's pose).

Port of ``dynhor_tpu/tracker/jointopt.py``.  Behavioral reference:
ObjTracker/jointopt.py — Joint_Optimizer (15-91) and joint_optimize
(93-161): all frames' {rot6d, trans} optimized together for 200 Adam steps
with per-group learning rates (rotations x10, jointopt.py:135-141); loss =
lw_sil * (masked silhouette L2 / keep.sum() / num_frames) + lw_smooth *
mean squared vertex velocity (losses.py:66-84); IoU logged as a metric.

The frame axis is a batch axis of every tensor: with ``silhouette_impl``
"pallas" (the default through "auto") one step is one fused-raster launch
(K1) for all frames and one K2 launch in the backward.  The steps run in
host chunks of ``iters_per_launch``; each chunk's per-step scalars are
stacked on the device and read to the host once, at the chunk's end.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..ops import rasterize as rz
from ..ops.raster_fused import rasterize_silhouette
from ..ops.rasterize_tiled import soft_silhouette_tiled
from ..ops.silhouette import soft_silhouette
from ..parallel import mesh as PM
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.masks import batch_mask_iou
from .refine import resolve_silhouette_impl

Tensor = torch.Tensor

HISTORY_KEYS = ("loss", "loss_sil_obj", "loss_smooth_obj", "iou_object", "bin_overflow")


@dataclasses.dataclass(frozen=True)
class JointConfig:
    num_iterations: int = 200  # configs/custom_shoes.yaml:14
    lr: float = 1e-4  # configs/custom_shoes.yaml:15
    rotation_lr_mult: float = 10.0  # jointopt.py:140
    lw_sil_obj: float = 1.0  # configs/custom_shoes.yaml:17
    lw_smooth_obj: float = 10.0  # configs/custom_shoes.yaml:18
    crop_size: int = 256
    sigma: float = 0.25
    face_chunk: int = 512
    optimize_object_scale: bool = False  # jointopt.py:41-48 (off: run.py:159)
    use_tiled: bool = True  # tile-binned rasterization (see tracker/refine.py)
    tile_size: int = 16
    max_faces_per_tile: int = 640
    # Active-tile compaction for the fused raster (see tracker/refine.py).
    max_active_tiles: int | None = None
    silhouette_impl: str = "auto"  # "auto" | "pallas" | "tiled" | "dense"


class JointResult(NamedTuple):
    rot6d: Tensor  # (B, 3, 2) row convention
    translations: Tensor  # (B, 1, 3)
    scale: Tensor  # () |scale| actually applied
    history: dict[str, Tensor]  # per-step scalars (loss terms + iou metric), on the CPU


class _FrameShard(NamedTuple):
    """The frame axis sharded over ``"frames"`` of ``mesh``: the global
    frame count and keep-mask sum, the normalizers of the global means."""

    mesh: Any
    n_frames: int
    keep_sum: Tensor


def _sil_and_smooth(params, verts, faces, K_rois, ref_masks, keep_masks, cfg: JointConfig,
                    shard: _FrameShard | None = None):
    """(l_sil, l_smooth, iou, max overflow) of all B frames.  "pallas" gives
    the fused raster's true hard mask and its overflow; "tiled" and
    "dense" threshold the soft mask at 0.5 for the IoU and report 0.

    With ``shard`` the B frames are this rank's, and each value is this
    rank's term of the global one (the sum over the ranks is the global
    value): the means divide by the global counts, and the smoothness pair
    that straddles the previous rank reads that rank's last frame through
    ``halo_prev``, whose backward returns the pair's gradient to it."""
    rots = G.rot6d_to_matrix(params["rot6d"])  # (B, 3, 3)
    verts_t = params["scale"].abs() * torch.einsum("vj,bjk->bvk", verts, rots) + params["trans"]
    s = cfg.crop_size
    vp = rz.project_perspective(verts_t, K_rois)
    # The soft silhouette is the objective; the hard mask only feeds the
    # logged IoU.
    impl = resolve_silhouette_impl(cfg.silhouette_impl, cfg.use_tiled)
    if impl == "pallas":
        frag, sil, ovs = rasterize_silhouette(
            vp, faces, (s, s), sigma=cfg.sigma, tile=cfg.tile_size,
            max_faces=cfg.max_faces_per_tile, max_active_tiles=cfg.max_active_tiles,
        )
        hard = (frag.pix_to_face >= 0).float()
        ov = ovs.max()
    else:
        if impl == "tiled":
            sil = soft_silhouette_tiled(
                vp, faces, (s, s), sigma=cfg.sigma, tile=cfg.tile_size,
                max_faces=cfg.max_faces_per_tile,
            )
        else:
            sil = soft_silhouette(vp, faces, (s, s), sigma=cfg.sigma, face_chunk=cfg.face_chunk)
        hard = (sil > 0.5).float().detach()
        ov = torch.zeros((), dtype=torch.int32, device=vp.device)
    image = keep_masks * sil
    iou = batch_mask_iou(keep_masks * hard, ref_masks)
    if shard is None:
        # losses.py:66-78: squared residuals over the batch, normalized by
        # keep.sum(), then by the number of frames.
        l_sil = ((image - ref_masks) ** 2).sum() / keep_masks.sum() / verts_t.shape[0]
        l_smooth = ((verts_t[1:] - verts_t[:-1]) ** 2).mean()  # losses.py:80-84
        return l_sil, l_smooth, iou.mean(), ov
    l_sil = ((image - ref_masks) ** 2).sum() / shard.keep_sum / shard.n_frames
    prev = PM.halo_prev(verts_t, shard.mesh, "frames")
    has_prev = float(PM.axis_index(shard.mesh, "frames") > 0)
    sq = ((verts_t[1:] - verts_t[:-1]) ** 2).sum() + has_prev * ((verts_t[0] - prev) ** 2).sum()
    l_smooth = sq / ((shard.n_frames - 1) * verts_t[0].numel())
    return l_sil, l_smooth, iou.sum() / shard.n_frames, ov


class _State(NamedTuple):
    params: dict[str, Tensor]
    opt: torch.optim.Adam


def _init_state(rot_init_row: Tensor, trans_init: Tensor, cfg: JointConfig) -> _State:
    b = rot_init_row.shape[0]
    params = {
        "rot6d": G.matrix_to_rot6d(rot_init_row).float().clone().requires_grad_(True),
        "trans": trans_init.reshape(b, 1, 3).float().clone().requires_grad_(True),
        "scale": torch.ones((), device=rot_init_row.device, requires_grad=cfg.optimize_object_scale),
    }
    # optax.multi_transform: rotations at lr x rotation_lr_mult, the rest at
    # lr; the scale, unless optimized, gets no update at all (set_to_zero),
    # so it stays outside the optimizer.  Adam's defaults are optax's (b1
    # 0.9, b2 0.999, eps 1e-8 outside the sqrt).
    groups = [
        {"params": [params["rot6d"]], "lr": cfg.lr * cfg.rotation_lr_mult},
        {"params": [params["trans"]], "lr": cfg.lr},
    ]
    if cfg.optimize_object_scale:
        groups.append({"params": [params["scale"]], "lr": cfg.lr})
    return _State(params, torch.optim.Adam(groups))


def _joint_launch(
    state: _State, n_iters: int, verts, faces, K_rois, ref_masks, keep_masks, cfg: JointConfig,
    shard: _FrameShard | None = None,
) -> Tensor:
    """``n_iters`` Adam steps on device tensors, updating ``state`` in
    place.  Returns the steps' history as a (n_iters, 5) device tensor (the
    columns in HISTORY_KEYS order), each row taken before its step's
    update; nothing is read to the host.  With ``shard`` the rows are
    reduced over the ranks once, at the end (sums, and the overflow's
    maximum)."""
    rows = []
    for _ in range(n_iters):
        l_sil, l_smooth, iou, ov = _sil_and_smooth(
            state.params, verts, faces, K_rois, ref_masks, keep_masks, cfg, shard
        )
        total = cfg.lw_sil_obj * l_sil + cfg.lw_smooth_obj * l_smooth
        state.opt.zero_grad(set_to_none=True)
        total.backward()
        scale = state.params["scale"]
        if shard is not None and scale.grad is not None:  # one scale for every frame
            scale.grad = PM.all_reduce(scale.grad, shard.mesh, "frames")
        state.opt.step()
        rows.append(torch.stack([
            total.detach(), l_sil.detach(), l_smooth.detach(), iou.detach(), ov.float(),
        ]))
    if not rows:
        return torch.zeros((0, len(HISTORY_KEYS)), device=verts.device)
    hist = torch.stack(rows)
    if shard is None:
        return hist
    return torch.cat([PM.all_reduce(hist[:, :4], shard.mesh, "frames"),
                      PM.all_reduce(hist[:, 4:], shard.mesh, "frames", op="max")], dim=1)


def joint_optimize(
    verts: Tensor,
    faces: Tensor,
    rot_init_row: Tensor,
    trans_init: Tensor,
    K_rois: Tensor,
    target_masks: Tensor,
    cfg: JointConfig = JointConfig(),
    iters_per_launch: int = 50,
    device: str | torch.device | None = None,
    frame_mesh=None,
) -> JointResult:
    """Stage-2 joint optimization.

    Args:
      verts: (V, 3) canonical vertices; faces: (F, 3).
      rot_init_row: (B, 3, 3) row-convention rotations from stage 1.
      trans_init: (B, 1, 3) or (B, 3).
      K_rois: (B, 3, 3) crop intrinsics in pixel units.
      target_masks: (B, S, S) tri-valued {-1, 0, 1}.
      iters_per_launch: steps per host chunk; the history and the overflow
        are read from the device once per chunk.
      device: None = the CUDA card (raises without one); "cpu" runs the
        kernels' plain versions.
      frame_mesh: a ``parallel.mesh`` mesh whose ``"frames"`` axis shards
        the frames: the frame-axis arguments are this rank's contiguous shards
        (``mesh.shard_leading``), the mesh replicated.  Each rank steps its
        own frames (Adam is per element); the losses are global means, the
        smoothness term reaches across ranks through a one-frame halo, and
        the history is the global one on every rank.

    Returns: JointResult (this rank's frames when sharded); a nonzero
    overflow in any step warns.
    """
    dev = resolve_device(device)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(x, device=dev, dtype=dtype)

    verts, faces = put(verts), put(faces, torch.int64)
    K_rois, target_masks = put(K_rois), put(target_masks)
    ref_masks = (target_masks > 0).float()
    keep_masks = (target_masks >= 0).float()
    state = _init_state(put(rot_init_row), put(trans_init), cfg)
    shard = None
    if frame_mesh is not None:
        counts = PM.all_reduce(torch.stack([
            torch.tensor(float(keep_masks.shape[0]), device=dev), keep_masks.sum()]),
            frame_mesh, "frames")
        shard = _FrameShard(frame_mesh, int(counts[0]), counts[1])
    total = cfg.num_iterations
    chunk = max(min(iters_per_launch, total), 1)
    hists = []
    for done in range(0, total, chunk):
        h = _joint_launch(
            state, min(chunk, total - done), verts, faces, K_rois, ref_masks, keep_masks, cfg,
            shard,
        )
        hists.append(h.cpu())  # one read per chunk
    hist = torch.cat(hists) if hists else torch.zeros((0, len(HISTORY_KEYS)))
    history = {k: hist[:, i] for i, k in enumerate(HISTORY_KEYS)}
    max_ov = int(history["bin_overflow"].max()) if len(hist) else 0
    if max_ov > 0:
        print(
            f"WARNING: tile-bin overflow DURING joint optimization (max"
            f" {max_ov} face-tile pairs or active tiles dropped in a step) —"
            " both caps are auto-counted"
            " (tracker/pipeline._counted_refine_cap); raise"
            " system.cap_headroom (default 1.5) or set an explicit"
            " system.max_faces_per_tile override (disables compaction)",
            flush=True,
        )
    p = state.params
    return JointResult(p["rot6d"].detach(), p["trans"].detach(), p["scale"].detach().abs(), history)
