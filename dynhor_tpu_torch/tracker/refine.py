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

``refine_poses_multihyp`` refines K rotation hypotheses per frame (the
pipeline's ``num_initializations > 1``): each slot is one batched refine of
all frames for ``tournament_iters`` steps, a winner per frame is chosen
(a Viterbi path over the frames, or the per-frame best loss), and the
winners continue from their own parameters and Adam moments
(``RefineState``), so the continued trajectory is an unbroken one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models import dino as dino_mod
from ..ops import rasterize as rz
from ..ops.raster_fused import rasterize_silhouette
from ..ops.rasterize_tiled import rasterize_tiled, soft_silhouette_tiled
from ..ops.resize import resize_nearest
from ..ops.shading import TextureSet, fine_lights, phong_shade, phong_shade_tiles
from ..ops.silhouette import soft_silhouette
from ..parallel import mesh as PM
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
    lw_mask: float = 1.0  # stored but never applied in the reference (quirk,
    # pose_initializtion.py:107,149,162); kept for config parity, unused.
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
    # What the sem loss's backward keeps of each ViT block (the JAX
    # package's policies, models/dino._trunk): "frozen" the block input,
    # qkv, the mid residual and the fc1 output (9·D values a token; the
    # layer norms and the attention core run again); "dots" every matmul
    # output; True the block input only (each block runs again); False
    # everything.  The step computes the same function under each.
    dino_remat: bool | str = "frozen"


class MeshArrays(NamedTuple):
    """One mesh shared by every frame, or (with a leading frame axis B) a
    mesh per frame: the pooled multi-sequence batch (parallel/multiseq.py),
    whose texture is then a TextureSet."""

    verts: Tensor  # (V, 3) canonical (normalized) vertices, or (B, V, 3)
    faces: Tensor  # (F, 3) int64, or (B, F, 3)
    face_uvs: Tensor  # (F, 3, 2), or (B, F, 3, 2)
    texture: Tensor | TextureSet  # (Ht, Wt, 3), or a TextureSet of B frames


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


class RefineState(NamedTuple):
    """Where a refine stopped: its parameters and Adam's moments for each
    (torch.optim.Adam's ``exp_avg`` / ``exp_avg_sq``), and Adam's step
    count, which every frame shares.  ``refine_poses(carry_state=...)``
    resumes from it to the trajectory of an unbroken run."""

    rot6d: Tensor  # (B, 3, 2)
    trans: Tensor  # (B, 1, 3)
    m_rot6d: Tensor  # (B, 3, 2)
    v_rot6d: Tensor
    m_trans: Tensor  # (B, 1, 3)
    v_trans: Tensor
    step: Tensor  # () f32 on the CPU, as torch.optim.Adam keeps it


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
        feats = dino_mod.forward_tokens_from_crop(
            dino_params, rgb, dino_cfg, remat=cfg.dino_remat
        ).float()
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
    state: RefineState | None = None,
) -> tuple[RefineResult, Tensor, RefineState]:
    """cfg.num_iterations Adam steps on device tensors, from the inits or
    from ``state``.  Returns the result, the max overflow as a device
    tensor (no host sync in the loop) and the state at the end."""
    b = rot_init_row.shape[0]
    dev = rot_init_row.device
    if state is None:
        rot6d = G.matrix_to_rot6d(rot_init_row).float().clone().requires_grad_(True)
        trans = trans_init.reshape(b, 1, 3).float().clone().requires_grad_(True)
    else:
        rot6d = state.rot6d.to(dev, torch.float32).clone().requires_grad_(True)
        trans = state.trans.to(dev, torch.float32).clone().requires_grad_(True)
    # optax.adam defaults: b1 0.9, b2 0.999, eps 1e-8 outside the sqrt.
    opt = torch.optim.Adam([rot6d, trans], lr=cfg.lr)
    if state is not None:
        for p, m, v in ((rot6d, state.m_rot6d, state.v_rot6d),
                        (trans, state.m_trans, state.v_trans)):
            opt.state[p] = {
                "step": torch.tensor(float(state.step)),
                "exp_avg": m.to(dev, torch.float32).clone(),
                "exp_avg_sq": v.to(dev, torch.float32).clone(),
            }
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

    def moments(p):
        st = opt.state.get(p)
        if not st:  # no step was taken
            return torch.zeros_like(p), torch.zeros_like(p), torch.tensor(0.0)
        return st["exp_avg"].clone(), st["exp_avg_sq"].clone(), st["step"].clone()

    (m_r, v_r, step), (m_t, v_t, _) = moments(rot6d), moments(trans)
    state_out = RefineState(result.rot6d, result.translations, m_r, v_r, m_t, v_t, step)
    return result, max_ov, state_out


def place_inputs(mesh: MeshArrays, targets: FrameTargets, dino_params, cfg: RefineConfig, dev):
    """The mesh, the targets and the ViT's parameters (cast to
    ``cfg.dino_dtype``, detached) on ``dev``; tensors or arrays in."""

    def put(x, dtype):
        return torch.as_tensor(x, device=dev, dtype=dtype)

    tex = mesh.texture
    if isinstance(tex, TextureSet):
        tex = TextureSet(put(tex.textures, torch.float32), put(tex.index, torch.int64))
    else:
        tex = put(tex, torch.float32)
    mesh = MeshArrays(
        put(mesh.verts, torch.float32), put(mesh.faces, torch.int64),
        put(mesh.face_uvs, torch.float32), tex,
    )
    targets = FrameTargets(*(put(x, torch.float32) for x in targets))
    if dino_params is not None:
        dtype = torch.bfloat16 if cfg.dino_dtype == "bfloat16" else torch.float32
        dino_params = dino_mod.map_params(
            dino_params, lambda a: a.detach().to(device=dev, dtype=dtype)
        )
    return mesh, targets, dino_params


def warn_overflow(max_overflow: int, what: str = "refinement") -> None:
    """The warning of a refine whose rasters dropped faces or tiles."""
    if max_overflow > 0:
        print(
            f"WARNING: tile-bin overflow DURING {what} (max {max_overflow}"
            " face-tile pairs or active tiles dropped in a step) — count both"
            " caps at the init poses (ops/rasterize_tiled.max_tile_load,"
            " max_active_tiles_load) with headroom",
            flush=True,
        )


def refine_poses(
    mesh: MeshArrays,
    targets: FrameTargets,
    rot_init_row: Tensor,
    trans_init: Tensor,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RefineConfig = RefineConfig(),
    iters_per_launch: int = 25,
    carry_state: RefineState | None = None,
    return_state: bool = False,
    device: str | torch.device | None = None,
    frame_mesh=None,
):
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
      carry_state: a RefineState to resume from (the init arguments are
        then ignored, as in the JAX package).
      return_state: also return the RefineState at the end.
      device: None = the CUDA card (raises without one); "cpu" runs the
        kernels' plain versions.
      frame_mesh: a ``parallel.mesh`` mesh whose ``"frames"`` axis shards
        the frames: the frame-axis inputs are this rank's shards
        (``mesh.shard_leading``) and the mesh and ViT replicated.  Frames
        are independent (their own parameters and Adam moments, a summed
        loss), so each rank refines its own; the result holds this rank's
        frames and the overflow is the largest of every rank.

    Returns: RefineResult (row-convention 6D rotations) [, RefineState if
    return_state].  The overflow is read once, after the loop, and a
    nonzero value warns.
    """
    del iters_per_launch
    dev = resolve_device(device)
    mesh, targets, dino_params = place_inputs(mesh, targets, dino_params, cfg, dev)
    result, max_ov, state = _refine_launch(
        mesh, targets, torch.as_tensor(rot_init_row, dtype=torch.float32, device=dev),
        torch.as_tensor(trans_init, dtype=torch.float32, device=dev), dino_params, dino_cfg,
        cfg, carry_state,
    )
    max_ov = PM.all_reduce(max_ov, frame_mesh, "frames", op="max")
    max_overflow = int(max_ov)
    warn_overflow(max_overflow)
    result = result._replace(max_overflow=max_overflow)
    if return_state:
        return result, state
    return result


class MultiHypResult(NamedTuple):
    result: RefineResult  # per-frame WINNER poses and losses (B, ...)
    winner: Tensor  # (B,) int32 winning hypothesis slot per frame, on the CPU
    tournament_loss: Tensor  # (B, K) per-hypothesis loss at selection time


def _viterbi_select(rots_row, losses, smooth_weight: float = 1.0 / 45.0) -> Tensor:
    """Temporally consistent winner selection over the (B, K) hypothesis
    lattice, in numpy float64 on the host (B frames, K slots: microseconds).

    Per-frame ``argmin(loss)`` cannot tell a near-symmetric object's pose
    from its silhouette-preserving flip; a video's true pose track is
    smooth.  Dynamic programming over the lattice with

      unary(f, k)     = the loss gap (L - min over slots), scaled by the
                        MEDIAN positive gap of the whole lattice and clipped
                        at 6 (a global scale: a per-frame z-score with K=2
                        maps every gap to 2 sigma);
      pairwise(f,i,j) = geodesic angle in degrees between consecutive
                        frames' refined hypothesis poses x ``smooth_weight``
                        (1/45: a 180-degree flip costs 4 units).

    Args: rots_row (B, K, 3, 3), losses (B, K), tensors or arrays.
    Returns (B,) int32 slots, on the CPU.
    """
    R = torch.as_tensor(rots_row).cpu().numpy().astype(np.float64)  # (B, K, 3, 3)
    L = torch.as_tensor(losses).cpu().numpy().astype(np.float64)  # (B, K)
    b, k = L.shape
    if b == 1 or k == 1:
        return torch.as_tensor(np.argmin(L, axis=1).astype(np.int32))
    gaps = L - L.min(axis=1, keepdims=True)  # (B, K), >= 0
    pos = gaps[gaps > 1e-12]
    sigma = float(np.median(pos)) if pos.size else 1.0
    unary = np.clip(gaps / sigma, 0.0, 6.0)  # (B, K)
    # trace(A B^T) = sum(A * B): ang[f, i, j] = angle(R[f, i], R[f+1, j]).
    tr = np.einsum("fiab,fjab->fij", R[:-1], R[1:])
    ang = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
    pair = smooth_weight * ang  # (B-1, K, K)

    best = unary[0].copy()
    back = np.zeros((b, k), np.int32)
    for f in range(1, b):
        tot = best[:, None] + pair[f - 1]  # (K_prev, K)
        back[f] = np.argmin(tot, axis=0)
        best = tot.min(axis=0) + unary[f]
    win = np.zeros(b, np.int32)
    win[-1] = int(np.argmin(best))
    for f in range(b - 1, 0, -1):
        win[f - 1] = back[f, win[f]]
    return torch.as_tensor(win)


def refine_poses_multihyp(
    mesh: MeshArrays,
    targets: FrameTargets,
    rot_inits_row,
    trans_inits,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RefineConfig = RefineConfig(),
    tournament_iters: int | None = None,
    iters_per_launch: int = 25,
    select: str = "viterbi",
    smooth_weight: float = 1.0 / 45.0,
    propagate_rounds: int = 0,
    device: str | torch.device | None = None,
) -> MultiHypResult:
    """Multi-hypothesis refinement: K inits per frame, a winner per frame.

    Each hypothesis slot is one ``refine_poses`` call over all B frames
    (K calls of the same batched loop; the peak memory is one slot's), for
    ``tournament_iters`` steps; a winner per frame is selected from the
    slots' losses, and only the winners continue for the remaining
    ``num_iterations - tournament_iters`` steps from their own parameters
    and Adam moments.  Cost: K x tournament_iters (x (1 +
    propagate_rounds)) + the rest, against num_iterations for one init.

    Args:
      rot_inits_row: (B, K, 3, 3) hypothesis rotations
        (selection.build_hypotheses).
      trans_inits: (B, K, 3) translation inits per hypothesis.
      tournament_iters: steps before the selection (None/0, or at least
        num_iterations: every slot refines the full count).
      select: "viterbi" (``_viterbi_select``) or "loss" (per-frame argmin).
      smooth_weight: the Viterbi pairwise weight per degree.
      propagate_rounds: extra tournaments whose slots are re-seeded from
        the neighbours' PER-FRAME-ARGMIN winners (slot 0 the frame's own,
        then frames f-1, f+1, f-2, ... clamped to the sequence), each with
        the frame's own winner translation; the temporal prior enters only
        at the final selection.
      device: None = the CUDA card (raises without one); "cpu" runs the
        kernels' plain versions.
    """
    dev = resolve_device(device)
    rot_inits_row = torch.as_tensor(rot_inits_row, dtype=torch.float32, device=dev)
    trans_inits = torch.as_tensor(trans_inits, dtype=torch.float32, device=dev)
    b, k = rot_inits_row.shape[:2]
    if k == 1:
        res = refine_poses(
            mesh, targets, rot_inits_row[:, 0], trans_inits[:, 0],
            dino_params, dino_cfg, cfg, iters_per_launch, device=dev,
        )
        return MultiHypResult(res, torch.zeros((b,), dtype=torch.int32),
                              res.final_loss[:, None])

    total = cfg.num_iterations
    t_iters = tournament_iters if tournament_iters else total
    t_iters = min(max(int(t_iters), 1), total)
    cfg_t = dataclasses.replace(cfg, num_iterations=t_iters)

    def tournament(rots_bk, trans_bk):
        results, states = [], []
        for j in range(k):
            r, st = refine_poses(
                mesh, targets, rots_bk[:, j], trans_bk[:, j], dino_params, dino_cfg,
                cfg_t, iters_per_launch, return_state=True, device=dev,
            )
            results.append(r)
            states.append(st)
        losses = torch.stack([r.final_loss for r in results], dim=1)  # (B, K)
        rots = torch.stack([G.rot6d_to_matrix(r.rot6d) for r in results], dim=1)
        return results, states, losses, rots

    results, states, losses, rots_ref = tournament(rot_inits_row, trans_inits)

    for _ in range(max(int(propagate_rounds), 0)):
        # Seeds from the per-frame argmin, not the Viterbi path: seeding
        # every frame from one consistent family would discard the minority
        # frames whose best-loss hypothesis disagrees.
        win = losses.cpu().argmin(dim=1).to(dev)  # the first index on ties
        ar = torch.arange(b, device=dev)
        win_rot = rots_ref[ar, win]  # (B, 3, 3)
        trans_all = torch.stack([r.translations[:, 0] for r in results], dim=1)
        win_trans = trans_all[ar, win]  # (B, 3)
        offs = [0]
        d = 1
        while len(offs) < k:
            offs.append(-d)
            if len(offs) < k:
                offs.append(d)
            d += 1
        prop_rots = torch.stack([win_rot[(ar + o).clamp(0, b - 1)] for o in offs], dim=1)
        prop_trans = win_trans[:, None].expand(b, k, 3)  # the frame's own
        results, states, losses, rots_ref = tournament(prop_rots, prop_trans)

    if select == "viterbi":
        win = _viterbi_select(rots_ref, losses, smooth_weight)
    else:
        win = losses.cpu().argmin(dim=1).to(torch.int32)
    win_dev = win.to(dev, torch.int64)

    def pick(*xs):
        if xs[0].ndim == 0 or xs[0].shape[0] != b:
            return xs[0]  # the Adam step count: equal in every slot
        st = torch.stack(xs, dim=1)  # (B, K, ...)
        return st[torch.arange(b, device=st.device), win_dev.to(st.device)]

    rem = total - t_iters
    if rem > 0:
        state_w = RefineState(*(pick(*leaves) for leaves in zip(*states)))
        res = refine_poses(
            mesh, targets, rot_inits_row[:, 0], trans_inits[:, 0], dino_params, dino_cfg,
            dataclasses.replace(cfg, num_iterations=rem), iters_per_launch,
            carry_state=state_w, device=dev,
        )
    else:
        res = RefineResult(
            *(pick(*leaves) for leaves in zip(*(r[:4] for r in results))),
            max_overflow=max(r.max_overflow for r in results),  # of every slot
        )
    return MultiHypResult(res, win, losses)
