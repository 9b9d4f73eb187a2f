"""End-to-end pose-tracking pipeline (PyTorch; reference: ObjTracker/run.py).

Port of ``dynhor_tpu/tracker/pipeline.py``.  Host side: sequence loading
(rgb + SAM segmentation channels), per-frame crop/occlusion preprocessing
with EXACT adaptive ROIAlign, all numpy as in the JAX package.  Device
side: the arrays move to the device once; then the frame features, the
two-stage prior scoring (K3), the gating scan, the batched fine refine (K1
and K2 each step) and the joint optimizer (K1 and K2 each step), and the
DKM-correspondence outlier voting with its re-joint.

Two refine modes (system.parallel_refine):
  * True  (default): gating on selected rotations, then ALL frames refined
    in one batched Adam loop; with ``num_initializations`` K > 1, K
    hypotheses per frame (the gate pick, its flips, silhouette-IoU
    retrieval) refined in a tournament (refine.refine_poses_multihyp).
  * False: sequential per-frame loop threading the REFINED rotation into
    the next frame's gate, as the reference does (pose_initializtion.py:
    404-457); it refines the single gate pick.

Several cards (``system.devices``, one process a card under
``torch.distributed``): as in the JAX package, only the prior scoring is
sharded, over the "views" ranks (priors._score_views); every other phase
runs identically on every rank, and rank 0 alone writes the artifacts.
"""
from __future__ import annotations

import dataclasses
import glob as globlib
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ..io.artifacts import Board, copy_config, save_pose_npzs
from ..io.config import experiment_dir
from ..models import dino as dino_mod
from ..ops import rasterize as rz
from ..ops.roi_align import crop_mask_bool_np, roi_align_exact_np
from ..ops.rasterize_tiled import max_active_tiles_load, max_tile_load
from ..parallel import mesh as PM
from ..utils import camera as cam
from ..utils import geometry as G
from ..utils.device import resolve_device
from ..utils.objio import MeshData, load_obj
from ..utils.profiling import Profiler
from . import jointopt as J
from . import priors as P
from . import refine as RF
from . import selection as S

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Host-side data loading & preprocessing
# ---------------------------------------------------------------------------

class SequenceData(NamedTuple):
    frame_ids: list[str]
    images: np.ndarray  # (F, H, W, 3) uint8
    obj_masks: np.ndarray  # (F, H, W) bool
    hand_masks: np.ndarray  # (F, H, W) bool


def load_sequence(dataroot: str) -> SequenceData:
    """Load rgb/*.jpg|png + sam_seg/*.png (run.py:74-88,99).

    SAM channel convention (run.py:84-85): G==255 -> object, B==255 -> hand.
    The reference globs '*.jpg' although its README documents '.png'; both
    are accepted, the .jpg frames first.
    """
    from PIL import Image

    rgb_dir = os.path.join(dataroot, "rgb")
    paths = sorted(globlib.glob(os.path.join(rgb_dir, "*.jpg")))
    if not paths:
        paths = sorted(globlib.glob(os.path.join(rgb_dir, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no rgb frames under {rgb_dir}")
    frame_ids = [os.path.basename(p)[:-4] for p in paths]
    images, obj_masks, hand_masks = [], [], []
    for p, fid in zip(paths, frame_ids):
        images.append(np.asarray(Image.open(p).convert("RGB")))
        seg = np.asarray(Image.open(os.path.join(dataroot, "sam_seg", fid + ".png")))
        obj_masks.append(seg[:, :, 1] == 255)
        hand_masks.append(seg[:, :, -1] == 255)
    return SequenceData(
        frame_ids, np.stack(images), np.stack(obj_masks), np.stack(hand_masks)
    )


class FrameAnnotations(NamedTuple):
    bbox_xywh: np.ndarray  # (F, 4) tight object bbox, full-image pixels
    square_xyxy: np.ndarray  # (F, 4) expanded square crop box
    crop_images: np.ndarray  # (F, 3, S, S) float32 [0,1], white outside mask
    target_masks: np.ndarray  # (F, S, S) float32 {-1, 0, 1}


def _square_box_xyxy(bbox_xywh: np.ndarray, bbox_expansion: float) -> np.ndarray:
    """The expanded square crop box of a tight xywh box, in f32 numpy
    (utils/bbox.make_bbox_square, then xywh -> xyxy)."""
    b = np.asarray(bbox_xywh, dtype=np.float32)
    cx = b[..., 0] + b[..., 2] / 2.0
    cy = b[..., 1] + b[..., 3] / 2.0
    side = np.maximum(b[..., 2], b[..., 3]) * (1.0 + bbox_expansion)
    sq = np.stack([cx - side / 2.0, cy - side / 2.0, side, side], axis=-1)
    return np.concatenate([sq[..., :2], sq[..., :2] + sq[..., 2:4]], axis=-1)


def process_frames(
    seq: SequenceData, crop_size: int = 256, bbox_expansion: float = 0.3
) -> FrameAnnotations:
    """Per-frame crops + occlusion-aware targets (run.py:26-72), numpy.

    Exact detectron2 ROIAlign semantics via the adaptive numpy path
    (sampling_ratio=0, aligned=True).
    """
    f, h, w = seq.obj_masks.shape
    bboxes, squares, crops, targets = [], [], [], []
    for i in range(f):
        om = seq.obj_masks[i]
        nz = np.nonzero(om)
        if len(nz[0]) == 0:
            raise ValueError(f"frame {seq.frame_ids[i]}: empty object mask")
        min_row = max(nz[0].min() - 5.0, 0)
        max_row = min(nz[0].max() + 5.0, h)
        min_col = max(nz[1].min() - 5.0, 0)
        max_col = min(nz[1].max() + 5.0, w)
        box_xyxy = np.array([min_col, min_row, max_col, max_row], np.float32)
        bbox_xywh = np.concatenate([box_xyxy[:2], box_xyxy[2:4] - box_xyxy[:2]])
        sq_xyxy = _square_box_xyxy(bbox_xywh, bbox_expansion).astype(np.float32)

        crop_mask = crop_mask_bool_np(om.astype(np.float32), sq_xyxy, crop_size)
        img = seq.images[i].astype(np.float32).transpose(2, 0, 1) / 255.0
        crop_img = roi_align_exact_np(img, sq_xyxy, crop_size)
        crop_img = np.where(crop_mask[None], crop_img, 1.0)

        hand_crop = crop_mask_bool_np(
            seq.hand_masks[i].astype(np.float32), sq_xyxy, crop_size
        )
        # Tri-valued target (utils/masks.add_occlusions semantics).
        target = np.where(hand_crop, -1.0, 0.0)
        target = np.where(crop_mask, 1.0, target)

        bboxes.append(bbox_xywh)
        squares.append(sq_xyxy)
        crops.append(crop_img)
        targets.append(target.astype(np.float32))
    return FrameAnnotations(
        np.stack(bboxes).astype(np.float32),
        np.stack(squares),
        np.stack(crops).astype(np.float32),
        np.stack(targets),
    )


def load_mesh(obj_path: str, normalize: bool = True) -> MeshData:
    """Load + optionally normalize the template mesh (run.py:107-117), numpy."""
    mesh = load_obj(obj_path)
    verts = np.asarray(mesh.verts, np.float32)
    if normalize:
        verts = verts - verts.mean(axis=0, keepdims=True)
        verts = (verts / np.linalg.norm(verts, axis=1).max() * 0.5).astype(np.float32)
    return dataclasses.replace(mesh, verts=verts)


# ---------------------------------------------------------------------------
# Device-side orchestration
# ---------------------------------------------------------------------------

class TrackResult(NamedTuple):
    rotations_row: np.ndarray  # (F, 3, 3) final row-convention rotations
    translations: np.ndarray  # (F, 1, 3)
    init_rotations_row: np.ndarray  # (F, 3, 3) stage-1 output (pre-joint)
    init_translations: np.ndarray
    selected_idx: np.ndarray  # (F,) prior view chosen by gating
    K: np.ndarray  # (3, 3) full-image intrinsics
    K_rois: np.ndarray  # (F, 3, 3) crop intrinsics (pixel units)
    history: dict[str, np.ndarray]  # joint-opt loss curves
    refine_loss: np.ndarray  # (F,) final stage-1 losses
    refine_iou: np.ndarray  # (F,)


def _mesh_arrays(mesh: MeshData, dev: torch.device) -> RF.MeshArrays:
    return RF.MeshArrays(
        verts=torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev),
        faces=torch.as_tensor(mesh.faces, device=dev).long(),
        face_uvs=torch.as_tensor(mesh.face_uvs, dtype=torch.float32, device=dev),
        texture=torch.as_tensor(mesh.texture, dtype=torch.float32, device=dev),
    )


def view_devices(sysc: dict[str, Any]) -> int:
    """The ranks the prior scoring shards its views over: the world size
    when ``system.devices`` is unset, else the smaller of the two (one in a
    single process, as the JAX package is on a one-chip host)."""
    n_world = PM.world()[1]
    n_cfg = sysc.get("devices")
    return n_world if n_cfg is None else min(int(n_cfg), n_world)


def _counted_refine_cap(
    sysc: dict[str, Any], verts: Tensor, faces: Tensor, rot_row: Tensor, trans: Tensor,
    K_rois: Tensor,
) -> tuple[int, int | None]:
    """(per-tile face cap, active-tile cap) of the refine and joint rasters,
    counted at these poses over ALL frames with system.cap_headroom for pose
    motion (the in-loop overflow signal remains the backstop).  Fixed caps
    corrupt edge-on poses silently; system.max_faces_per_tile forces an
    explicit face cap when set (active-tile compaction then runs dense).
    Reads the device once."""
    explicit = sysc.get("max_faces_per_tile")
    if explicit:
        return int(explicit), None
    s = int(sysc["crop_size"])
    headroom = float(sysc.get("cap_headroom", 1.5))
    t_total = (-(-s // 16)) ** 2
    vp = rz.project_perspective(verts @ rot_row + trans.reshape(-1, 1, 3), K_rois)
    margin = 6.0 * float(sysc["sigma"]) + 1.0  # the fused kernel's binning
    worst, active = torch.stack([
        max_tile_load(vp, faces, (s, s), margin=margin).max(),
        max_active_tiles_load(vp, faces, (s, s), margin=margin).max(),
    ]).tolist()
    cap = -(-int(worst * headroom) // 128) * 128
    cap = max(256, min(cap, int(faces.shape[0])))
    act = -(-int(active * headroom) // 8) * 8
    act = max(8, min(act, t_total))
    return cap, act if act < t_total else None


def track_sequence(
    config: dict[str, Any],
    seq: SequenceData,
    ann: FrameAnnotations,
    mesh: MeshData,
    dino_params=None,
    dino_cfg: dino_mod.DinoConfig | None = None,
    board: Board | None = None,
    profiler: Profiler | None = None,
    view_rotations=None,
    device: str | torch.device | None = None,
) -> TrackResult:
    """Stage 1 (init + refine) + stage 2 (joint) for a whole sequence.

    Args:
      dino_params: the ViT's parameters (``models/dino.py`` layout); None
        loads ``system.dino.checkpoint`` or, with none, draws random ones.
      profiler: the ``utils.profiling.Profiler`` that times the phases;
        None makes one (``system.profile``) and prints its summary at the
        end.
      view_rotations: (N, 3, 3) world-to-camera prior rotations; None makes
        them from the config (a grid, or a random draw seeded by
        ``prior.seed`` that differs from the JAX package's draw).
      device: None = the CUDA card (raises without one); "cpu" runs the
        kernels' plain versions.
    """
    sysc = config["system"]
    dev = resolve_device(device)
    prof = profiler or Profiler(enabled=bool(sysc.get("profile", True)), device=dev)
    s = int(sysc["crop_size"])
    f_frames, h, w = seq.obj_masks.shape

    if dino_params is None:
        dino_params, dino_cfg = dino_mod.load_params(
            sysc["dino"].get("checkpoint"),
            dino_mod.config_for_model(
                sysc["dino"].get("model", "dinov2_vitb14"),
                smaller_edge_size=int(sysc["dino"]["smaller_edge_size"]),
            ),
        )

    K_full = cam.intrinsics_from_image(h, w, float(sysc["focal_factor"]), device=dev)
    mesh_arrays = _mesh_arrays(mesh, dev)
    crop_images = torch.as_tensor(ann.crop_images, device=dev)
    target_masks = torch.as_tensor(ann.target_masks, device=dev)
    bbox_xywh = torch.as_tensor(ann.bbox_xywh, device=dev)

    # ---- prior views: render -> crop -> DINO -> score, chunk by chunk ----
    pc = sysc["prior"]
    prior_cfg = P.PriorConfig(
        num_views=int(pc["num_views"]),
        render_h=int(pc["render_hw"][0]),
        render_w=int(pc["render_hw"][1]),
        distance_scale=float(pc["distance_scale"]),
        crop_size=s,
        bbox_expansion=float(sysc["bbox_expansion"]),
        view_chunk=int(pc["view_chunk"]),
        max_faces_per_tile=int(pc.get("max_faces_per_tile", 1280)),
        grid=None if config.get("random_render", True) else tuple(pc["grid"]),
    )
    if view_rotations is None:
        gen = torch.Generator().manual_seed(int(pc.get("seed", 0)))
        view_rotations = P.prior_view_rotations(prior_cfg, gen)
    view_rots = torch.as_tensor(view_rotations, dtype=torch.float32, device=dev)
    priors_row = view_rots.transpose(-1, -2)  # row convention

    with prof.phase("frame-features"):
        gt_feats, cos_masks = P.frame_gt_features(
            dino_params, dino_cfg, crop_images, target_masks, device=dev
        )
    radius, _ = P.mesh_radius_center(mesh_arrays.verts)  # camera-distance radius
    window = P.compute_window(
        prior_cfg, float(P.mesh_norm_radius(mesh_arrays.verts)),
        float(prior_cfg.distance_scale * radius),
    )
    # Shard the view axis when several ranks run (every rank makes the
    # mesh: its groups are made collectively).
    n_dev = view_devices(sysc)
    view_mesh = PM.make_mesh(n_dev, "views") if n_dev > 1 else None
    if view_mesh is not None and not view_mesh.is_member:
        view_mesh = None
    # Multi-hypothesis init (num_initializations; the reference plumbs it
    # and never enables it, pose_initializtion.py:258,390): with K > 1 the
    # scoring also returns the silhouette-IoU channel that seeds the extra
    # hypotheses (selection.build_hypotheses).
    num_init = int(sysc.get("num_initializations", 1))
    hypc = sysc.get("hypotheses") or {}
    with_sil = num_init > 1 and bool(hypc.get("sil_retrieval", True))
    with prof.phase("prior-scoring"):
        ps = pc.get("prescreen") or {}
        common = (
            dino_params, dino_cfg, mesh_arrays.verts, mesh_arrays.faces,
            mesh_arrays.face_uvs, mesh_arrays.texture, view_rots,
        )
        if bool(ps.get("enabled", True)):
            out = P.prior_scores_two_stage(
                *common, crop_images, target_masks, gt_feats, cos_masks, prior_cfg,
                window, host_batch=int(pc.get("host_batch", 1000)),
                prescreen_edge=int(ps.get("edge", 112)),
                prescreen_scale=int(ps.get("scale", 2)),
                topk=int(ps.get("topk", 24)), device=dev, with_sil=with_sil,
                view_mesh=view_mesh,
            )
        else:
            out = P.prior_scores_batched(
                *common, gt_feats, cos_masks, prior_cfg, window,
                host_batch=int(pc.get("host_batch", 1000)), device=dev,
                with_sil=with_sil,
                sil_masks=P.frame_sil_masks(target_masks) if with_sil else None,
                view_mesh=view_mesh,
            )
        scores, sil_scores = out if with_sil else (out, None)

    # ---- K_rois + refine config ----
    K_rois = cam.get_K_crop_resize(
        K_full.expand(f_frames, 3, 3), torch.as_tensor(ann.square_xyxy, device=dev), s
    )
    refine_cfg = RF.RefineConfig(
        num_iterations=int(sysc["init_num_iterations"]),
        lr=float(sysc["init_lr"]),
        crop_size=s,
        offscreen_weight=float(sysc["offscreen_weight"]),
        sigma=float(sysc["sigma"]),
        face_chunk=int(sysc["face_chunk"]),
        mode="fine",
    )
    targets = RF.FrameTargets(target_masks=target_masks, gt_feats=gt_feats, K_rois=K_rois)

    def autodepth(rot_row, boxes):
        pts = torch.einsum("vj,bjk->bvk", mesh_arrays.verts, rot_row)
        return cam.tco_init_from_boxes_autodepth(
            boxes, pts, K_full.expand(rot_row.shape[0], 3, 3)
        )

    def caps(rot_row, trans, K_sel):
        return _counted_refine_cap(
            sysc, mesh_arrays.verts, mesh_arrays.faces, rot_row, trans, K_sel
        )

    if bool(sysc.get("parallel_refine", True)):
        with prof.phase("gating+autodepth"):
            gate = S.gate_all_frames(scores, priors_row)
            rot_init = gate.rotation_init  # (F, 3, 3)
            oracle = sysc.get("oracle_init") or {}
            if oracle.get("enabled"):
                # ABLATION: replace the DINO-gated init with the GT-nearest
                # prior view (synthetic sequences only: isolates the view
                # selection from the refine's and joint's robustness).
                gt = np.load(oracle["gt_poses"])
                gt_row = torch.as_tensor(gt["R"], dtype=torch.float32, device=dev)
                ang = G.rotation_angle_difference(
                    priors_row[None, :], gt_row.transpose(-1, -2)[:, None]
                )  # (F, N) degrees
                oracle_idx = torch.argmin(ang, dim=1)
                rot_init = priors_row[oracle_idx]
                gate = gate._replace(selected_idx=oracle_idx)
                print(
                    "[ablation] oracle init: GT-nearest prior view per frame"
                    f" (mean residual {float(ang.min(1).values.mean()):.1f} deg)",
                    flush=True,
                )
            if num_init > 1 and not oracle.get("enabled"):
                hyp = S.build_hypotheses(
                    rot_init, gate.selected_idx, priors_row, num_init,
                    sil_scores=sil_scores,
                    include_flips=bool(hypc.get("flips", True)),
                    min_angle_deg=float(hypc.get("min_angle_deg", 30.0)),
                )
                # Autodepth and the caps over all F*K hypotheses.
                flat_rot = hyp.rotations.to(dev).reshape(-1, 3, 3)  # (F*K, 3, 3)
                flat_trans = autodepth(flat_rot, bbox_xywh.repeat_interleave(num_init, 0))
                trans_hyp = flat_trans.reshape(f_frames, num_init, 3)
                cap, act_cap = caps(
                    flat_rot, flat_trans, K_rois.repeat_interleave(num_init, 0)
                )
            else:
                hyp = None
                trans_init = autodepth(rot_init, bbox_xywh)  # (F, 3)
                cap, act_cap = caps(rot_init, trans_init, K_rois)
            refine_cfg = dataclasses.replace(
                refine_cfg, max_faces_per_tile=cap, max_active_tiles=act_cap
            )
            joint_cap, joint_act = cap, act_cap
        with prof.phase("refine"):
            if hyp is not None:
                res, sel_idx = _refine_hypotheses(
                    mesh_arrays, targets, hyp, trans_hyp, dino_params, dino_cfg,
                    refine_cfg, hypc, gate, dev,
                )
            else:
                res = RF.refine_poses(
                    mesh_arrays, targets, rot_init, trans_init, dino_params, dino_cfg,
                    refine_cfg, device=dev,
                )
                sel_idx = gate.selected_idx.cpu().numpy().astype(np.int32)
        rot6d, trans = res.rot6d, res.translations
        losses, ious = res.final_loss.cpu().numpy(), res.final_iou.cpu().numpy()
    else:
        # Sequential parity mode: thread the REFINED rotation into the gate.
        if num_init > 1:
            print(
                "note: num_initializations > 1 is a parallel-pipeline feature;"
                " sequential parity mode refines the single gate pick"
                " (reference control flow)",
                flush=True,
            )
        state = S.initial_state(dev)
        rot6d_list, trans_list, sel_list, loss_list, iou_list = [], [], [], [], []
        # ONE cap for all frames (max over the top-1 gate candidates), with
        # the counted headroom: the gate may pick other candidates, and the
        # in-loop overflow warning remains the backstop.
        top1 = priors_row[torch.argmax(scores, dim=1)]
        joint_cap, joint_act = caps(top1, autodepth(top1, bbox_xywh), K_rois)
        refine_cfg = dataclasses.replace(
            refine_cfg, max_faces_per_tile=joint_cap, max_active_tiles=joint_act
        )
        for i in range(f_frames):
            state, gate = S.gate_frame(state, scores[i], priors_row)
            t0 = autodepth(gate.rotation_init[None], bbox_xywh[i : i + 1])
            one_targets = RF.FrameTargets(*(x[i : i + 1] for x in targets))
            res = RF.refine_poses(
                mesh_arrays, one_targets, gate.rotation_init[None], t0,
                dino_params, dino_cfg, refine_cfg, device=dev,
            )
            state = state._replace(prev_rotation=G.rot6d_to_matrix(res.rot6d)[0])
            rot6d_list.append(res.rot6d[0])
            trans_list.append(res.translations[0])
            sel_list.append(int(gate.selected_idx))
            loss_list.append(float(res.final_loss[0]))
            iou_list.append(float(res.final_iou[0]))
        rot6d = torch.stack(rot6d_list)
        trans = torch.stack(trans_list)
        sel_idx = np.asarray(sel_list, np.int32)
        losses, ious = np.asarray(loss_list), np.asarray(iou_list)

    init_rot_row = G.rot6d_to_matrix(rot6d)

    # ---- stage 2: joint temporal optimization ----
    joint_cfg = J.JointConfig(
        num_iterations=int(sysc["joint_num_iterations"]),
        lr=float(sysc["joint_lr"]),
        lw_sil_obj=float(sysc["loss"]["lw_sil_obj"]),
        lw_smooth_obj=float(sysc["loss"]["lw_smooth_obj"]),
        crop_size=s,
        sigma=float(sysc["sigma"]),
        face_chunk=int(sysc["face_chunk"]),
        max_faces_per_tile=joint_cap,
        max_active_tiles=joint_act,
    )
    with prof.phase("joint-opt"):
        jres = J.joint_optimize(
            mesh_arrays.verts, mesh_arrays.faces, init_rot_row, trans, K_rois,
            target_masks, joint_cfg, device=dev,
        )
    history = {k: v.numpy() for k, v in jres.history.items()}
    if profiler is None:  # a caller's profiler is the caller's to print
        prof.summary()
    if board is not None:
        board.add_history(history)

    return TrackResult(
        rotations_row=G.rot6d_to_matrix(jres.rot6d).cpu().numpy(),
        translations=jres.translations.cpu().numpy(),
        init_rotations_row=init_rot_row.cpu().numpy(),
        init_translations=trans.cpu().numpy(),
        selected_idx=sel_idx,
        K=K_full.cpu().numpy(),
        K_rois=K_rois.cpu().numpy(),
        history=history,
        refine_loss=losses,
        refine_iou=ious,
    )


def _refine_hypotheses(
    mesh_arrays, targets, hyp, trans_hyp, dino_params, dino_cfg, refine_cfg, hypc, gate, dev,
):
    """The multi-hypothesis refine with the ``hypotheses`` block's keys;
    prints the winners and returns (result, selected prior index per
    frame): the winners' source views, or after propagation (whose slots
    hold neighbours' winners, not views) the gate's."""
    prop_rounds = int(hypc.get("propagate_rounds", 1))
    num_init = hyp.rotations.shape[1]
    mres = RF.refine_poses_multihyp(
        mesh_arrays, targets, hyp.rotations, trans_hyp, dino_params, dino_cfg,
        refine_cfg, tournament_iters=hypc.get("tournament_iters", 25),
        select=str(hypc.get("select", "viterbi")),
        smooth_weight=float(hypc.get("smooth_weight", 1.0 / 45.0)),
        propagate_rounds=prop_rounds, device=dev,
    )
    win = mres.winner.numpy()
    hyp_src = hyp.indices.numpy()
    n_non_gate = int((win != 0).sum())
    if prop_rounds > 0:
        print(
            f"[hypotheses] {num_init} inits/frame + {prop_rounds}"
            f" propagation round(s); final winner slots "
            f"{win.tolist()} (0=own winner, 1..=neighbour"
            f" winners); {n_non_gate}/{len(win)} frames took a"
            " neighbour's pose",
            flush=True,
        )
        sel_idx = gate.selected_idx.cpu().numpy().astype(np.int32)
    else:
        print(
            f"[hypotheses] {num_init} inits/frame; winner slots "
            f"{win.tolist()} (0=gate, src idx "
            f"{hyp_src[np.arange(len(win)), win].tolist()}); "
            f"{n_non_gate}/{len(win)} frames changed init",
            flush=True,
        )
        sel_idx = hyp_src[np.arange(len(win)), win]
    return mres.result, sel_idx


def run_from_config(
    config: dict[str, Any], exps_root: str = "exps",
    device: str | torch.device | None = None,
) -> TrackResult:
    """Full run.py-equivalent: load, track, vote, save artifacts.

    ``device``: None = the CUDA card (raises without one, before any work);
    "cpu" runs the kernels' plain versions."""
    dev = resolve_device(device)
    prof = Profiler(enabled=bool(config["system"].get("profile", True)), device=dev)
    data_info = config["data_info"]
    with prof.phase("host preprocessing"):
        # Fail loudly on miswired exports (channel order, soft masks, size
        # mismatches: io/ingest.py) BEFORE any device work.
        if bool(config.get("system", {}).get("validate_data", True)):
            from ..io.ingest import validate_or_raise

            validate_or_raise(data_info["dataroot"])
        seq = load_sequence(data_info["dataroot"])
        ann = process_frames(
            seq,
            crop_size=int(config["system"]["crop_size"]),
            bbox_expansion=float(config["system"]["bbox_expansion"]),
        )
        mesh = load_mesh(data_info["obj_path"], bool(data_info.get("normalize_mesh", True)))

    # Under several ranks every rank computes the same poses; rank 0 alone
    # writes the experiment directory.
    writer = PM.world()[0] == 0
    exp_dir = experiment_dir(config, exps_root)
    board = None
    if writer:
        os.makedirs(exp_dir, exist_ok=True)
        if config.get("_config_path"):
            copy_config(exp_dir, config["_config_path"])
        board = Board(exp_dir)

    result = track_sequence(config, seq, ann, mesh, board=board, profiler=prof, device=dev)
    with prof.phase("outlier-voting"):
        result = maybe_vote_outliers(config, seq, ann, mesh, result, board, device=dev)
    prof.summary()
    if writer:
        save_pose_npzs(
            exp_dir, seq.frame_ids, result.rotations_row, result.translations, result.K
        )
        board.close()
    return result


def maybe_vote_outliers(
    config: dict[str, Any],
    seq: SequenceData,
    ann: FrameAnnotations,
    mesh: MeshData,
    result: TrackResult,
    board: Board | None = None,
    device: str | torch.device | None = None,
) -> TrackResult:
    """DKM-correspondence outlier voting + pose repair.

    Runs when <dataroot>/correspondence_infos exists (README.md:43
    convention) and system.outlier_voting.enabled.  The re-joint takes
    JointConfig's default caps (640 faces a tile, all tiles dense), as the
    JAX package does; where a mesh needs more, the joint's overflow
    warning says so.
    """
    ov = config["system"].get("outlier_voting", {})
    if not ov.get("enabled", True):
        return result
    from ..neus.data import load_correspondences
    from . import outliers as OV

    dev = resolve_device(device)
    corr = load_correspondences(config["data_info"]["dataroot"], seq.frame_ids)
    if corr is None:
        return result
    h, w = seq.obj_masks.shape[1:]
    report = OV.vote_outliers(
        mesh.verts, mesh.faces, result.rotations_row, result.translations[:, 0, :],
        result.K, corr, (h, w), threshold_px=float(ov.get("threshold_px", 8.0)),
        device=dev,
    )
    print(
        f"outlier voting: scores px={np.round(report.frame_scores, 2)} "
        f"outliers={np.nonzero(report.outliers)[0].tolist()}"
    )
    if board is not None:
        for i, s in enumerate(report.frame_scores):
            if np.isfinite(s):
                board.add_scalar("outlier_score_px", float(s), i)
    if not report.outliers.any():
        return result
    R_fix, T_fix = OV.interpolate_poses(
        result.rotations_row, result.translations[:, 0, :], report.outliers
    )
    if ov.get("rejoint", True):
        sysc = config["system"]
        verts = torch.as_tensor(mesh.verts, dtype=torch.float32, device=dev)
        faces = torch.as_tensor(mesh.faces, device=dev).long()
        R_t = torch.as_tensor(R_fix, dtype=torch.float32, device=dev)
        T_t = torch.as_tensor(T_fix, dtype=torch.float32, device=dev)
        K_rois = torch.as_tensor(result.K_rois, device=dev)
        joint_cfg = J.JointConfig(
            num_iterations=max(int(sysc["joint_num_iterations"]) // 2, 1),
            lr=float(sysc["joint_lr"]),
            lw_sil_obj=float(sysc["loss"]["lw_sil_obj"]),
            lw_smooth_obj=float(sysc["loss"]["lw_smooth_obj"]),
            crop_size=int(sysc["crop_size"]),
            sigma=float(sysc["sigma"]),
            face_chunk=int(sysc["face_chunk"]),
        )
        jres = J.joint_optimize(
            verts, faces, R_t, T_t, K_rois, ann.target_masks, joint_cfg, device=dev,
        )
        R_fix = G.rot6d_to_matrix(jres.rot6d).cpu().numpy()
        T_fix = jres.translations.cpu().numpy()[:, 0, :]
    return result._replace(
        rotations_row=np.asarray(R_fix),
        translations=np.asarray(T_fix).reshape(-1, 1, 3),
    )
