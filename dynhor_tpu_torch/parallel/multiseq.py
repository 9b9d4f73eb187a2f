"""Multi-sequence pooled tracking: several videos' frames refined in ONE
batched loop (``BASELINE.json``'s "end-to-end multi-sequence batch").

Port of ``dynhor_tpu/parallel/multiseq.py``, on one card or sharded over
ranks (``refine_poses_multi(frame_mesh=)``).  Different
sequences track different objects, so each frame carries ITS OWN mesh:
meshes are padded to a common (V_max, F_max) — padding vertices repeat
vertex 0 and padding faces are the degenerate (0, 0, 0) with zero UVs,
which draw nothing (zero screen area) — and the pooled frames run as one
batch with faces (N, F, 3) through the fused raster (K1/K2 take per-frame
rows either way), the normals and the shading.  Textures are padded with
ones to the largest and kept once per sequence (``ops.shading.TextureSet``),
where the JAX package holds a copy per frame.  The joint temporal stage
couples frames only within a sequence, so it runs per sequence afterwards
(``dynhor_tpu_torch.run_multi``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from ..models import dino as dino_mod
from ..ops.shading import TextureSet
from ..tracker import refine as RF
from ..utils.device import resolve_device
from ..utils.objio import MeshData
from . import mesh as PM

Tensor = torch.Tensor

# Fine-mode frames a card takes in a launch by default: the JAX package's
# cap for one 16 GB chip.  A group is FRAMES_PER_CARD x the ranks the pool
# is sharded over, as the JAX package's is x its devices.
FRAMES_PER_CARD = 16


def pad_mesh(mesh: MeshData, v_max: int, f_max: int) -> MeshData:
    """Pad to (v_max, f_max): repeated vertex 0 / degenerate faces."""
    v = np.asarray(mesh.verts)
    f = np.asarray(mesh.faces)
    uv = np.asarray(mesh.face_uvs)
    v_pad = np.concatenate([v, np.tile(v[:1], (v_max - len(v), 1))]) if len(v) < v_max else v
    f_pad = np.concatenate([f, np.zeros((f_max - len(f), 3), f.dtype)]) if len(f) < f_max else f
    uv_pad = (
        np.concatenate([uv, np.zeros((f_max - len(uv), 3, 2), uv.dtype)])
        if len(uv) < f_max else uv
    )
    return dataclasses.replace(mesh, verts=v_pad, faces=f_pad, face_uvs=uv_pad)


class MultiSeqBatch(NamedTuple):
    """Frame pool across sequences (leading axis = pooled frames N)."""

    mesh_verts: Tensor  # (N, V, 3) per-frame canonical verts
    mesh_faces: Tensor  # (N, F, 3) int64
    mesh_uvs: Tensor  # (N, F, 3, 2)
    mesh_tex: TextureSet  # (S, Ht, Wt, 3) padded textures, frame n's at index[n]
    targets: RF.FrameTargets  # leading axis N
    seq_id: np.ndarray  # (N,) which sequence each frame belongs to


def build_batch(
    meshes: list[MeshData],
    per_seq_targets: list[RF.FrameTargets],
    device: str | torch.device | None = None,
) -> MultiSeqBatch:
    """Pool frames of several sequences, padding meshes and textures; the
    tensors on ``device`` (None = the CUDA card, "cpu" the CPU)."""
    dev = resolve_device(device)
    v_max = max(m.verts.shape[0] for m in meshes)
    f_max = max(m.faces.shape[0] for m in meshes)
    ht = max(m.texture.shape[0] for m in meshes)
    wt = max(m.texture.shape[1] for m in meshes)
    mv, mf, muv, texs, seq_id = [], [], [], [], []
    for s, (mesh, tgt) in enumerate(zip(meshes, per_seq_targets)):
        m = pad_mesh(mesh, v_max, f_max)
        tex = np.ones((ht, wt, 3), np.float32)
        tex[: m.texture.shape[0], : m.texture.shape[1]] = m.texture
        n = tgt.target_masks.shape[0]
        mv.append(np.broadcast_to(m.verts, (n,) + m.verts.shape))
        mf.append(np.broadcast_to(m.faces, (n,) + m.faces.shape))
        muv.append(np.broadcast_to(m.face_uvs, (n,) + m.face_uvs.shape))
        texs.append(tex)
        seq_id.extend([s] * n)

    def put(parts, dtype):
        return torch.as_tensor(np.concatenate(parts), dtype=dtype, device=dev)

    targets = RF.FrameTargets(*(
        torch.cat([torch.as_tensor(getattr(t, k), dtype=torch.float32, device=dev)
                   for t in per_seq_targets])
        for k in RF.FrameTargets._fields
    ))
    seq_id = np.asarray(seq_id, np.int32)
    return MultiSeqBatch(
        mesh_verts=put(mv, torch.float32),
        mesh_faces=put(mf, torch.int64),
        mesh_uvs=put(muv, torch.float32),
        mesh_tex=TextureSet(
            torch.as_tensor(np.stack(texs), device=dev),
            torch.as_tensor(seq_id, dtype=torch.int64, device=dev),
        ),
        targets=targets,
        seq_id=seq_id,
    )


def _frames(batch: MultiSeqBatch, sel) -> MultiSeqBatch:
    """The frames ``sel`` (an index tensor) of the pool; textures whole."""
    pick = sel.to(batch.mesh_verts.device)
    return MultiSeqBatch(
        batch.mesh_verts[pick], batch.mesh_faces[pick], batch.mesh_uvs[pick],
        TextureSet(batch.mesh_tex.textures, batch.mesh_tex.index[pick]),
        RF.FrameTargets(*(x[pick.to(x.device)] for x in batch.targets)),
        batch.seq_id[sel.cpu().numpy()],
    )


def shard_batch(batch: MultiSeqBatch, mesh, axis_name="frames") -> MultiSeqBatch:
    """This rank's contiguous shard of the pooled frames
    (``mesh.shard_leading`` of every per-frame leaf; the textures, one per
    sequence, stay whole).  The pool must divide the mesh axis
    (``mesh.pad_to_multiple`` it first)."""
    n = batch.mesh_verts.shape[0]
    size = PM.axis_size(mesh, axis_name)
    if n % size:
        raise ValueError(f"a pool of {n} frames does not divide {size} ranks; pad it first")
    sel = PM.shard_leading(torch.arange(n), mesh, axis_name)
    return _frames(batch, sel)


def refine_poses_multi(
    batch: MultiSeqBatch,
    rot_init_row: Tensor,
    trans_init: Tensor,
    dino_params: dict[str, Any] | None,
    dino_cfg: dino_mod.DinoConfig | None,
    cfg: RF.RefineConfig = RF.RefineConfig(),
    iters_per_launch: int = 25,
    frames_per_launch: int | None = None,
    device: str | torch.device | None = None,
    frame_mesh=None,
    axis_name: str | tuple[str, ...] = "frames",
) -> RF.RefineResult:
    """Like ``tracker.refine.refine_poses``, over PER-FRAME meshes (the
    pooled multi-sequence batch): one ``torch.optim.Adam`` over every
    frame's {rot6d, trans}, the per-frame losses summed, the largest
    overflow carried and warned on.

    ``frames_per_launch`` micro-batches the frame axis on the host:
    fine-mode frames are independent (per-frame parameters and Adam state,
    a summed loss), so each group of that many frames is refined on its
    own, the last group padded by repeating the pool's first frame and the
    results sliced back.  Default: FRAMES_PER_CARD x the ranks of
    ``frame_mesh``'s ``axis_name`` in fine mode (the JAX package's
    FRAMES_PER_CARD x its devices), the whole pool in coarse mode.

    ``frame_mesh``: the pool is sharded over ``axis_name`` (a tuple, such
    as ``("seq", "frames")`` of ``mesh.make_seq_frame_mesh``, flattens
    several axes): ``batch`` (``shard_batch``) and the inits are this
    rank's shards, each group puts its frames on the ranks evenly
    (FRAMES_PER_CARD a card in fine mode), the result holds this rank's
    frames (``mesh.gather_leading`` gathers them) and the overflow is the
    largest of every rank.  ``iters_per_launch`` is accepted and ignored,
    as ``refine_poses`` ignores it: the port runs one plain loop, with no
    retry.  ``device``: None = the CUDA card (raises without one); "cpu"
    runs the kernels' plain versions.
    """
    del iters_per_launch
    dev = resolve_device(device)
    rot_init_row = torch.as_tensor(rot_init_row, dtype=torch.float32, device=dev)
    n_pool = int(rot_init_row.shape[0])  # this rank's frames
    trans_init = torch.as_tensor(trans_init, dtype=torch.float32, device=dev).reshape(n_pool, 1, 3)
    n_dev = PM.axis_size(frame_mesh, axis_name)
    if frames_per_launch is None:
        frames_per_launch = FRAMES_PER_CARD * n_dev if cfg.mode == "fine" else n_pool * n_dev
    g = max(1, min(-(-frames_per_launch // n_dev), n_pool))
    pad = (-n_pool) % g
    order = torch.cat([torch.arange(n_pool), torch.zeros(pad, dtype=torch.int64)])
    parts = []
    max_ov = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(0, n_pool + pad, g):
        sel = order[i : i + g]
        sub = batch if g == n_pool else _frames(batch, sel)
        mesh = RF.MeshArrays(sub.mesh_verts, sub.mesh_faces, sub.mesh_uvs, sub.mesh_tex)
        mesh, targets, params = RF.place_inputs(mesh, sub.targets, dino_params, cfg, dev)
        pick = sel.to(dev)
        result, ov, _ = RF._refine_launch(
            mesh, targets, rot_init_row[pick], trans_init[pick], params, dino_cfg, cfg
        )
        parts.append(result)
        max_ov = torch.maximum(max_ov, ov)
    max_overflow = int(PM.all_reduce(max_ov, frame_mesh, axis_name, op="max"))
    RF.warn_overflow(max_overflow, "pooled refinement")
    return RF.RefineResult(
        *(torch.cat([getattr(p, k) for p in parts])[:n_pool] for k in RF.RefineResult._fields[:4]),
        max_overflow=max_overflow,
    )


def pooled_caps(batch: MultiSeqBatch, rot_row: Tensor, trans: Tensor, crop_size: int,
                sigma: float, headroom: float = 1.5) -> tuple[int, int | None, int, int]:
    """(per-tile face cap, active-tile cap or None, worst tile load, most
    active tiles) of the pooled refine, counted over ALL pooled frames at
    these poses as ``run_multi.py`` counts them (margin 6 sigma + 1, the
    headroom, multiples of 128 and 8).  Padding faces count where vertex 0
    projects, as in the reference.  Reads the device once."""
    from ..ops.rasterize import project_perspective
    from ..ops.rasterize_tiled import max_active_tiles_load, max_tile_load

    s = crop_size
    K = batch.targets.K_rois
    verts = batch.mesh_verts.to(K.device)
    faces = batch.mesh_faces.to(K.device)
    vp = project_perspective(verts @ rot_row.to(K.device) + trans.to(K.device).reshape(-1, 1, 3), K)
    margin = 6.0 * sigma + 1.0
    worst, active = torch.stack([
        max_tile_load(vp, faces, (s, s), margin=margin).max(),
        max_active_tiles_load(vp, faces, (s, s), margin=margin).max(),
    ]).tolist()
    cap = max(256, min(-(-int(worst * headroom) // 128) * 128, int(faces.shape[1])))
    t_total = (-(-s // 16)) ** 2
    act = max(8, min(-(-int(active * headroom) // 8) * 8, t_total))
    return cap, (act if act < t_total else None), int(worst), int(active)

