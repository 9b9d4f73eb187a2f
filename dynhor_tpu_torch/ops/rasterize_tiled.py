"""Tile binning for the fused raster (PyTorch, batched over frames).

Port of the binning half of ``dynhor_tpu/ops/rasterize_tiled.py``: faces
are assigned to the TxT pixel tiles their (margin-expanded) screen bbox
overlaps, with a per-tile face cap that callers count per scene
(``max_tile_load``).  A tile that overflows the cap keeps its LOWEST face
ids, and the overflow count is returned so callers can surface it.

The JAX package evaluates two lookups as one-hot reductions over the tile
axis because element gathers were slow on its TPU; here they are plain
``torch.gather`` calls with the same values.  Nothing here syncs the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class FaceBins(NamedTuple):
    indices: Tensor  # (B, T, max_faces) int64 face ids (padded with 0)
    valid: Tensor  # (B, T, max_faces) bool
    overflow: Tensor  # (B,) int32 — faces dropped across tiles, per frame


def face_screen_bboxes(verts_pix: Tensor, faces: Tensor, znear: float = 1e-2):
    """Per-face screen bbox (B, F, 4) xyxy + a per-face visibility mask.

    Faces with ALL vertices behind znear are excluded; exact point-faces
    (all three vertices identical) can never cover a pixel and are excluded
    too, so they take no cap slots.
    """
    fv = verts_pix[:, faces.long()]  # (B, F, 3, 3)
    xy = fv[..., :2]
    lo = xy.amin(dim=2)
    hi = xy.amax(dim=2)
    vis = (fv[..., 2] > znear).any(dim=2) & (hi > lo).any(dim=-1)
    return torch.cat([lo, hi], dim=-1), vis


def _grid(image_size: tuple[int, int], tile: int) -> tuple[int, int]:
    h, w = image_size
    return -(-h // tile), -(-w // tile)


def _expanded_boxes(verts_pix, faces, margin):
    bboxes, vis = face_screen_bboxes(verts_pix, faces)
    return (
        bboxes[..., 0] - margin, bboxes[..., 1] - margin,
        bboxes[..., 2] + margin, bboxes[..., 3] + margin, vis,
    )


def _tile_overlap(verts_pix, faces, image_size, tile, margin) -> Tensor:
    """(B, T, F) bool: face f's expanded bbox overlaps tile t (and f is
    visible).  T is row-major over the (th, tw) tile grid."""
    th, tw = _grid(image_size, tile)
    x1, y1, x2, y2, vis = _expanded_boxes(verts_pix, faces, margin)
    dev = verts_pix.device
    ty = (torch.arange(th, device=dev) * tile).float()[None, :, None]
    tx = (torch.arange(tw, device=dev) * tile).float()[None, :, None]
    ox = (x1[:, None, :] < tx + tile) & (x2[:, None, :] > tx)  # (B, tw, F)
    oy = (y1[:, None, :] < ty + tile) & (y2[:, None, :] > ty)  # (B, th, F)
    overlap = (oy[:, :, None, :] & ox[:, None, :, :]).reshape(
        verts_pix.shape[0], th * tw, -1
    )
    return overlap & vis[:, None, :]


def bin_faces(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    max_faces: int = 640,
    margin: float = 2.0,
) -> FaceBins:
    """Assign faces to the tiles their (margin-expanded) bbox overlaps: the
    ``max_faces`` smallest overlapping face ids per tile, ascending."""
    overlap = _tile_overlap(verts_pix, faces, image_size, tile, margin)
    return _bins(overlap, max_faces)


def _bins(overlap: Tensor, max_faces: int) -> FaceBins:
    f = overlap.shape[-1]
    max_faces = min(max_faces, f)  # tiny meshes: cap can't exceed F
    ids = torch.arange(f, device=overlap.device)
    keyed = torch.where(overlap, -ids, -(10**9))
    top_vals = torch.topk(keyed, max_faces, dim=-1, sorted=True).values
    valid = top_vals > -(10**9)
    indices = torch.where(valid, -top_vals, 0)
    overflow = (overlap.sum(-1) - valid.sum(-1)).sum(-1).to(torch.int32)
    return FaceBins(indices, valid, overflow)


def face_tile_inverse(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    max_faces: int = 640,
    margin: float = 2.0,
    k_max: int = 32,
):
    """Inverse of ``bin_faces``: for each FACE, the (tile, slot) positions
    it was packed into, as flat indices into a (T * max_faces) array.

    A face's candidate tiles are the grid rectangle its expanded bbox
    overlaps, and ``bin_faces`` packs slots in ascending face-id order, so
    slot(t, f) is the overlap-matrix cumsum.  This turns the backward of the
    per-tile row gather into an (F x k_max)-row GATHER.

    Returns (inv_flat (B, F, k_max) int64, inv_valid (B, F, k_max) bool,
    k_overflow (B,) int32 — face-tile pairs whose gradient contributions
    are DROPPED because a face overlaps more than k_max tiles).
    """
    overlap = _tile_overlap(verts_pix, faces, image_size, tile, margin)
    return _inverse(overlap, verts_pix, faces, image_size, tile, max_faces, margin, k_max)


def bin_faces_and_inverse(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int,
    max_faces: int,
    margin: float,
    k_max: int,
):
    """``bin_faces`` and ``face_tile_inverse`` of the same inputs, from one
    (B, T, F) overlap matrix."""
    overlap = _tile_overlap(verts_pix, faces, image_size, tile, margin)
    return _bins(overlap, max_faces), _inverse(
        overlap, verts_pix, faces, image_size, tile, max_faces, margin, k_max
    )


def _inverse(overlap, verts_pix, faces, image_size, tile, max_faces, margin, k_max):
    h, w = image_size
    th, tw = _grid(image_size, tile)
    max_faces = min(max_faces, faces.shape[0])
    slots = torch.cumsum(overlap, dim=-1) - 1  # (B, T, F)
    x1, y1, x2, y2, vis = _expanded_boxes(verts_pix, faces, margin)

    # Tile rectangle of each face (clamped to the grid).
    tx0 = torch.floor(x1 / tile).long().clamp(0, tw - 1)
    tx1 = torch.floor((x2 - 1e-6) / tile).long().clamp(0, tw - 1)
    ty0 = torch.floor(y1 / tile).long().clamp(0, th - 1)
    ty1 = torch.floor((y2 - 1e-6) / tile).long().clamp(0, th - 1)
    wx = tx1 - tx0 + 1
    wy = ty1 - ty0 + 1
    n_rect = wx * wy
    kk = torch.arange(k_max, device=verts_pix.device)
    tx_k = tx0[..., None] + torch.minimum(
        kk % wx.clamp_min(1)[..., None], wx[..., None] - 1
    )
    ty_k = ty0[..., None] + torch.minimum(
        kk // wx.clamp_min(1)[..., None], wy[..., None] - 1
    )
    t_k = ty_k * tw + tx_k  # (B, F, K)
    in_rect = kk < n_rect[..., None]
    # slot_k = slots[t_k, f]; in_rect & vis & in_grid <=> overlap(t_k, f)
    # (the rect uses bin_faces' strict edge rules; in_grid guards faces
    # whose whole bbox lies outside the image), and slot_k < max_faces <=>
    # the pair was kept by the cap.
    slot_k = torch.gather(slots.transpose(1, 2), 2, t_k)
    in_grid = (x1 < w) & (x2 > 0.0) & (y1 < h) & (y2 > 0.0)
    valid = in_rect & (vis & in_grid)[..., None] & (slot_k < max_faces)
    inv_flat = torch.where(valid, t_k * max_faces + slot_k, 0)
    k_overflow = torch.where(vis, torch.relu(n_rect - k_max), 0).sum(-1)
    return inv_flat, valid, k_overflow.to(torch.int32)


def _tile_loads(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    margin: float = 3.0,
) -> Tensor:
    """(B, T) candidate-face count per tile (integer sums: exact)."""
    return _tile_overlap(verts_pix, faces, image_size, tile, margin).sum(-1)


def max_tile_load(verts_pix, faces, image_size, tile: int = 16, margin: float = 3.0):
    """(B,) max per-tile candidate-face count.  Callers size ``max_faces``
    from it: edge-on poses can pack several thousand faces into one tile."""
    return _tile_loads(verts_pix, faces, image_size, tile, margin).amax(-1).to(torch.int32)


def max_active_tiles_load(
    verts_pix, faces, image_size, tile: int = 16, margin: float = 3.0
):
    """(B,) number of tiles with >= 1 candidate face.  Callers size the
    fused raster's ``max_active_tiles`` from it."""
    loads = _tile_loads(verts_pix, faces, image_size, tile, margin)
    return (loads > 0).sum(-1).to(torch.int32)
