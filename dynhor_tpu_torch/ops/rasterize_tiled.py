"""Tile-binned rasterization (PyTorch, batched over frames).

Port of ``dynhor_tpu/ops/rasterize_tiled.py``: faces are assigned to the
TxT pixel tiles their (margin-expanded) screen bbox overlaps, with a
per-tile face cap that callers count per scene (``max_tile_load``).  A tile
that overflows the cap keeps its LOWEST face ids, and the overflow count is
returned so callers can surface it.

The binning serves the fused raster (ops/raster_fused.py), the separate
soft silhouette (ops/silhouette_kernel.py) and the two plain tiled
rasterizers here, ``soft_silhouette_tiled`` and ``rasterize_tiled`` (the
JAX package's non-TPU path), which rasterize ``tile_chunk`` tiles at a time
against their binned faces: each chunk streams (B, chunk, tile², cap)
temporaries, about 0.74 GB each at 8 frames, 64 tiles and cap 1408.

The JAX package evaluates two lookups as one-hot reductions over the tile
axis because element gathers were slow on its TPU; here they are plain
``torch.gather`` calls with the same values.  Nothing here syncs the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from .rasterize import Fragments, barycentrics_at, pixel_centers
from .silhouette import face_pixel_bary, softplus_mass

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


def _tile_grid(h: int, w: int, tile: int, device):
    """In-tile pixel centers (P,) and each tile's origin (T,), row-major."""
    th, tw = _grid((h, w), tile)
    i = torch.arange(tile, dtype=torch.float32, device=device) + 0.5
    py = i[:, None].expand(tile, tile).reshape(-1)
    px = i[None, :].expand(tile, tile).reshape(-1)
    t = torch.arange(th * tw, dtype=torch.float32, device=device)
    oy = torch.div(t, tw, rounding_mode="floor") * tile
    ox = torch.remainder(t, tw) * tile
    return px, py, ox, oy, th, tw


def _chunk_faces(fv_all: Tensor, idx: Tensor) -> Tensor:
    """(B, C, M, 3, 3) vertices of the binned faces ``idx`` (B, C, M)."""
    b = fv_all.shape[0]
    return fv_all[torch.arange(b, device=idx.device)[:, None, None], idx]


def _detile(x: Tensor, th: int, tw: int, tile: int, h: int, w: int) -> Tensor:
    """(B, T, tile*tile, ...) row-major tiles -> (B, H, W, ...)."""
    b = x.shape[0]
    rest = x.shape[3:]
    x = x.reshape((b, th, tw, tile, tile) + rest).transpose(2, 3)
    return x.reshape((b, th * tile, tw * tile) + rest)[:, :h, :w]


def soft_silhouette_tiled(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    tile: int = 16,
    max_faces: int = 640,
    tile_chunk: int = 64,
    znear: float = 1e-2,
) -> Tensor:
    """Tile-binned soft silhouette of B frames; the semantics of
    ``ops.silhouette.soft_silhouette``, binned at margin 6 sigma + 1.

    Plain PyTorch, ``tile_chunk`` tiles at a time, each chunk recomputed in
    the backward (``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint``).  Faces dropped by the per-tile cap are dropped
    silently, as in the JAX package.

    Args:
      verts_pix: (B, V, 3) projected (u, v, z); gradients flow to these.
      faces: (F, 3).

    Returns: (B, H, W) coverage in [0, 1].
    """
    h, w = image_size
    bins = bin_faces(verts_pix, faces, image_size, tile, max_faces, margin=6.0 * sigma + 1.0)
    px, py, ox, oy, th, tw = _tile_grid(h, w, tile, verts_pix.device)
    fv_all = verts_pix[:, faces.long()]  # (B, F, 3, 3)
    chunks = []
    for c in range(0, th * tw, tile_chunk):
        fv = _chunk_faces(fv_all, bins.indices[:, c : c + tile_chunk])
        pxx = (ox[c : c + tile_chunk, None] + px[None, :])[..., None]  # (C, P, 1)
        pyy = (oy[c : c + tile_chunk, None] + py[None, :])[..., None]
        chunks.append(checkpoint(
            softplus_mass, fv, bins.valid[:, c : c + tile_chunk], pxx, pyy, sigma, znear,
            use_reentrant=False,
        ))
    mass = torch.cat(chunks, dim=1)  # (B, T, P)
    return _detile(1.0 - torch.exp(-mass), th, tw, tile, h, w)


def rasterize_tiled(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    max_faces: int = 640,
    tile_chunk: int = 64,
    znear: float = 1e-2,
) -> Fragments:
    """Tile-binned hard z-buffer raster of B frames; the semantics of
    ``ops.rasterize.rasterize``, binned at margin 0.

    Per pixel the min depth over the tile's covering faces with z > znear
    wins; on equal depths the first (lowest) slot wins; a pixel no face
    covers has depth inf, so pix_to_face -1 and zbuf -1.  The hard decisions
    are made without autograd, ``tile_chunk`` tiles at a time; the
    barycentrics and the depth of the winning face are then evaluated once
    per pixel, in the order of operations of the tile pass, so their values
    equal it and their gradients are those of the depth the pass selected.

    Returns: Fragments with (B, H, W) maps.
    """
    b = verts_pix.shape[0]
    h, w = image_size
    bins = bin_faces(verts_pix, faces, image_size, tile, max_faces, margin=0.0)
    px, py, ox, oy, th, tw = _tile_grid(h, w, tile, verts_pix.device)
    fids = []
    with torch.no_grad():
        fv_all = verts_pix[:, faces.long()]
        for c in range(0, th * tw, tile_chunk):
            idx = bins.indices[:, c : c + tile_chunk]
            gx = (ox[c : c + tile_chunk, None] + px[None, :])[..., None]  # (C, P, 1)
            gy = (oy[c : c + tile_chunk, None] + py[None, :])[..., None]
            verts, (w0, w1, w2), inside, _ = face_pixel_bary(_chunk_faces(fv_all, idx), gx, gy)
            z = w0 * verts[0][2] + w1 * verts[1][2] + w2 * verts[2][2]
            ok = inside & (z > znear) & bins.valid[:, c : c + tile_chunk, None, :]
            zmin, j = torch.where(ok, z, float("inf")).min(dim=-1)  # first minimal slot
            fid = torch.gather(idx, 2, j)
            fids.append(torch.where(torch.isfinite(zmin), fid, -1))
    pix_to_face = _detile(torch.cat(fids, dim=1), th, tw, tile, h, w).to(torch.int32)
    gx, gy = pixel_centers(h, w, verts_pix.device)
    flat = pix_to_face.reshape(b, -1)
    bary = barycentrics_at(verts_pix, faces, flat, gx, gy)  # (B, P, 3)
    fz = verts_pix[..., 2][:, faces.long()]  # (B, F, 3)
    zf = torch.gather(fz, 1, flat.long().clamp_min(0)[..., None].expand(-1, -1, 3))
    z = bary[..., 0] * zf[..., 0] + bary[..., 1] * zf[..., 1] + bary[..., 2] * zf[..., 2]
    hit = flat >= 0
    return Fragments(
        pix_to_face=pix_to_face,
        bary=torch.where(hit[..., None], bary, 0.0).reshape(b, h, w, 3),
        zbuf=torch.where(hit, z, -1.0).reshape(b, h, w),
    )
