"""Tile-binned soft silhouette around a hand-written CUDA kernel.

Port of ``dynhor_tpu/ops/silhouette_pallas.py`` (``soft_silhouette_pallas``,
the drop-in replacement for ``soft_silhouette_tiled``): faces are binned to
16x16 pixel tiles at the silhouette's margin (6 sigma + 1), packed per tile
and reduced per pixel to the softplus mass of the tile's visible faces.  No
depth, no hard raster: ``ops/raster_fused.rasterize_silhouette`` gives both
in one pass.

The per-tile work is two kernels (csrc/raster_fused.cu, bound in
dynhor_tpu_torch/kernels.py):

  * K4a ``tile_masses`` — the per-pixel mass (replaces ``_fwd_kernel``);
  * K4b — d(mass)/d(slot xy) (replaces ``_bwd_kernel``), which computes K2's
    function, so it is K2's kernel launched on these rows
    (``kernels.sil_mass_bwd``) and K2's plain version on the CPU.

The binning and the row packing are the fused raster's (``bin_faces``,
``_face_rows``, ``_pack_tile_rows``, without compaction): the rows are K1's
16-float records, padding slots have vis = 0, and each tile's count stops
the kernels.  The gradient reaches the vertices through the packing's
``torch.gather``, whose transpose is a scatter-add, as the JAX package
leaves it to XLA.  Linear distance only, as everywhere in the port.
"""
from __future__ import annotations

import torch

from .. import kernels
from .raster_fused import (
    _PLAIN_CHUNK, _ROW, _face_rows, _pack_tile_rows, _pair_geometry, _softplus,
    _tile_pixels, tile_mass_grad_plain,
)
from .rasterize_tiled import _detile, bin_faces

Tensor = torch.Tensor


def tile_mass_plain(
    rows: Tensor, counts: Tensor, tile: int, tiles_w: int, sigma: float
) -> Tensor:
    """Plain version of K4a.  rows (B, T, M, 16) f32, counts (B, T) int32.

    Per pixel, over each tile's first ``count`` slots: the sum of
    softplus(+-dist/sigma) over visible faces (dist the linear distance to
    the nearest edge, + inside).  Returns mass (B, T, P) f32.
    """
    b, t_rows, m, _ = rows.shape
    px, py = _tile_pixels(t_rows, tile, tiles_w, rows.device)
    mass = rows.new_zeros((b, t_rows, tile * tile))
    slot = torch.arange(m, device=rows.device)
    m_used = int(counts.max()) if counts.numel() else 0  # slots past it add nothing
    for s in range(0, m_used, _PLAIN_CHUNK):
        r = rows[:, :, None, s : s + _PLAIN_CHUNK]  # (B, T, 1, C, 16)
        keep = (slot[s : s + _PLAIN_CHUNK] < counts[..., None])[:, :, None, :]
        _, _, sign, _, d2, visible = _pair_geometry(r, px, py)
        logit = sign * torch.sqrt(d2.clamp_min(1e-12)) / sigma
        mass = mass + torch.where(visible & keep, _softplus(logit), 0.0).sum(-1)
    return mass


def tile_masses(rows, counts, tile, tiles_w, sigma):
    """K4a: ``tile_mass_plain`` on the CPU, the CUDA kernel otherwise."""
    if rows.device.type == "cpu":
        return tile_mass_plain(rows, counts, tile, tiles_w, sigma)
    return kernels.sil_mass_fwd(rows, counts, tile, tiles_w, sigma)


def tile_mass_grads(rows, counts, g, tile, tiles_w, sigma):
    """K4b: ``tile_mass_grad_plain`` on the CPU, K2's CUDA kernel otherwise."""
    if rows.device.type == "cpu":
        return tile_mass_grad_plain(rows, counts, g, tile, tiles_w, sigma)
    return kernels.sil_mass_bwd(rows, counts, g, tile, tiles_w, sigma)


class _TileMasses(torch.autograd.Function):
    """K4a forward, K4b backward on packed tile rows; the backward returns
    d(rows) with the six xy columns filled and the rest zero."""

    @staticmethod
    def forward(ctx, rows, counts, tile, tiles_w, sigma):
        ctx.save_for_backward(rows, counts)
        ctx.params = (tile, tiles_w, sigma)
        return tile_masses(rows, counts, tile, tiles_w, sigma)

    @staticmethod
    def backward(ctx, g_mass):
        rows, counts = ctx.saved_tensors
        dxy = tile_mass_grads(rows, counts, g_mass.contiguous(), *ctx.params)
        d_rows = torch.cat([dxy, dxy.new_zeros(dxy.shape[:3] + (_ROW - 6,))], dim=-1)
        return d_rows, None, None, None, None


def kernel_inputs(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
):
    """(rows (B, T, M, 16), counts (B, T) int32, tiles_w): the K4a/K4b inputs
    ``soft_silhouette_kernel`` packs for this scene."""
    bins = bin_faces(verts_pix, faces, image_size, tile, max_faces, margin=6.0 * sigma + 1.0)
    tw = -(-image_size[1] // tile)
    rows, counts = _pack_tile_rows(
        _face_rows(verts_pix, faces, znear), bins.indices, bins.valid, None, tile, tw
    )
    return rows, counts, tw


def soft_silhouette_kernel(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
) -> Tensor:
    """Tile-binned soft silhouette of B frames of one mesh; the semantics of
    ``rasterize_tiled.soft_silhouette_tiled``.

    One ``bin_faces`` at margin 6 sigma + 1, one K4a launch for all frames,
    and in the backward one K4b launch.  A face is visible when its bin slot
    is valid and any vertex lies beyond ``znear``.  Faces dropped by the
    per-tile cap are dropped silently, as in the JAX package; size the cap
    with ``rasterize_tiled.max_tile_load``.

    Args:
      verts_pix: (B, V, 3) projected (u, v, z); gradients flow to these.
      faces: (F, 3).

    Returns: (B, H, W) coverage in [0, 1].
    """
    h, w = image_size
    rows, counts, tw = kernel_inputs(verts_pix, faces, image_size, sigma, tile, max_faces, znear)
    mass = _TileMasses.apply(rows, counts, tile, tw, sigma)
    return _detile(1.0 - torch.exp(-mass), -(-h // tile), tw, tile, h, w)
