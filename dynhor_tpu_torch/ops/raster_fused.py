"""Fused tile-binned hard raster + soft silhouette (PyTorch around two
hand-written CUDA kernels).

Port of ``dynhor_tpu/ops/raster_pallas.py:rasterize_silhouette_pallas``.
ONE binning and ONE pass per tile give, per pixel:

  * the soft-silhouette mass  (differentiable, analytic backward),
  * the min hit depth         (hard z-buffer, non-differentiable),
  * the winning face slot     (argmin over the tile's face list).

The two per-tile passes are kernels (csrc/raster_fused.cu, bound in
dynhor_tpu_torch/kernels.py):

  * K1 ``tile_mass_depth`` — the forward (replaces ``_fused_fwd_kernel``);
  * K2 ``tile_mass_grad`` — d(mass)/d(face xy) per slot (replaces
    ``_sil_bwd_kernel``).

``rasterize_depth`` (port of ``rasterize_pallas``) is the forward-only hard
raster of the prior views, around a third kernel:

  * K3 ``tile_depth`` — min depth and its slot per pixel, no silhouette
    (replaces ``_depth_fwd_kernel``); it reads each slot's record through
    the bins' face ids, so its path builds no packed rows.

Each has a plain PyTorch version here (``*_plain``).  The dispatchers use
the plain version only for tensors on the CPU; a CUDA tensor launches the
kernel or raises.  pix_to_face/zbuf are hard (PyTorch3D blur_radius=0
semantics); the barycentric/Phong gradient path is plain torch
(ops/rasterize.barycentrics_from_rows).

Face rows are packed per tile for K1/K2 as (B, T, M, 16) records
``[x0 y0 x1 y1 x2 y2 vis pad | z0 z1 z2 pad...]``: slot j of tile t holds
the j-th lowest candidate face id; padding slots have vis = 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .rasterize import Fragments, barycentrics_from_rows, face_verts, pixel_centers
from .rasterize_tiled import _detile, bin_faces, bin_faces_and_inverse

Tensor = torch.Tensor

_BIG_Z = 3.0e38  # "no hit" depth sentinel
_ROW = 16  # floats per packed face record
_PLAIN_CHUNK = 128  # default slots per step of the plain versions (a memory knob)


class CompactTiles(NamedTuple):
    """Active-tile raster outputs in the COMPACTED tile layout (for
    ops/shading.phong_shade_tiles, which shades only active tiles).

    Attributes:
      act_ids: (B, t_act) int64 dense tile index of each compacted row
        (sentinel t_total for padding rows past the true active count).
      fid: (B, t_act, tile*tile) int32 winning face per pixel, -1 = no hit.
      bary: (B, t_act, tile*tile, 3) barycentrics (0 where no hit),
        differentiable w.r.t. the projected vertices.
    """

    act_ids: Tensor
    fid: Tensor
    bary: Tensor


# --------------------------------------------------------------------------
# Plain versions of the two kernels.  Same arithmetic, same order of
# operations per (pixel, slot) pair; the kernels are compiled without FMA
# contraction so the hard decisions (inside test, depth argmin, winning
# segment) agree, and both sides spell out the fused multiply-adds of _seg.
# --------------------------------------------------------------------------


def _tile_pixels(t_rows: int, tile: int, tiles_w: int, device):
    """(T, P, 1) pixel-center coordinates of each tile ROW's assumed origin
    ((t % tiles_w) * tile, (t // tiles_w) * tile)."""
    idx = torch.arange(tile * tile, device=device)
    t = torch.arange(t_rows, device=device)
    ox = ((t % tiles_w) * tile).float()[:, None]
    oy = ((t // tiles_w) * tile).float()[:, None]
    px = (idx % tile).float()[None, :] + 0.5 + ox
    py = (idx // tile).float()[None, :] + 0.5 + oy
    return px[..., None], py[..., None]


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """a * b + c rounded once to f32, as the kernels' fmaf: the f64 product
    of two f32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _seg(ax, ay, bx, by, px, py):
    """Clipped projection t, offset (dx, dy) and squared distance from the
    pixel to segment (a, b).  Its four a * b + c forms are fused, as XLA
    fuses them when it compiles the reference on the CPU: near a corner two
    segments' distances nearly tie, and the winner decides which vertices
    get the pixel's gradient."""
    abx = bx - ax
    aby = by - ay
    apx = px - ax
    apy = py - ay
    denom = _fma(abx, abx, aby * aby)
    t = (_fma(apx, abx, apy * aby) / denom.clamp_min(1e-12)).clamp(0.0, 1.0)
    dx = _fma(-t, abx, apx)
    dy = _fma(-t, aby, apy)
    return t, dx, dy, _fma(dx, dx, dy * dy)


def _barycentric(r: Tensor, px: Tensor, py: Tensor):
    """Per (pixel, slot) barycentrics and inside test, the formulation all
    three kernels share.  r: (B, T, 1, C, 16) slot records.  Returns
    ((w0, w1, w2), inside, nondegen)."""
    x0, y0, x1, y1 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    x2, y2 = r[..., 4], r[..., 5]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    degen = area.abs() < 1e-12
    inv_area = torch.where(degen, 0.0, 1.0 / torch.where(degen, 1.0, area))
    w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv_area
    w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv_area
    w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv_area
    nondegen = area.abs() > 1e-12
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & nondegen
    return (w0, w1, w2), inside, nondegen


def _pair_geometry(r: Tensor, px: Tensor, py: Tensor):
    """Per (pixel, slot) barycentrics, inside test and the three
    point-segment terms.  r: (B, T, 1, C, 16) slot records."""
    x0, y0, x1, y1 = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    x2, y2, vis = r[..., 4], r[..., 5], r[..., 6]
    w, inside, nondegen = _barycentric(r, px, py)
    sign = torch.where(inside, 1.0, -1.0)
    s01 = _seg(x0, y0, x1, y1, px, py)
    s12 = _seg(x1, y1, x2, y2, px, py)
    s20 = _seg(x2, y2, x0, y0, px, py)
    d2 = torch.minimum(s01[3], torch.minimum(s12[3], s20[3]))
    visible = (vis > 0.5) & nondegen
    return w, inside, sign, (s01, s12, s20), d2, visible


def _softplus(x: Tensor) -> Tensor:
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def tile_mass_depth_plain(
    rows: Tensor, counts: Tensor, tile: int, tiles_w: int, sigma: float,
    znear: float, chunk: int = _PLAIN_CHUNK,
):
    """Plain version of K1.  rows (B, T, M, 16) f32, counts (B, T) int32.

    Per pixel, over each tile's first ``count`` slots: mass = sum of
    softplus(+-dist/sigma) over visible faces (dist the linear distance to
    the nearest edge), the min interpolated depth
    over covering faces with z > znear, and its slot (strict <: the first
    slot wins).  Returns mass, zmin (B, T, P) f32 and jbest (B, T, P) int32.

    The slots go ``chunk`` at a time, merged as the kernel merges its work
    items: masses summed in chunk order, and a chunk's (depth, slot) taken
    only where it is strictly smaller, so the hard outputs do not depend on
    ``chunk``.
    """
    b, t_rows, m, _ = rows.shape
    p = tile * tile
    px, py = _tile_pixels(t_rows, tile, tiles_w, rows.device)
    mass = rows.new_zeros((b, t_rows, p))
    zmin = rows.new_full((b, t_rows, p), _BIG_Z)
    jbest = torch.zeros((b, t_rows, p), dtype=torch.int64, device=rows.device)
    slot = torch.arange(m, device=rows.device)
    for s in range(0, m, chunk):
        r = rows[:, :, None, s : s + chunk]  # (B, T, 1, C, 16)
        keep = (slot[s : s + chunk] < counts[..., None])[:, :, None, :]
        (w0, w1, w2), inside, sign, _, d2, visible = _pair_geometry(r, px, py)
        logit = sign * torch.sqrt(d2.clamp_min(1e-12)) / sigma
        live = visible & keep
        mass = mass + torch.where(live, _softplus(logit), 0.0).sum(-1)
        z = w0 * r[..., 8] + w1 * r[..., 9] + w2 * r[..., 10]
        zm = torch.where(inside & (z > znear) & live, z, _BIG_Z)
        zc, jc = zm.min(dim=-1)  # first minimal slot of the chunk
        better = zc < zmin
        zmin = torch.where(better, zc, zmin)
        jbest = torch.where(better, jc + s, jbest)
    return mass, zmin, jbest.to(torch.int32)


def tile_mass_grad_plain(
    rows: Tensor, counts: Tensor, g: Tensor, tile: int, tiles_w: int,
    sigma: float, chunk: int = _PLAIN_CHUNK,
) -> Tensor:
    """Plain version of K2: the analytic VJP of K1's mass w.r.t. each slot's
    six xy values, given g = d(loss)/d(mass) (B, T, P).

    Only logit <- d2 <- min of three point-segment distances is
    differentiable.  For the winning segment (a, b) (priority 01 > 12 > 20
    on exact ties) with clipped projection t, the envelope theorem gives
    dd2/da = 2(t-1)(dx, dy), dd2/db = -2t(dx, dy).  vis and z get no
    gradient.  Returns (B, T, M, 6) [x0 y0 x1 y1 x2 y2] f32 cotangents, zero
    for slots >= count.

    Works in f32, as the kernel does, ``chunk`` slots at a time (each slot's
    sums are the same whatever ``chunk``).
    """
    b, t_rows, m, _ = rows.shape
    px, py = _tile_pixels(t_rows, tile, tiles_w, rows.device)
    gp = g[..., None]  # (B, T, P, 1)
    slot = torch.arange(m, device=rows.device)
    m_used = int(counts.max()) if counts.numel() else 0  # slots past it get 0
    out = []
    for s in range(0, m_used, chunk):
        r = rows[:, :, None, s : s + chunk]
        keep = (slot[s : s + chunk] < counts[..., None])[:, :, None, :]
        _, _, sign, segs, d2, visible = _pair_geometry(r, px, py)
        d2s = d2.clamp_min(1e-12)
        logit = sign * torch.sqrt(d2s) / sigma
        dfac = torch.where(d2 > 1e-12, 0.5 / (sigma * torch.sqrt(d2s)), 0.0)
        coef = torch.where(
            visible & keep, gp * torch.sigmoid(logit) * sign * dfac, 0.0
        )
        (t01, dx01, dy01, d01), (t12, dx12, dy12, d12), (t20, dx20, dy20, _) = segs
        w01 = d01 <= d2
        w12 = (d12 <= d2) & ~w01
        w20 = ~w01 & ~w12

        def ends(win, t, dx, dy):
            c = torch.where(win, coef, 0.0)
            ga = (c * 2.0 * (t - 1.0) * dx, c * 2.0 * (t - 1.0) * dy)
            gb = (c * -2.0 * t * dx, c * -2.0 * t * dy)
            return ga, gb

        (a01x, a01y), (b01x, b01y) = ends(w01, t01, dx01, dy01)
        (a12x, a12y), (b12x, b12y) = ends(w12, t12, dx12, dy12)
        (a20x, a20y), (b20x, b20y) = ends(w20, t20, dx20, dy20)
        per_pixel = torch.stack(
            [a01x + b20x, a01y + b20y, b01x + a12x, b01y + a12y, b12x + a20x, b12y + a20y],
            dim=-1,
        )  # (B, T, P, C, 6)
        out.append(per_pixel.sum(2)[:, :, : m_used - s])
    out.append(rows.new_zeros((b, t_rows, m - m_used, 6)))
    return torch.cat(out, dim=2).float()


def tile_depth_plain(
    rows_all: Tensor, indices: Tensor, counts: Tensor, tile: int, tiles_w: int,
    znear: float, chunk: int = _PLAIN_CHUNK,
):
    """Plain version of K3: K1's forward without the mass, reading each
    slot's record through the bins.  rows_all (B, F, 16) f32 per-face
    records, indices (B, T, M) integer face ids per tile slot, counts (B, T)
    int32: slot j of tile t holds record rows_all[b, indices[b, t, j]] for
    j < count (``bin_faces`` keeps the valid slots a prefix of each row).

    Per pixel, over each tile's first ``count`` slots: the min interpolated
    depth over covering faces with vis > 0.5 and z > znear, and its slot
    (strict <: the first slot wins).  Returns zmin (B, T, P) f32 (3e38 where
    nothing covers the pixel) and jbest (B, T, P) int32 (0 there).  The
    slots go ``chunk`` at a time (a memory knob; the outputs do not depend on
    it), each chunk's records gathered as the kernel stages them.
    """
    b, t_rows, m = indices.shape
    p = tile * tile
    px, py = _tile_pixels(t_rows, tile, tiles_w, rows_all.device)
    zmin = rows_all.new_full((b, t_rows, p), _BIG_Z)
    jbest = torch.zeros((b, t_rows, p), dtype=torch.int64, device=rows_all.device)
    slot = torch.arange(m, device=rows_all.device)
    m_used = int(counts.max()) if counts.numel() else 0  # slots past it add nothing
    for s in range(0, m_used, chunk):
        idx = indices[:, :, s : s + chunk].long()
        c = idx.shape[2]
        r = torch.gather(
            rows_all, 1, idx.reshape(b, -1, 1).expand(-1, -1, _ROW)
        ).reshape(b, t_rows, 1, c, _ROW)  # (B, T, 1, C, 16)
        keep = (slot[s : s + c] < counts[..., None])[:, :, None, :]
        (w0, w1, w2), inside, _ = _barycentric(r, px, py)
        z = w0 * r[..., 8] + w1 * r[..., 9] + w2 * r[..., 10]
        live = inside & (z > znear) & (r[..., 6] > 0.5) & keep
        zc, jc = torch.where(live, z, _BIG_Z).min(dim=-1)  # first minimal slot
        better = zc < zmin
        zmin = torch.where(better, zc, zmin)
        jbest = torch.where(better, jc + s, jbest)
    return zmin, jbest.to(torch.int32)


# --------------------------------------------------------------------------
# Dispatch: plain version for CPU tensors, the kernel for CUDA tensors.
# --------------------------------------------------------------------------


def tile_mass_depth(rows, counts, tile, tiles_w, sigma, znear):
    """K1: ``tile_mass_depth_plain`` on the CPU, the CUDA kernel otherwise."""
    if rows.device.type == "cpu":
        return tile_mass_depth_plain(rows, counts, tile, tiles_w, sigma, znear)
    return kernels.fused_fwd(rows, counts, tile, tiles_w, sigma, znear)


def tile_mass_grad(rows, counts, g, tile, tiles_w, sigma):
    """K2: ``tile_mass_grad_plain`` on the CPU, the CUDA kernel otherwise."""
    if rows.device.type == "cpu":
        return tile_mass_grad_plain(rows, counts, g, tile, tiles_w, sigma)
    return kernels.sil_bwd(rows, counts, g, tile, tiles_w, sigma)


def tile_depth(rows_all, indices, counts, tile, tiles_w, znear):
    """K3: ``tile_depth_plain`` on the CPU, the CUDA kernel otherwise."""
    if rows_all.device.type == "cpu":
        return tile_depth_plain(rows_all, indices, counts, tile, tiles_w, znear)
    return kernels.depth_fwd(rows_all, indices, counts, tile, tiles_w, znear)


def _pack_tile_rows(
    rows_all: Tensor, indices: Tensor, valid: Tensor,
    tile_ids: Tensor | None, tile: int, tiles_w: int,
):
    """Gather per-face records into the per-tile layout.  Returns
    (rows (B, T, M, 16), counts (B, T) int32).

    ``tile_ids`` (active-tile compaction): row j holds tile ``tile_ids[j]``
    of the dense grid, but the kernels derive each row's pixel origin from
    its ROW index j.  Shifting the xy values by (true origin - assumed
    origin) makes that frame exact; mass, z, argmin slots and all xy
    gradients are invariant to a constant per-tile shift."""
    b, t_rows, m = indices.shape
    rows = torch.gather(
        rows_all, 1, indices.reshape(b, -1, 1).expand(-1, -1, _ROW)
    ).reshape(b, t_rows, m, _ROW)
    # Padding slots must not contribute: zero their vis value.
    vis = rows[..., 6] * valid.to(rows.dtype)
    rows = torch.cat([rows[..., :6], vis[..., None], rows[..., 7:]], dim=-1)
    if tile_ids is not None:
        pos = torch.arange(t_rows, device=rows.device)
        dx = ((tile_ids % tiles_w) - (pos % tiles_w)).to(rows.dtype) * tile
        dy = ((tile_ids // tiles_w) - (pos // tiles_w)).to(rows.dtype) * tile
        shift = torch.stack([dx, dy, dx, dy, dx, dy], dim=-1)  # (B, T, 6)
        rows = torch.cat([rows[..., :6] - shift[:, :, None, :], rows[..., 6:]], dim=-1)
    counts = valid.sum(-1).to(torch.int32)
    return rows.contiguous(), counts


class _FusedTiles(torch.autograd.Function):
    """K1 forward, K2 backward, with the per-tile GATHER inside the
    boundary: the backward maps per-(tile, slot) gradients back to faces
    through the analytic inverse (rasterize_tiled.face_tile_inverse) — an
    (F x K)-row gather — instead of the (T x M)-row scatter-add transpose
    of the forward gather."""

    @staticmethod
    def forward(
        ctx, rows_all, indices, valid, inv_flat, inv_valid, tile_ids, tile,
        tiles_w, sigma, znear,
    ):
        rows, counts = _pack_tile_rows(rows_all, indices, valid, tile_ids, tile, tiles_w)
        mass, zmin, jbest = tile_mass_depth(rows, counts, tile, tiles_w, sigma, znear)
        ctx.save_for_backward(rows, counts, inv_flat, inv_valid)
        ctx.params = (tile, tiles_w, sigma, rows_all.shape[1])
        ctx.mark_non_differentiable(zmin, jbest)
        return mass, zmin, jbest

    @staticmethod
    def backward(ctx, g_mass, _g_zmin, _g_jbest):
        rows, counts, inv_flat, inv_valid = ctx.saved_tensors
        tile, tiles_w, sigma, n_faces = ctx.params
        dxy = tile_mass_grad(
            rows, counts, g_mass.contiguous(), tile, tiles_w, sigma
        )  # (B, T, M, 6)
        b, k = dxy.shape[0], inv_flat.shape[2]
        flat = dxy.reshape(b, -1, 6)
        picked = torch.gather(
            flat, 1, inv_flat.reshape(b, -1, 1).expand(-1, -1, 6)
        ).reshape(b, n_faces, k, 6)
        d_xy = torch.where(inv_valid[..., None], picked, 0.0).sum(2)  # (B, F, 6)
        d_rows = torch.cat([d_xy, d_xy.new_zeros((b, n_faces, _ROW - 6))], dim=-1)
        return (d_rows,) + (None,) * 9


def _scatter_rows(dense: Tensor, act_ids: Tensor, rows: Tensor) -> Tensor:
    """dense (B, T, ...) with rows (B, t_act, ...) written at act_ids;
    sentinel ids (== T) drop out."""
    b, t_total = dense.shape[:2]
    pad = dense.new_zeros((b, 1) + dense.shape[2:])
    idx = act_ids.reshape(act_ids.shape + (1,) * (rows.dim() - 2)).expand(rows.shape)
    return torch.cat([dense, pad], dim=1).scatter(1, idx, rows)[:, :t_total]


class _TileBins(NamedTuple):
    """Everything the kernels' autograd boundary takes, in the layout of
    the kernel's tile rows (all tiles, or the compacted active ones)."""

    rows_all: Tensor  # (B, F, 16) per-face records (xy differentiable)
    indices: Tensor  # (B, T_k, M) face id per kernel row and slot
    valid: Tensor  # (B, T_k, M)
    inv_flat: Tensor  # (B, F, K) flat (row, slot) of each face's pairs
    inv_valid: Tensor  # (B, F, K)
    act_ids: Tensor | None  # (B, T_k) dense tile per row, sentinel T; None = dense
    tile_ids: Tensor | None  # act_ids clamped into the grid (the row shift)
    dense_indices: Tensor  # (B, T, M) the dense bins (face id lookup)
    overflow: Tensor  # (B,) int32, all three drop counts
    tiles_w: int


def _face_rows(verts_pix: Tensor, faces: Tensor, znear: float) -> Tensor:
    """Per-FACE records (B, F, 16), built once; each tile slot is then ONE
    row gather.  xy differentiable; vis = any(z > znear) and z hard
    (reference semantics).  faces (F, 3) or (B, F, 3)."""
    fv = face_verts(verts_pix, faces)  # (B, F, 3, 3)
    z_ok = (fv[..., 2] > znear).any(-1).to(verts_pix.dtype)
    zero = torch.zeros_like(z_ok)
    return torch.stack(
        [
            fv[..., 0, 0], fv[..., 0, 1], fv[..., 1, 0], fv[..., 1, 1],
            fv[..., 2, 0], fv[..., 2, 1], z_ok, zero,
            fv[..., 0, 2].detach(), fv[..., 1, 2].detach(), fv[..., 2, 2].detach(),
            zero, zero, zero, zero, zero,
        ],
        dim=-1,
    )


def _bin_tiles(
    verts_pix, faces, image_size, sigma, tile, max_faces, znear,
    max_tiles_per_face, max_active_tiles,
) -> _TileBins:
    """One binning at the silhouette's margin, the analytic inverse, the
    per-face records and (optionally) active-tile compaction — without a
    host sync."""
    b = verts_pix.shape[0]
    h, w = image_size
    dev = verts_pix.device
    margin = 6.0 * sigma + 1.0
    bins, (inv_flat, inv_valid, k_overflow) = bin_faces_and_inverse(
        verts_pix, faces, image_size, tile, max_faces, margin, max_tiles_per_face
    )
    t_total, m = bins.indices.shape[1:]
    tw = -(-w // tile)
    rows_all = _face_rows(verts_pix, faces, znear)
    overflow = bins.overflow + k_overflow
    if max_active_tiles is None or max_active_tiles >= t_total:
        return _TileBins(
            rows_all, bins.indices, bins.valid, inv_flat, inv_valid, None, None,
            bins.indices, overflow, tw,
        )
    t_act = -(-max_active_tiles // 8) * 8  # the reference's cap rounding
    active = bins.valid.any(-1)  # (B, T)
    n_active = active.sum(-1)
    # First t_act active tiles in ascending order: a stable sort, not a
    # host-syncing nonzero.
    order = torch.sort((~active).to(torch.uint8), dim=-1, stable=True).indices
    if t_act > t_total:
        order = torch.cat([order, order.new_full((b, t_act - t_total), t_total)], dim=1)
    pos = torch.arange(t_act, device=dev)
    act_ids = torch.where(pos < n_active[:, None], order[:, :t_act], t_total)
    overflow = overflow + torch.relu(n_active - t_act).to(torch.int32)
    rows_of = act_ids.clamp_max(t_total - 1)[..., None].expand(-1, -1, m)
    indices = torch.gather(bins.indices, 1, rows_of)
    valid = torch.gather(bins.valid, 1, rows_of) & (act_ids < t_total)[..., None]
    # The analytic inverse in the compacted layout: tile t lives at row
    # rank[t]; unselected tiles get the sentinel t_act and mask out.
    rank = torch.full((b, t_total + 1), t_act, dtype=torch.int64, device=dev)
    rank = rank.scatter(1, act_ids, pos.expand(b, -1).clone())[:, :t_total]
    rank_k = torch.gather(rank, 1, (inv_flat // m).reshape(b, -1)).reshape(inv_flat.shape)
    inv_valid = inv_valid & (rank_k < t_act)
    inv_flat = torch.where(inv_valid, rank_k * m + inv_flat % m, 0)
    return _TileBins(
        rows_all, indices, valid, inv_flat, inv_valid, act_ids,
        act_ids.clamp_max(t_total - 1), bins.indices, overflow, tw,
    )


def kernel_inputs(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
    max_tiles_per_face: int = 32,
    max_active_tiles: int | None = None,
):
    """(rows, counts, tiles_w): the K1/K2 inputs ``rasterize_silhouette``
    builds for this scene, for holding the kernels against their plain
    versions at a scene's real shapes."""
    tb = _bin_tiles(
        verts_pix.detach(), faces, image_size, sigma, tile, max_faces, znear,
        max_tiles_per_face, max_active_tiles,
    )
    rows, counts = _pack_tile_rows(
        tb.rows_all, tb.indices, tb.valid, tb.tile_ids, tile, tb.tiles_w
    )
    return rows, counts, tb.tiles_w


def rasterize_silhouette(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    sigma: float = 0.25,
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
    max_tiles_per_face: int = 32,
    max_active_tiles: int | None = None,
    return_compact: bool = False,
):
    """Fused hard raster + soft silhouette of B frames of one mesh.

    One ``bin_faces`` at the silhouette's margin (a superset of the hard
    raster's candidates; the in-kernel inside/z tests keep hard-raster
    results exact), one K1 launch for all frames; the silhouette backward
    is one K2 launch plus the analytic inverse gather.

    ``max_active_tiles`` (counted per scene, see
    rasterize_tiled.max_active_tiles_load) compacts the kernels onto the
    tiles with at least one candidate face; empty tiles contribute exactly
    (mass 0, no hit).

    Args:
      verts_pix: (B, V, 3) projected (u, v, z).
      faces: (F, 3), or (B, F, 3) a mesh per frame: the kernels take rows
        per (frame, tile) either way.

    Returns (Fragments, soft_silhouette (B, H, W), overflow (B,) int32); with
    ``return_compact=True`` a fourth element, the CompactTiles raster (None
    when compaction is off).  overflow counts face-tile pairs DROPPED by the
    per-tile cap, by ``max_tiles_per_face`` in the backward inverse, and
    whole tiles dropped by ``max_active_tiles``: nonzero means corrupted
    output, so callers surface it.
    """
    b = verts_pix.shape[0]
    h, w = image_size
    dev = verts_pix.device
    tb = _bin_tiles(
        verts_pix, faces, image_size, sigma, tile, max_faces, znear,
        max_tiles_per_face, max_active_tiles,
    )
    t_total = tb.dense_indices.shape[1]
    th, tw = -(-h // tile), tb.tiles_w
    p_tile = tile * tile
    act_ids = tb.act_ids
    mass, zmin, jbest = _FusedTiles.apply(
        tb.rows_all, tb.indices, tb.valid, tb.inv_flat, tb.inv_valid, tb.tile_ids,
        tile, tw, sigma, znear,
    )
    compact = None
    if act_ids is not None:
        if return_compact:
            # Padding rows have valid all-False -> no hit -> fid -1, bary 0.
            hit_c = zmin < _BIG_Z * 0.5
            fid_c = torch.gather(tb.indices, 2, jbest.long())
            fid_c = torch.where(hit_c, fid_c, -1).to(torch.int32)
            k = torch.arange(p_tile, device=dev)
            gx_c = ((act_ids % tw)[..., None] * tile + (k % tile)).float() + 0.5
            gy_c = ((act_ids // tw)[..., None] * tile + (k // tile)).float() + 0.5
            fid_flat = fid_c.reshape(b, -1)
            bary_c = barycentrics_from_rows(
                tb.rows_all, fid_flat, gx_c.reshape(b, -1), gy_c.reshape(b, -1)
            )
            bary_c = torch.where((fid_flat >= 0)[..., None], bary_c, 0.0)
            compact = CompactTiles(act_ids, fid_c, bary_c.reshape(b, -1, p_tile, 3))
        # Scatter back to the dense tile grid.
        mass = _scatter_rows(mass.new_zeros((b, t_total, p_tile)), act_ids, mass)
        zmin = _scatter_rows(zmin.new_full((b, t_total, p_tile), _BIG_Z), act_ids, zmin)
        jbest = _scatter_rows(jbest.new_zeros((b, t_total, p_tile)), act_ids, jbest)

    sil = 1.0 - torch.exp(-mass)
    hit = zmin < _BIG_Z * 0.5
    fid = torch.gather(tb.dense_indices, 2, jbest.long())
    fid = torch.where(hit, fid, -1).to(torch.int32)
    zbuf = torch.where(hit, zmin, -1.0)

    pix_to_face = _detile(fid, th, tw, tile, h, w)
    gx, gy = pixel_centers(h, w, dev)
    # One-hop gather from the per-face records built above.
    bary = barycentrics_from_rows(tb.rows_all, pix_to_face.reshape(b, -1), gx, gy)
    hit_img = (pix_to_face >= 0).reshape(b, -1, 1)
    frag = Fragments(
        pix_to_face=pix_to_face,
        bary=torch.where(hit_img, bary, 0.0).reshape(b, h, w, 3),
        zbuf=_detile(zbuf, th, tw, tile, h, w),
    )
    sil_img = _detile(sil, th, tw, tile, h, w)
    if return_compact:
        return frag, sil_img, tb.overflow, compact
    return frag, sil_img, tb.overflow


def depth_inputs(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
):
    """The K3 inputs ``rasterize_depth`` builds: margin-0 bins and the
    per-face records, no per-tile copy of them.  Returns (rows_all (B, F,
    16), indices (B, T, M) int32, counts (B, T) int32, tiles_w, bins)."""
    bins = bin_faces(verts_pix, faces, image_size, tile, max_faces, margin=0.0)
    tw = -(-image_size[1] // tile)
    rows_all = _face_rows(verts_pix, faces, znear)
    counts = bins.valid.sum(-1).to(torch.int32)
    return rows_all, bins.indices.to(torch.int32), counts, tw, bins


def rasterize_depth(
    verts_pix: Tensor,
    faces: Tensor,
    image_size: tuple[int, int],
    tile: int = 16,
    max_faces: int = 640,
    znear: float = 1e-2,
):
    """Hard raster only, forward only (the prior views): port of
    ``raster_pallas.rasterize_pallas`` around K3.

    Margin-0 binning (hard coverage needs no soft-edge band, so the
    candidate load and the counted cap are smaller than the fused
    raster's), one K3 launch for all B views, which reads each slot's
    record through the bins.  Tiles past the image edge (sides not a
    multiple of ``tile``) are rastered and cropped away.

    Args:
      verts_pix: (B, V, 3) projected (u, v, z).
      faces: (F, 3).

    Returns (Fragments, overflow (B,) int32): overflow counts face-tile
    pairs dropped by the per-tile cap; nonzero means corrupted output.
    """
    b = verts_pix.shape[0]
    h, w = image_size
    rows_all, indices, counts, tw, bins = depth_inputs(
        verts_pix, faces, image_size, tile, max_faces, znear
    )
    zmin, jbest = tile_depth(rows_all, indices, counts, tile, tw, znear)
    hit = zmin < _BIG_Z * 0.5
    fid = torch.gather(bins.indices, 2, jbest.long())
    fid = torch.where(hit, fid, -1).to(torch.int32)
    zbuf = torch.where(hit, zmin, -1.0)
    th = -(-h // tile)
    pix_to_face = _detile(fid, th, tw, tile, h, w)
    gx, gy = pixel_centers(h, w, verts_pix.device)
    bary = barycentrics_from_rows(rows_all, pix_to_face.reshape(b, -1), gx, gy)
    hit_img = (pix_to_face >= 0).reshape(b, -1, 1)
    frag = Fragments(
        pix_to_face=pix_to_face,
        bary=torch.where(hit_img, bary, 0.0).reshape(b, h, w, 3),
        zbuf=_detile(zbuf, th, tw, tile, h, w),
    )
    return frag, bins.overflow
