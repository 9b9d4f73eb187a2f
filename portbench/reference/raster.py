"""Plain face-major rasterization: the benchmark's own hard z-buffer and
soft silhouette, written from their definitions.

Each face visits the pixels of a window around its screen box, so the work
follows the faces' sizes and no per-tile bin or cap exists here.  The
definitions are those the tracker states (pixel (i, j) has its centre at
(j + 0.5, i + 0.5); screen-space barycentrics; a pixel's face is the one
with the least interpolated depth above ``znear``, the lowest face id on a
tie); the soft silhouette's mass sums ``softplus(±dist / sigma)`` over the
faces whose screen box, grown by ``6 sigma + 1`` pixels, overlaps the
pixel's 16-pixel tile, which is where the tracker's definition stops
counting a face.

Plain PyTorch only; this file imports nothing of the program.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor
ZNEAR = 1e-2
_PAIRS_PER_CHUNK = 1 << 24  # (frame, face, pixel) triples per step: a memory knob


def face_corners(vp: Tensor, faces: Tensor) -> Tensor:
    """(B, F, 3, 3) projected corners (u, v, z) of every face."""
    return vp[:, faces.long()]


def barycentrics(x0, y0, x1, y1, x2, y2, px, py):
    """Screen-space barycentrics, area, and whether the face is not
    degenerate; the rounding order is the tracker's (products, then the
    difference, then one multiply by 1 / area)."""
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    degen = area.abs() < 1e-12
    inv = torch.where(degen, 0.0, 1.0 / torch.where(degen, 1.0, area))
    w0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) * inv
    w1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) * inv
    w2 = ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * inv
    return (w0, w1, w2), area.abs() > 1e-12


def _windows(start_x: Tensor, count_x: Tensor, start_y: Tensor, count_y: Tensor):
    """Pixel offsets of each face's window: (nx, ny, ox, oy, inside) with
    nx, ny the largest counts; ``inside`` marks offsets below the face's
    own counts.  start/count: (B, F) integers."""
    nx = max(int(count_x.max()), 1) if count_x.numel() else 1
    ny = max(int(count_y.max()), 1) if count_y.numel() else 1
    dev = start_x.device
    ox = torch.arange(nx, device=dev).repeat(ny)
    oy = torch.arange(ny, device=dev).repeat_interleave(nx)
    inside = (ox < count_x[..., None]) & (oy < count_y[..., None])
    return nx, ny, ox, oy, inside


def cover_windows(fv: Tensor, hw: tuple[int, int], znear: float = ZNEAR):
    """Each face's window of pixel centres inside its screen box, clamped to
    the image: (x0, count_x, y0, count_y), (B, F) each; faces with no corner
    past ``znear`` get empty windows."""
    h, w = hw
    xs, ys = fv[..., 0], fv[..., 1]
    vis = (fv[..., 2] > znear).any(-1)
    # Pixel centres j + 0.5 inside [lo, hi].
    jx0 = torch.ceil(xs.amin(-1) - 0.5).clamp(0, w).long()
    jx1 = torch.floor(xs.amax(-1) - 0.5).clamp(-1, w - 1).long()
    jy0 = torch.ceil(ys.amin(-1) - 0.5).clamp(0, h).long()
    jy1 = torch.floor(ys.amax(-1) - 0.5).clamp(-1, h - 1).long()
    cx = torch.where(vis, jx1 - jx0 + 1, 0).clamp_min(0)
    cy = torch.where(vis, jy1 - jy0 + 1, 0).clamp_min(0)
    return jx0, cx, jy0, cy


def _chunks(n_faces: int, b: int, window: int):
    step = max(1, _PAIRS_PER_CHUNK // max(b * window, 1))
    return range(0, n_faces, step), step


def hard_raster(vp: Tensor, faces: Tensor, hw: tuple[int, int], znear: float = ZNEAR):
    """Hard z-buffer of B images.  vp (B, V, 3) projected (u, v, z).

    Returns (pix_to_face (B, H*W) int64, -1 where nothing covers the pixel,
    zbuf (B, H*W) f32, +inf there)."""
    h, w = hw
    b = vp.shape[0]
    fv = face_corners(vp, faces).detach()
    n_faces = fv.shape[1]
    jx0, cx, jy0, cy = cover_windows(fv, hw, znear)
    key = torch.full((b, h * w), torch.iinfo(torch.int64).max, dtype=torch.int64, device=vp.device)
    nx = max(int(cx.max()), 1) if n_faces else 1
    ny = max(int(cy.max()), 1) if n_faces else 1
    rng, step = _chunks(n_faces, b, nx * ny)
    for s in rng:
        sl = slice(s, s + step)
        nxc, nyc, ox, oy, live_w = _windows(jx0[:, sl], cx[:, sl], jy0[:, sl], cy[:, sl])
        px_i = jx0[:, sl, None] + ox
        py_i = jy0[:, sl, None] + oy
        px = px_i.float() + 0.5
        py = py_i.float() + 0.5
        c = fv[:, sl, :, None, :]  # (B, Fc, 3, 1, 3)
        (w0, w1, w2), nondegen = barycentrics(
            c[:, :, 0, :, 0], c[:, :, 0, :, 1], c[:, :, 1, :, 0], c[:, :, 1, :, 1],
            c[:, :, 2, :, 0], c[:, :, 2, :, 1], px, py,
        )
        z = w0 * c[:, :, 0, :, 2] + w1 * c[:, :, 1, :, 2] + w2 * c[:, :, 2, :, 2]
        live = live_w & (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & nondegen & (z > znear)
        # Positive f32 depths order as their bit patterns; the face id in the
        # low half breaks a tie toward the lowest id.
        zbits = z.contiguous().view(torch.int32).long()
        fid = torch.arange(s, s + z.shape[1], device=vp.device)[None, :, None]
        k = torch.where(live, (zbits << 32) | fid, torch.iinfo(torch.int64).max)
        pix = (py_i.clamp(0, h - 1) * w + px_i.clamp(0, w - 1)).reshape(b, -1)
        key.scatter_reduce_(1, pix, k.reshape(b, -1), reduce="amin")
    hit = key != torch.iinfo(torch.int64).max
    pix_to_face = torch.where(hit, key & 0xFFFFFFFF, -1)
    zbuf = torch.where(hit, (key >> 32).to(torch.int32).view(torch.float32), math.inf)
    return pix_to_face, zbuf


def _segment_d2(ax, ay, bx, by, px, py):
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby
    t = ((apx * abx + apy * aby) / denom.clamp_min(1e-12)).clamp(0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def soft_mass(vp: Tensor, faces: Tensor, hw: tuple[int, int], sigma: float,
              tile: int = 16, znear: float = ZNEAR) -> Tensor:
    """The soft silhouette's mass (B, H*W), differentiable in vp's xy.

    A face counts at a pixel when its screen box grown by ``6 sigma + 1``
    overlaps the pixel's tile, it has a corner in front of ``znear`` and it
    is not degenerate; it adds softplus(+-sqrt(d2) / sigma), + inside the
    face, d2 the squared distance to its nearest edge."""
    h, w = hw
    b = vp.shape[0]
    margin = 6.0 * sigma + 1.0
    fv = face_corners(vp, faces)
    n_faces = fv.shape[1]
    xs, ys, zs = fv[..., 0].detach(), fv[..., 1].detach(), fv[..., 2].detach()
    vis = (zs > znear).any(-1) & ((xs.amax(-1) > xs.amin(-1)) | (ys.amax(-1) > ys.amin(-1)))
    th, tw = -(-h // tile), -(-w // tile)
    # Tiles t with x1 < 16 t + 16 and x2 > 16 t: floor(x1 / 16) .. ceil(x2 / 16) - 1.
    tx0 = torch.floor((xs.amin(-1) - margin) / tile).clamp(0, tw).long()
    tx1 = (torch.ceil((xs.amax(-1) + margin) / tile) - 1).clamp(-1, tw - 1).long()
    ty0 = torch.floor((ys.amin(-1) - margin) / tile).clamp(0, th).long()
    ty1 = (torch.ceil((ys.amax(-1) + margin) / tile) - 1).clamp(-1, th - 1).long()
    cx = torch.where(vis, (tx1 - tx0 + 1) * tile, 0).clamp_min(0)
    cy = torch.where(vis, (ty1 - ty0 + 1) * tile, 0).clamp_min(0)
    mass = vp.new_zeros((b, th * tile * tw * tile))
    gw = tw * tile
    nx = max(int(cx.max()), 1) if n_faces else 1
    ny = max(int(cy.max()), 1) if n_faces else 1
    rng, step = _chunks(n_faces, b, nx * ny)
    for s in rng:
        sl = slice(s, s + step)
        _, _, ox, oy, live_w = _windows(tx0[:, sl] * tile, cx[:, sl], ty0[:, sl] * tile, cy[:, sl])
        px_i = tx0[:, sl, None] * tile + ox
        py_i = ty0[:, sl, None] * tile + oy
        px = px_i.float() + 0.5
        py = py_i.float() + 0.5
        c = fv[:, sl, :, None, :]
        x0, y0 = c[:, :, 0, :, 0], c[:, :, 0, :, 1]
        x1, y1 = c[:, :, 1, :, 0], c[:, :, 1, :, 1]
        x2, y2 = c[:, :, 2, :, 0], c[:, :, 2, :, 1]
        (w0, w1, w2), nondegen = barycentrics(x0, y0, x1, y1, x2, y2, px, py)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & nondegen
        d2 = torch.minimum(
            _segment_d2(x0, y0, x1, y1, px, py),
            torch.minimum(_segment_d2(x1, y1, x2, y2, px, py), _segment_d2(x2, y2, x0, y0, px, py)),
        )
        logit = torch.where(inside, 1.0, -1.0) * torch.sqrt(d2.clamp_min(1e-12)) / sigma
        live = live_w & nondegen & vis[:, sl, None]
        sp = torch.where(live, torch.nn.functional.softplus(logit), 0.0)
        pix = (py_i.clamp(0, th * tile - 1) * gw + px_i.clamp(0, gw - 1)).reshape(b, -1)
        mass = mass.index_put((torch.arange(b, device=vp.device)[:, None].expand_as(pix), pix),
                              sp.reshape(b, -1), accumulate=True)
    mass = mass.reshape(b, th * tile, gw)[:, :h, :w]
    return mass.reshape(b, h * w)


def tile_loads(vp: Tensor, faces: Tensor, hw: tuple[int, int], margin: float,
               tile: int = 16, znear: float = ZNEAR) -> Tensor:
    """(B, T) faces per tile under the binning rule above (box grown by
    ``margin``), T row-major over the tile grid: the work a tile-binned
    raster does, and the caps it needs."""
    h, w = hw
    th, tw = -(-h // tile), -(-w // tile)
    fv = face_corners(vp, faces).detach()
    xs, ys, zs = fv[..., 0], fv[..., 1], fv[..., 2]
    vis = (zs > znear).any(-1) & ((xs.amax(-1) > xs.amin(-1)) | (ys.amax(-1) > ys.amin(-1)))
    x1, x2 = xs.amin(-1) - margin, xs.amax(-1) + margin
    y1, y2 = ys.amin(-1) - margin, ys.amax(-1) + margin
    tx = (torch.arange(tw, device=vp.device) * tile).float()
    ty = (torch.arange(th, device=vp.device) * tile).float()
    loads = []
    for bi in range(vp.shape[0]):
        ox = (x1[bi, None, :] < tx[:, None] + tile) & (x2[bi, None, :] > tx[:, None])  # (tw, F)
        oy = (y1[bi, None, :] < ty[:, None] + tile) & (y2[bi, None, :] > ty[:, None])  # (th, F)
        m = (oy & vis[bi]).float() @ ox.float().T  # (th, tw)
        loads.append(m.reshape(-1))
    return torch.stack(loads).round().long()
