"""NeuS volume rendering: ray generation, hierarchical sampling, compositing.

Port of ``dynhor_tpu/neus/rendering.py`` (NeuS, Wang et al. 2021): a fixed
coarse count, fixed importance rounds and sorts, so every shape is static;
each ``stop_gradient`` of the reference is a ``.detach()`` in the same
place.  Random draws go through ``draws.draw`` at the reference's keys.

Ray/space conventions: fields live in the OBJECT (canonical, normalized)
frame; stage-1 poses give X_cam = X_obj @ R_row + T, so camera centers are
``-T @ R_row^T`` and directions rotate by ``R_row^T``.

Ties and rounding follow the reference where a discrete choice or a
gradient depends on them: clips split the gradient at a tie (``clip``),
sorts are stable (``jnp.argsort`` and ``lax.top_k`` keep the lower
index first among equal keys), ``searchsorted`` takes the right side, and
the shade selection counts weights below f32's smallest normal number as
0, as XLA's CPU and TPU flush them.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..utils import profiling as PF
from . import draws
from .draws import Key
from .fields import NeuSField, clip, inv_std, sdf_forward, sdf_grad, sdf_only

Tensor = torch.Tensor
_TINY = torch.finfo(torch.float32).tiny


def safe_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    """sqrt(sum(x^2) + eps^2): smooth at x=0 (d|x|/dx at exactly 0 would
    poison the backward)."""
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def safe_normalize(x: Tensor, eps: float = 1e-6) -> Tensor:
    return x / safe_norm(x, eps)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    n_coarse: int = 64
    n_importance: int = 64
    up_sample_steps: int = 4  # importance split into this many rounds
    near: float = 0.05
    far: float = 4.0
    bound: float = 1.0  # object sphere radius for ray-sphere clipping
    perturb: bool = True
    s_base: float = 64.0  # up-sample fixed inv-std ladder (64 * 2^k)
    # Sampler: "neus" = classic hierarchical up-sampling; "occgrid" =
    # importance-sample against a periodically refreshed occupancy grid.
    sampler: str = "neus"
    n_candidates: int = 192  # occgrid: uniform probe points per ray
    n_occ_samples: int = 64  # occgrid: final section count per ray
    occ_res: int = 64  # occupancy grid resolution per axis
    # Gradient + colour MLPs only at the n_shade sections with the largest
    # composite weight per ray (a static top-k compaction); the selected
    # weights are renormalized to the full weight sum.  0 = dense.
    n_shade: int = 16


class Rays(NamedTuple):
    origins: Tensor  # (N, 3) object-frame
    dirs: Tensor  # (N, 3) unit
    near: Tensor  # (N,)
    far: Tensor  # (N,)


def rays_from_pose(pixels_xy: Tensor, K: Tensor, R_row: Tensor, T: Tensor,
                   bound: float = 1.0) -> Rays:
    """Object-frame rays through pixel centers.

    Args:
      pixels_xy: (N, 2) pixel coords (x, y).
      K: (3, 3) intrinsics.
      R_row, T: object->camera row-convention pose (X_cam = X_obj @ R + T),
        (3, 3) and (3,) for every ray, or (N, 3, 3) and (N, 3), one a ray.
      bound: object bounding-sphere radius for near/far from ray-sphere hit.
    """
    x = (pixels_xy[:, 0] - K[0, 2]) / K[0, 0]
    y = (pixels_xy[:, 1] - K[1, 2]) / K[1, 1]
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    R = R_row.expand(d_cam.shape[0], 3, 3)
    d_obj = torch.einsum("nj,nkj->nk", d_cam, R)  # d_cam @ R_row.T per ray
    d_obj = d_obj / torch.linalg.norm(d_obj, dim=-1, keepdim=True)
    o_obj = -torch.einsum("nj,nkj->nk", T.expand(d_cam.shape[0], 3), R)
    b = torch.sum(o_obj * d_obj, dim=-1)
    c = torch.sum(o_obj * o_obj, dim=-1) - bound * bound
    disc = torch.clamp_min(b * b - c, 0.0)
    sq = torch.sqrt(disc)
    near = torch.clamp_min(-b - sq, 1e-3)
    far = torch.maximum(-b + sq, near + 1e-3)
    return Rays(o_obj, d_obj, near, far)


def linspace01(n: int, device) -> Tensor:
    """``jnp.linspace(0.0, 1.0, n)`` bit for bit: i / (n - 1) rounded once
    in f32, then the end point (``torch.linspace`` rounds otherwise)."""
    if n == 1:
        return torch.zeros(1, device=device)
    return torch.cat([torch.arange(n - 1, device=device, dtype=torch.float32) / (n - 1),
                      torch.ones(1, device=device)])


def sample_pdf(bins: Tensor, weights: Tensor, n_samples: int, key: Key | None) -> Tensor:
    """Inverse-CDF sampling of ``n_samples`` new points from a piecewise-
    constant pdf over ``bins`` (NeRF sample_pdf; deterministic if key is
    None).  bins: (..., B+1) bin edges; weights: (..., B)."""
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., B+1)
    shape = cdf.shape[:-1] + (n_samples,)
    if key is None:
        u = ((torch.arange(n_samples, device=cdf.device) + 0.5) / n_samples).expand(shape)
    else:
        u = draws.draw_rows(key, "uniform", shape)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    last = bins.shape[-1] - 1
    below = torch.clamp(idx - 1, 0, last)
    above = torch.clamp(idx, 0, last)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, below)
    bin_a = torch.gather(bins, -1, above)
    denom = torch.where(cdf_a - cdf_b < 1e-5, 1.0, cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def _neus_alpha(sdf: Tensor, s) -> Tensor:
    """alpha_i = clip((Phi_s(f_i) - Phi_s(f_{i+1})) / Phi_s(f_i), 0, 1),
    Phi_s the logistic CDF with inverse std s.  sdf: (..., M)."""
    prev_cdf = torch.sigmoid(s * sdf[..., :-1])
    next_cdf = torch.sigmoid(s * sdf[..., 1:])
    alpha = (prev_cdf - next_cdf) / (prev_cdf + 1e-5)
    return clip(alpha, 0.0, 1.0)


def _composite(alpha: Tensor) -> Tensor:
    """Weights alpha_i * prod_{j<i} (1 - alpha_j + 1e-7)."""
    ones = torch.ones_like(alpha[..., :1])
    trans = torch.cumprod(torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1), dim=-1)[..., :-1]
    return alpha * trans


def _points(rays: Rays, t: Tensor) -> Tensor:
    return rays.origins[:, None, :] + t[..., None] * rays.dirs[:, None, :]


def up_sample(field: NeuSField, rays: Rays, t: Tensor, sdf: Tensor, n_new: int,
              s_fixed: float, key: Key | None) -> tuple[Tensor, Tensor]:
    """One NeuS importance round: weights from a FIXED inv-std, then
    inverse-CDF sampling; returns merged, sorted (t, sdf).  The SDF is
    threaded through the rounds: only the n_new fresh points are evaluated.
    New positions and their SDF values are constants (official NeuS
    detaches new_z_vals)."""
    weights = _composite(_neus_alpha(sdf, s_fixed))
    t_new = sample_pdf(t, weights, n_new, key).detach()
    sdf_new = sdf_only(field, _points(rays, t_new))
    t_all = torch.cat([t, t_new], dim=-1)
    sdf_all = torch.cat([sdf, sdf_new.detach()], dim=-1)
    order = torch.argsort(t_all, dim=-1, stable=True)
    return torch.gather(t_all, -1, order), torch.gather(sdf_all, -1, order)


def occupancy_from_sdf(field: NeuSField, rcfg: RenderConfig, tau_scale: float = 2.0) -> Tensor:
    """Binary occupancy grid from the current SDF: a cell is occupied iff
    |sdf(center)| < tau (tau = tau_scale x the cell diagonal), dilated by
    one cell (a 3^3 max through three axis rolls).  Returns the (R^3,) f32
    flat grid over [-bound, bound]^3."""
    with PF.span("neus.occupancy"):
        r, b = rcfg.occ_res, rcfg.bound
        dev = field.variance.device
        centers = (torch.arange(r, device=dev) + 0.5) / r * (2 * b) - b
        gx, gy, gz = torch.meshgrid(centers, centers, centers, indexing="ij")
        pts = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        with torch.no_grad():
            sdf = sdf_only(field, pts)
        cell = 2.0 * b / r
        tau = torch.tensor(tau_scale * cell, dtype=torch.float32) * torch.sqrt(torch.tensor(3.0))
        occ3 = (torch.abs(sdf) < tau.to(dev)).float().reshape(r, r, r)
        for ax in range(3):
            occ3 = torch.maximum(
                occ3, torch.maximum(torch.roll(occ3, 1, dims=ax), torch.roll(occ3, -1, dims=ax))
            )
        return occ3.reshape(-1)


def _occ_lookup(occ_flat: Tensor, pts: Tensor, rcfg: RenderConfig) -> Tensor:
    """Occupancy at points (..., 3): one gather per point."""
    r, b = rcfg.occ_res, rcfg.bound
    ijk = torch.clamp(((pts + b) / (2 * b) * r).to(torch.int64), 0, r - 1)
    idx = (ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]
    return occ_flat[idx]


class RenderOut(NamedTuple):
    rgb: Tensor  # (N, 3)
    depth: Tensor  # (N,)
    acc: Tensor  # (N,) weight sum (opacity)
    normal: Tensor  # (N, 3) rendered object-frame normal
    eikonal: Tensor  # () mean (|grad|-1)^2 over sampled points
    inv_s: Tensor  # () current inv-std
    points: Tensor  # (N, 3) expected surface point (for correspondence loss)


def shade_selection(weights: Tensor, k: int) -> Tensor:
    """Indices of the k largest weights per ray, ``lax.top_k``'s order:
    descending, the lower index first among equal weights; weights below
    f32's smallest normal number count as 0 (XLA flushes them)."""
    w = weights.detach()
    w = torch.where(w < _TINY, 0.0, w)
    return torch.sort(w, dim=-1, descending=True, stable=True)[1][..., :k]


def render_rays(field: NeuSField, rcfg: RenderConfig, rays: Rays, key: Key | None = None,
                occ: Tensor | None = None) -> RenderOut:
    """Full NeuS render of a ray batch.  occ: the flat occupancy grid
    (``occupancy_from_sdf``), required when ``rcfg.sampler == "occgrid"``.

    Every ray is rendered on its own (the shade selection too is per ray),
    so a shard of the rays renders as those rows of the whole batch; with a
    key marked ``Key.for_rows`` its draws are those rows of the whole
    batch's draws."""
    k_strat, k_imp = (None, None) if key is None else key.split()
    dev = rays.origins.device

    with PF.span("neus.sample"):
        if rcfg.sampler == "occgrid":
            if occ is None:
                raise ValueError("occgrid sampler needs an occupancy grid")
            # Uniform candidates -> occupancy-weighted inverse-CDF resampling.
            u = linspace01(rcfg.n_candidates, dev)
            tc = rays.near[:, None] + (rays.far - rays.near)[:, None] * u[None, :]
            mid_c = 0.5 * (tc[..., 1:] + tc[..., :-1])
            # A floor keeps samples on empty rays (mask/background terms).
            w_occ = _occ_lookup(occ, _points(rays, mid_c), rcfg) + 1e-3
            t = sample_pdf(tc, w_occ, rcfg.n_occ_samples, k_strat)
            t = torch.sort(t, dim=-1)[0].detach()
        else:
            u = linspace01(rcfg.n_coarse, dev)
            t = rays.near[:, None] + (rays.far - rays.near)[:, None] * u[None, :]
            if rcfg.perturb and k_strat is not None:
                mids = 0.5 * (t[..., 1:] + t[..., :-1])
                upper = torch.cat([mids, t[..., -1:]], dim=-1)
                lower = torch.cat([t[..., :1], mids], dim=-1)
                t = lower + (upper - lower) * draws.draw_rows(k_strat, "uniform", tuple(t.shape))
            if rcfg.up_sample_steps > 0 and rcfg.n_importance > 0:
                sdf_c = sdf_only(field, _points(rays, t)).detach()
                n_per = rcfg.n_importance // max(rcfg.up_sample_steps, 1)
                for i in range(rcfg.up_sample_steps):
                    kk = None if k_imp is None else k_imp.fold_in(i)
                    t, sdf_c = up_sample(field, rays, t, sdf_c, n_per, rcfg.s_base * (2**i), kk)
                t = t.detach()

    # Section compositing at the final t set.
    with PF.span("neus.field"):
        sdf, feat = sdf_forward(field, _points(rays, t))
    s = inv_std(field.variance)
    weights = _composite(_neus_alpha(sdf, s))  # (N, M-1)
    mid_t = 0.5 * (t[..., 1:] + t[..., :-1])
    mid_feat = 0.5 * (feat[..., 1:, :] + feat[..., :-1, :])
    depth = torch.sum(weights * mid_t, dim=-1)
    acc = torch.sum(weights, dim=-1)

    w_shade = weights
    if 0 < rcfg.n_shade < weights.shape[-1]:
        sel = shade_selection(weights, rcfg.n_shade)
        w_sel = torch.gather(weights, -1, sel)
        scale = torch.sum(weights, dim=-1, keepdim=True) / clip(
            torch.sum(w_sel, dim=-1, keepdim=True), 1e-6)
        w_shade = w_sel * scale
        mid_t = torch.gather(mid_t, -1, sel)
        mid_feat = torch.gather(mid_feat, -2,
                                sel[..., None].expand(sel.shape + mid_feat.shape[-1:]))

    mid_pts = _points(rays, mid_t)
    with PF.span("neus.field"):
        grads = sdf_grad(field, mid_pts)  # (N, K, 3)
    normals = safe_normalize(grads, eps=0.05)
    dirs = rays.dirs[:, None, :].expand(mid_pts.shape)
    with PF.span("neus.field"):
        rgb_samples = field.color(mid_pts, dirs, normals, mid_feat)
    rgb = torch.sum(w_shade[..., None] * rgb_samples, dim=-2)
    normal = torch.sum(w_shade[..., None] * normals, dim=-2)
    surf = rays.origins + depth[..., None] * rays.dirs
    eik = torch.mean((safe_norm(grads)[..., 0] - 1.0) ** 2)
    return RenderOut(rgb, depth, acc, normal, eik, s, surf)
