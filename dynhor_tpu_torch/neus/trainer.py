"""NeuS training loop: ray batching, losses, Adam, checkpoints (PyTorch).

Port of ``dynhor_tpu/neus/trainer.py``.  Supervision: RGB + SAM masks +
monocular normals + dense correspondences, with poses from the stage-1 npz
files.  Rays of all frames are sampled every step from the stacked images
on the device.

The optax chain maps onto ``torch.optim.Adam`` with two parameter groups
("net", and "grid" = the hash table at ``lr * grid_lr_mult``) under a
``LambdaLR`` that is optax's ``warmup_cosine_decay_schedule`` evaluated at
the pre-increment count (step 0 runs at lr 0), after a global-norm clip at
1.0 written as optax writes it (scale by 1/|g| only when |g| >= 1).  The
background colour is updated outside Adam and the clip, ``bg - 1e-2 g``.
Every random value comes from ``draws.draw`` at the reference's keys.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os

import torch

from ..parallel import mesh as PM
from ..utils import profiling as PF
from ..utils.device import resolve_device
from . import draws
from .data import CorrData, ReconData
from .draws import Key
from .fields import NeuSField, SDFConfig, clip, sdf_grad, sdf_only
from .rendering import (
    RenderConfig, Rays, occupancy_from_sdf, rays_from_pose, render_rays, safe_norm, safe_normalize,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 20000
    batch_rays: int = 1024
    lr: float = 5e-4
    warmup: int = 500
    lw_rgb: float = 1.0
    lw_mask: float = 0.1
    lw_eikonal: float = 0.1
    lw_normal: float = 0.1
    lw_corr: float = 0.0  # enabled when correspondences are provided
    # Anti-collapse regularizers: uniform-space Eikonal points and a hinge
    # that keeps the domain shell outside-positive.
    n_eikonal_uniform: int = 256
    lw_shell: float = 0.1
    shell_radius: float = 0.85  # of rcfg.bound
    shell_margin: float = 0.05
    # inv_s is kept inside an exponential band start -> end.
    s_max_start: float = 30.0
    s_max_end: float = 512.0
    s_min_start: float = 15.0
    s_min_end: float = 150.0
    # Sign anchor: sdf(near-origin) must be negative.
    lw_origin: float = 0.01
    origin_margin: float = 0.02
    # Occupancy-grid refresh period (rcfg.sampler == "occgrid").
    occ_update_every: int = 250
    log_every: int = 500
    checkpoint_every: int = 5000
    seed: int = 0
    # lr multiplier for the explicit hash feature table.
    grid_lr_mult: float = 20.0
    # StableNormal maps are OpenGL-convention camera normals (x right,
    # y up, z toward viewer); OpenCV cameras flip y/z.
    normal_flip_yz: bool = True


def sample_ray_batch(key: Key, data: ReconData, n_rays: int):
    """Uniformly sampled (frame, pixel) pairs over the full image; rays go
    through pixel centers (+0.5)."""
    f, h, w = data.masks.shape
    k1, k2, k3 = key.split(3)
    fr = draws.draw(k1, "randint", (n_rays,), 0, f)
    xi = draws.draw(k2, "randint", (n_rays,), 0, w)
    yi = draws.draw(k3, "randint", (n_rays,), 0, h)
    xy = torch.stack([xi + 0.5, yi + 0.5], dim=-1).float()
    rgb = data.images[fr, yi, xi]
    mask = data.masks[fr, yi, xi]
    nrm = None if data.normals is None else data.normals[fr, yi, xi]
    return fr, xy, rgb, mask, nrm


def _rays_for(data: ReconData, fr: Tensor, xy: Tensor, bound: float) -> Rays:
    return rays_from_pose(xy, data.K, data.R_rows[fr], data.Ts[fr], bound)


def _huber(x: Tensor, delta: float) -> Tensor:
    """``optax.huber_loss``."""
    abs_err = x.abs()
    quadratic = clip(abs_err, hi=delta)
    return 0.5 * quadratic * quadratic + delta * (abs_err - quadratic)


@dataclasses.dataclass
class TrainState:
    field: NeuSField
    opt: torch.optim.Optimizer
    sched: torch.optim.lr_scheduler.LambdaLR
    bg: Tensor  # (3,) learnable background colour (pre-sigmoid)
    step: int = 0


def warmup_cosine(count: int, warmup: int, decay_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, 1, warmup, decay_steps)`` at
    ``count``: linear 0 -> 1 over ``warmup`` steps, then a cosine to 0 over
    the remaining ``decay_steps - warmup``."""
    if count < warmup:
        return count / warmup
    n = decay_steps - warmup
    c = min(count - warmup, n)
    return 0.5 * (1.0 + math.cos(math.pi * c / n))


def make_optimizer(field: NeuSField, tcfg: TrainConfig):
    """Adam over two groups ("net", "grid" = the hash table) and the
    schedule; returns (optimizer, LambdaLR)."""
    named = dict(field.named_parameters())
    grid = [named.pop("sdf.table")] if "sdf.table" in named else []
    groups = [{"params": list(named.values()), "lr": tcfg.lr, "name": "net"}]
    if grid:
        groups.append({"params": grid, "lr": tcfg.lr * tcfg.grid_lr_mult, "name": "grid"})
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    decay = max(tcfg.num_steps, tcfg.warmup + 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: warmup_cosine(count, tcfg.warmup, decay))
    return opt, sched


def clip_by_global_norm_(grads: list[Tensor], max_norm: float = 1.0) -> Tensor:
    """``optax.clip_by_global_norm``: every gradient scaled by
    ``max_norm / |g|`` when the global norm |g| >= max_norm (in place, no
    host sync).  Returns |g|."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))
    return norm


def init_train_state(key: Key, sdf_cfg: SDFConfig, tcfg: TrainConfig) -> TrainState:
    """The field initialised from ``key`` on ``key.device``, its optimizer
    and schedule, a zero background, step 0."""
    field = NeuSField(sdf_cfg, key)
    opt, sched = make_optimizer(field, tcfg)
    return TrainState(field, opt, sched, torch.zeros(3, device=key.device, requires_grad=True))


def loss_fn(field: NeuSField, bg: Tensor, key: Key, data: ReconData, corr: CorrData | None,
            occ: Tensor | None, rcfg: RenderConfig, tcfg: TrainConfig, ray_mesh=None):
    """The step's loss and its logs (tensors).

    ``ray_mesh``: a ``parallel.mesh`` mesh with a "rays" axis.  Every rank
    draws the whole ray batch and renders its contiguous slice (the render's
    draws sliced from the whole batch's, ``Key.for_rows``).  The loss is
    then this rank's term of the global loss: the per-ray means divide by
    the whole batch, and the terms that are not per ray (the uniform
    Eikonal points, the shell, the origin, the correspondences) are the
    first rank's alone, so the sum over the ranks, and of their gradients,
    counts each once.  The logs are then the global values, on every rank."""
    k_pix, k_render, k_corr, k_eik, k_shell = key.split(5)
    fr, xy, rgb_gt, mask_gt, nrm_gt = sample_ray_batch(k_pix, data, tcfg.batch_rays)
    n = fr.shape[0]
    mask_sum = mask_gt.sum()
    root, share = True, 1.0
    if ray_mesh is not None:
        index, size = PM.axis_index(ray_mesh, "rays"), PM.axis_size(ray_mesh, "rays")
        per = -(-n // size)
        lo, hi = min(index * per, n), min((index + 1) * per, n)
        root, share = index == 0, (hi - lo) / n
        k_render = k_render.for_rows(lo, hi, n)
        fr, xy, rgb_gt, mask_gt = fr[lo:hi], xy[lo:hi], rgb_gt[lo:hi], mask_gt[lo:hi]
        nrm_gt = None if nrm_gt is None else nrm_gt[lo:hi]
    PF.count("neus.rays", fr.shape[0])
    out = render_rays(field, rcfg, _rays_for(data, fr, xy, rcfg.bound), k_render, occ)

    def ray_mean(x):  # this rank's term of the mean over the whole batch
        return x.mean() if ray_mesh is None else x.sum() / (n * x[0].numel())

    zero = out.inv_s.new_zeros(())
    rgb_pred = out.rgb + (1.0 - out.acc[:, None]) * torch.sigmoid(bg)
    l_rgb = ray_mean(torch.abs(rgb_pred - rgb_gt))
    acc = clip(out.acc, 1e-4, 1.0 - 1e-4)
    l_mask = -ray_mean(mask_gt * torch.log(acc) + (1.0 - mask_gt) * torch.log(1.0 - acc))
    eik = out.eikonal if ray_mesh is None else out.eikonal * share
    if tcfg.n_eikonal_uniform > 0:  # uniform-space Eikonal
        eik_u = zero
        if root:
            pts_u = rcfg.bound * draws.draw(k_eik, "uniform", (tcfg.n_eikonal_uniform, 3), -1.0, 1.0)
            g_u = sdf_grad(field, pts_u)
            eik_u = torch.mean((safe_norm(g_u)[..., 0] - 1.0) ** 2)
        eik = 0.5 * (eik + eik_u)
    loss = tcfg.lw_rgb * l_rgb + tcfg.lw_mask * l_mask + tcfg.lw_eikonal * eik
    logs = {"rgb": l_rgb, "mask": l_mask, "eikonal": eik}

    if tcfg.lw_shell > 0:
        l_shell = zero
        if root:
            k_dir, k_rad = k_shell.split()
            d = draws.draw(k_dir, "normal", (128, 3))
            d = d / clip(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-9)
            r = rcfg.bound * draws.draw(k_rad, "uniform", (128, 1), tcfg.shell_radius, 1.0)
            l_shell = torch.relu(tcfg.shell_margin - sdf_only(field, d * r)).mean()
        loss = loss + tcfg.lw_shell * l_shell
        logs["shell"] = l_shell
    if tcfg.lw_origin > 0 and root:
        pts_o = 0.05 * draws.draw(k_shell.fold_in(1), "normal", (16, 3))
        l_origin = torch.relu(sdf_only(field, pts_o) + tcfg.origin_margin).mean()
        loss = loss + tcfg.lw_origin * l_origin

    if nrm_gt is not None and tcfg.lw_normal > 0:
        n_cam = torch.einsum("nj,njk->nk", out.normal, data.R_rows[fr])
        # (x, -y, -z): the product by (1, -1, -1), without copying it to the device
        nrm_ref = torch.cat([nrm_gt[:, :1], -nrm_gt[:, 1:]], dim=-1) if tcfg.normal_flip_yz else nrm_gt
        # A large eps: |n_pred| -> 0 early in training (acc ~ 0).
        cos = torch.sum(safe_normalize(n_cam, eps=0.1) * safe_normalize(nrm_ref, eps=0.1), dim=-1)
        l_normal = ((1.0 - cos) * mask_gt).sum() / (mask_sum + 1e-6)
        loss = loss + tcfg.lw_normal * l_normal
        logs["normal"] = l_normal

    if corr is not None and tcfg.lw_corr > 0:
        l_corr = zero
        if root:
            l_corr = _corr_loss(field, k_corr, data, corr, occ, rcfg)
        loss = loss + tcfg.lw_corr * l_corr
        logs["corr"] = l_corr

    mse = ray_mean((rgb_pred - rgb_gt) ** 2)
    logs["loss"] = loss
    if ray_mesh is not None:
        names = list(logs)
        summed = PM.all_reduce(torch.stack([logs[k].detach() for k in names] + [mse.detach()]),
                               ray_mesh, "rays")
        logs = dict(zip(names, summed[:-1]))
        mse = summed[-1]
    logs["inv_s"] = out.inv_s
    logs["psnr"] = -10.0 * torch.log10(mse + 1e-8)
    return loss, logs


def _corr_loss(field: NeuSField, k_corr: Key, data: ReconData, corr: CorrData, occ,
               rcfg: RenderConfig) -> Tensor:
    """The correspondence term: frame-i surface points reprojected into
    frame j against the matched pixels (Huber, confidence-weighted)."""
    m = corr.frame_i.shape[0]
    idx = draws.draw(k_corr, "randint", (min(256, m),), 0, m)
    fi, fj = corr.frame_i[idx].long(), corr.frame_j[idx].long()
    out_i = render_rays(field, rcfg, _rays_for(data, fi, corr.xy_i[idx], rcfg.bound), None, occ)
    # Project frame-i surface points into frame j; a generous z floor
    # keeps the 1/z gradient bounded.
    pts_cam_j = torch.einsum("nj,njk->nk", out_i.points, data.R_rows[fj]) + data.Ts[fj]
    z_j = pts_cam_j[:, 2:]
    uv = torch.einsum("ij,nj->ni", data.K, pts_cam_j)
    uv = uv[:, :2] / clip(z_j, 0.1)
    scale = float(max(data.masks.shape[1], data.masks.shape[2]))
    conf = ((out_i.acc > 0.5) & (z_j[:, 0] > 0.1)).float().detach()
    resid = (uv - corr.xy_j[idx]) / scale * conf[:, None]
    return _huber(resid, 0.01).mean(dim=-1).sum() / (conf.sum() + 1e-6)


def variance_band(step: int, tcfg: TrainConfig) -> tuple[float, float]:
    """The scheduled (low, high) of ``variance`` at ``step``, in f32 as the
    reference computes it."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    frac = torch.clamp(f32(step) / max(tcfg.num_steps, 1), 0, 1)
    s_max = tcfg.s_max_start * torch.pow(f32(tcfg.s_max_end / tcfg.s_max_start), frac)
    s_min = tcfg.s_min_start * torch.pow(f32(tcfg.s_min_end / tcfg.s_min_start), frac)
    return float(torch.log(s_min) / 10.0), float(torch.log(s_max) / 10.0)


def make_train_step(rcfg: RenderConfig, tcfg: TrainConfig, ray_sharding=None):
    """The train step: ``step(state, key, data, corr, occ) -> logs``
    updates ``state`` in place (parameters, optimizer, background, step)
    and returns the pre-update logs as device tensors.

    ``ray_sharding``: a ``parallel.mesh`` mesh with a "rays" axis, over
    whose ranks the field is replicated (``mesh.replicate``): data
    parallelism over the rays, the counterpart of the JAX package's
    ``make_train_step(ray_sharding=)``.  Each rank renders its slice of the
    same ray batch (``loss_fn``), the gradients are summed over the ranks
    before the global-norm clip, and every rank takes the same update, so
    the replicas stay equal."""

    def train_step(state: TrainState, key: Key, data: ReconData, corr: CorrData | None = None,
                   occ: Tensor | None = None) -> dict[str, Tensor]:
        with PF.span("neus.step"):
            field = state.field
            state.opt.zero_grad(set_to_none=True)
            state.bg.grad = None
            loss, logs = loss_fn(field, state.bg, key, data, corr, occ, rcfg, tcfg, ray_sharding)
            with PF.span("neus.backward"):
                loss.backward()
            if ray_sharding is not None:
                _sum_grads([*field.parameters(), state.bg], ray_sharding)
            with PF.span("neus.update"):
                apply_update(state, tcfg)
            return {k: v.detach() for k, v in logs.items()}

    return train_step


def apply_update(state: TrainState, tcfg: TrainConfig) -> None:
    """The update of a step whose gradients are in place: the global-norm
    clip, Adam under its schedule, the variance band and the background's
    gradient step."""
    field = state.field
    clip_by_global_norm_([p.grad for p in field.parameters() if p.grad is not None])
    state.opt.step()
    state.sched.step()
    lo, hi = variance_band(state.step, tcfg)
    with torch.no_grad():
        field.variance.clamp_(lo, hi)
        state.bg -= 1e-2 * state.bg.grad
    state.step += 1


def _sum_grads(params: list[Tensor], mesh) -> None:
    """Replace each gradient by its sum over the "rays" ranks, in one
    collective."""
    flat = PM.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), mesh, "rays")
    off = 0
    for p in params:
        p.grad = flat[off:off + p.numel()].view_as(p).clone()
        off += p.numel()


def train(
    data: ReconData,
    sdf_cfg: SDFConfig = SDFConfig(),
    rcfg: RenderConfig = RenderConfig(),
    tcfg: TrainConfig = TrainConfig(),
    corr: CorrData | None = None,
    board=None,
    checkpoint_dir: str | None = None,
    resume: bool = True,
    device: str | torch.device | None = None,
    profiler=None,
):
    """Full training loop on ``device`` (None = the CUDA card, raising
    without one); returns (state, history).  ``profiler``
    (``utils.profiling.Profiler``) times the occupancy refreshes as
    "occupancy"."""
    dev = resolve_device(device)
    data = data.to(dev)
    corr = None if corr is None else corr.to(dev)
    key = Key(tcfg.seed, dev)
    state = init_train_state(key, sdf_cfg, tcfg)
    start = 0
    if checkpoint_dir and resume and restore_checkpoint(checkpoint_dir, state) is not None:
        start = state.step
    step_fn = make_train_step(rcfg, tcfg)
    history: dict[str, list] = {}

    def occupancy():
        with profiler.phase("occupancy") if profiler else contextlib.nullcontext():
            return occupancy_from_sdf(state.field, rcfg)

    occ = occupancy() if rcfg.sampler == "occgrid" else None
    for i in range(start, tcfg.num_steps):
        if occ is not None and i % max(tcfg.occ_update_every, 1) == 0 and i > start:
            occ = occupancy()
        logs = step_fn(state, key.fold_in(i), data, corr, occ)
        if (i + 1) % tcfg.log_every == 0 or i == start:
            logs = {k: float(v) for k, v in logs.items()}
            for k, v in logs.items():
                history.setdefault(k, []).append(v)
                if board is not None:
                    board.add_scalar(f"neus/{k}", v, i)
            print(
                f"[neus] step {i + 1}/{tcfg.num_steps} "
                + " ".join(f"{k}={v:.4f}" for k, v in sorted(logs.items())),
                flush=True,
            )
        if checkpoint_dir and (i + 1) % tcfg.checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state, history


# ---------------------------------------------------------------------------
# Checkpoints: <ckpt_dir>/step_<N>.pt (torch.save); resume takes the largest N
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str, state: TrainState) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{state.step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"field": state.field.state_dict(), "opt": state.opt.state_dict(),
                "sched": state.sched.state_dict(), "bg": state.bg.detach(),
                "step": state.step}, tmp)
    os.replace(tmp, path)


def restore_checkpoint(ckpt_dir: str, state: TrainState) -> TrainState | None:
    """Load the largest step under ``ckpt_dir`` into ``state`` (in place);
    None when there is none."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(name[5:-3]) for name in os.listdir(ckpt_dir)
        if name.startswith("step_") and name.endswith(".pt") and name[5:-3].isdigit()
    ]
    if not steps:
        return None
    dev = state.bg.device
    ck = torch.load(os.path.join(ckpt_dir, f"step_{max(steps)}.pt"), map_location=dev,
                    weights_only=True)
    state.field.load_state_dict(ck["field"])
    state.opt.load_state_dict(ck["opt"])
    state.sched.load_state_dict(ck["sched"])
    with torch.no_grad():
        state.bg.copy_(ck["bg"])
    state.step = int(ck["step"])
    return state
