"""Plain reference of one NeuS train step (Wang et al. 2021) with the
occupancy-grid sampler, as the reconstruction stage defines it: the PE SDF
network (8 x 256 softplus(100 x) layers, a skip at layer 4, 6 frequencies,
geometric init), the colour head (4 x 256 ReLU, 4 view frequencies), the
logistic-CDF alphas, the shade selection of the 16 heaviest sections, the
losses (L1 colour, mask BCE, Eikonal on rays and in space, shell, origin,
normals), the global-norm clip at 1, Adam under a linear warm-up and cosine
decay, the variance band and the background's own step.

Every random value is drawn at a path of a key tree (``Key``), each node a
``torch.Generator`` seeded from the root seed and its path, so the reference
draws what the stage draws for the same seed and step.  Float32; run it
with TF32 off.  Plain PyTorch only; this file imports nothing of the program.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
_TINY = float(np.finfo(np.float32).tiny)


class Key:
    def __init__(self, seed: int, device, path: tuple = ()):
        self.seed, self.device, self.path = int(seed), torch.device(device), tuple(path)
        self._gen = None

    def split(self, n: int = 2):
        return [Key(self.seed, self.device, self.path + (("split", n, j),)) for j in range(n)]

    def fold_in(self, i: int):
        return Key(self.seed, self.device, self.path + (("fold_in", int(i)),))

    def gen(self) -> torch.Generator:
        if self._gen is None:
            digest = hashlib.sha256(repr((self.seed, self.path)).encode()).digest()
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return self._gen


def draw(key: Key, kind: str, shape, low: float = 0.0, high: float = 1.0) -> Tensor:
    g, d = key.gen(), key.device
    if kind == "uniform":
        return low + (high - low) * torch.rand(shape, generator=g, device=d)
    if kind == "normal":
        return torch.randn(shape, generator=g, device=d)
    return torch.randint(int(low), int(high), shape, generator=g, device=d)


def tf32(x: Tensor) -> Tensor:
    """x rounded to TF32's 10-bit mantissa (to nearest, ties to even); the
    gradient passes straight through."""
    xd = x.detach().contiguous()
    i = xd.view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0xFFF)) & ~0x1FFF
    return x + (i.view(torch.float32) - xd)


def pe(x: Tensor, n: int) -> Tensor:
    outs = [x]
    for i in range(n):
        f = (2.0**i) * math.pi
        outs += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(outs, -1)


def _lin(w: Tensor) -> nn.Linear:
    lin = nn.Linear(w.shape[0], w.shape[1], device="meta").to_empty(device=w.device)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        lin.bias.zero_()
    return lin


class Field(nn.Module):
    """SDF network, colour head and the global ``variance`` (s = exp(10 v))."""

    def __init__(self, cfg: dict, key: Key, quant=None):
        super().__init__()
        self.cfg, self.quant = cfg, quant
        k_sdf, k_col = key.split()
        nf, hid, depth, skip = cfg["pe_freqs"], cfg["hidden"], cfg["depth"], cfg["skip_layer"]
        in_dim = 3 + 6 * nf
        dims = [in_dim] + [hid] * depth
        keys = k_sdf.split(depth + 1)
        layers = []
        for i in range(depth):
            d_in = dims[i] + (in_dim if i == skip else 0)
            w = float(np.sqrt(2.0) / np.sqrt(dims[i + 1])) * draw(keys[i], "normal", (d_in, dims[i + 1]))
            if i == 0:
                w[3:, :] = 0.0
            if i == skip:
                w[dims[i] + 3:, :] = 0.0
            layers.append(_lin(w))
        self.layers = nn.ModuleList(layers)
        w_out = torch.empty((hid, 1 + cfg["feat_dim"]), device=key.device)
        w_out[:, 0] = float(np.sqrt(np.pi) / np.sqrt(hid)) * draw(keys[-1], "normal", (hid,)).abs()
        w_out[:, 1:] = 0.01 * draw(keys[-1].split()[0], "normal", (hid, cfg["feat_dim"]))
        self.out = _lin(w_out)
        with torch.no_grad():
            self.out.bias[0] = -cfg["geometric_init_radius"]
        c_in = 3 + (3 + 6 * cfg["dir_freqs"]) + 3 + cfg["feat_dim"]
        cdims = [c_in] + [cfg["color_hidden"]] * (cfg["color_depth"] - 1) + [3]
        ckeys = k_col.split(len(cdims))
        self.color = nn.ModuleList(
            _lin(float(np.sqrt(2.0 / a)) * draw(ckeys[i], "normal", (a, b)))
            for i, (a, b) in enumerate(zip(cdims[:-1], cdims[1:])))
        self.variance = nn.Parameter(torch.tensor(0.3, device=key.device))

    def _lin(self, lyr: nn.Linear, h: Tensor) -> Tensor:
        if self.quant is None:
            return lyr(h)
        return F.linear(self.quant(h), self.quant(lyr.weight), lyr.bias)

    def sdf(self, x: Tensor):
        h0 = pe(x, self.cfg["pe_freqs"])
        h = h0
        for i, lyr in enumerate(self.layers):
            if i == self.cfg["skip_layer"]:
                h = torch.cat([h, h0], -1)
            h = F.softplus(self._lin(lyr, h) * 100.0) / 100.0
        out = self._lin(self.out, h)
        return out[..., 0], out[..., 1:]

    def rgb(self, x, dirs, normals, feat):
        h = torch.cat([x, pe(dirs, self.cfg["dir_freqs"]), normals, feat], -1)
        for i, lyr in enumerate(self.color):
            h = self._lin(lyr, h)
            if i + 1 < len(self.color):
                h = torch.relu(h)
        return torch.sigmoid(h)

    def grad(self, x: Tensor) -> Tensor:
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.sdf(xg)[0].sum(), xg, create_graph=keep)
        return g if keep else g.detach()


def clip(x: Tensor, lo=None, hi=None) -> Tensor:
    """max / min against a constant, the gradient split at a tie."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def safe_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    return torch.sqrt(torch.sum(x * x, -1, keepdim=True) + eps * eps)


def safe_normalize(x: Tensor, eps: float = 1e-6) -> Tensor:
    return x / safe_norm(x, eps)


@torch.no_grad()
def occupancy(field: Field, rc: dict, tau_scale: float = 2.0) -> Tensor:
    """Flat (R³,) grid: |sdf(centre)| < tau_scale x the cell diagonal,
    dilated by one cell."""
    r, b = rc["occ_res"], rc["bound"]
    dev = field.variance.device
    c = (torch.arange(r, device=dev) + 0.5) / r * (2 * b) - b
    gx, gy, gz = torch.meshgrid(c, c, c, indexing="ij")
    sdf = field.sdf(torch.stack([gx, gy, gz], -1).reshape(-1, 3))[0]
    tau = torch.tensor(tau_scale * 2.0 * b / r, dtype=torch.float32) * torch.sqrt(torch.tensor(3.0))
    o = (sdf.abs() < tau.to(dev)).float().reshape(r, r, r)
    for ax in range(3):
        o = torch.maximum(o, torch.maximum(torch.roll(o, 1, ax), torch.roll(o, -1, ax)))
    return o.reshape(-1)


class Data(NamedTuple):
    images: Tensor  # (F, H, W, 3)
    masks: Tensor  # (F, H, W)
    normals: Tensor  # (F, H, W, 3) OpenGL-convention camera normals
    R_rows: Tensor  # (F, 3, 3) object -> camera, X_cam = X @ R + T
    Ts: Tensor  # (F, 3)
    K: Tensor  # (3, 3)


def _rays(xy, K, R, T, bound):
    x = (xy[:, 0] - K[0, 2]) / K[0, 0]
    y = (xy[:, 1] - K[1, 2]) / K[1, 1]
    d_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    d = torch.einsum("nj,nkj->nk", d_cam, R)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = -torch.einsum("nj,nkj->nk", T, R)
    bb = torch.sum(o * d, -1)
    cc = torch.sum(o * o, -1) - bound * bound
    sq = torch.sqrt(torch.clamp_min(bb * bb - cc, 0.0))
    near = torch.clamp_min(-bb - sq, 1e-3)
    return o, d, near, torch.maximum(-bb + sq, near + 1e-3)


def _linspace01(n, dev):
    return torch.cat([torch.arange(n - 1, device=dev, dtype=torch.float32) / (n - 1),
                      torch.ones(1, device=dev)])


def _sample_pdf(bins, weights, n, key):
    w = weights + 1e-5
    cdf = torch.cumsum(w / torch.sum(w, -1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = draw(key, "uniform", cdf.shape[:-1] + (n,))
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    last = bins.shape[-1] - 1
    below, above = torch.clamp(idx - 1, 0, last), torch.clamp(idx, 0, last)
    cb, ca = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bb, ba = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = torch.where(ca - cb < 1e-5, 1.0, ca - cb)
    return bb + (u - cb) / denom * (ba - bb)


def render(field: Field, rc: dict, o, d, near, far, key: Key, occ: Tensor):
    """(rgb, acc, normal, eikonal) of a ray batch."""
    k_strat, _ = key.split()
    dev = o.device
    tc = near[:, None] + (far - near)[:, None] * _linspace01(rc["n_candidates"], dev)[None]
    mid_c = 0.5 * (tc[..., 1:] + tc[..., :-1])
    pts = o[:, None] + mid_c[..., None] * d[:, None]
    r, b = rc["occ_res"], rc["bound"]
    ijk = torch.clamp(((pts + b) / (2 * b) * r).to(torch.int64), 0, r - 1)
    w_occ = occ[(ijk[..., 0] * r + ijk[..., 1]) * r + ijk[..., 2]] + 1e-3
    t = torch.sort(_sample_pdf(tc, w_occ, rc["n_occ_samples"], k_strat), -1)[0].detach()
    sdf, feat = field.sdf(o[:, None] + t[..., None] * d[:, None])
    s = torch.exp(10.0 * field.variance)
    prev, nxt = torch.sigmoid(s * sdf[..., :-1]), torch.sigmoid(s * sdf[..., 1:])
    alpha = clip((prev - nxt) / (prev + 1e-5), 0.0, 1.0)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-7], -1), -1)
    weights = alpha * trans[..., :-1]
    mid_t = 0.5 * (t[..., 1:] + t[..., :-1])
    mid_feat = 0.5 * (feat[..., 1:, :] + feat[..., :-1, :])
    acc = torch.sum(weights, -1)
    k = rc["n_shade"]
    w_det = weights.detach()
    sel = torch.sort(torch.where(w_det < _TINY, 0.0, w_det), dim=-1, descending=True,
                     stable=True)[1][..., :k]
    w_sel = torch.gather(weights, -1, sel)
    w_shade = w_sel * (torch.sum(weights, -1, keepdim=True) / clip(torch.sum(w_sel, -1, keepdim=True), 1e-6))
    mid_t = torch.gather(mid_t, -1, sel)
    mid_feat = torch.gather(mid_feat, -2, sel[..., None].expand(sel.shape + mid_feat.shape[-1:]))
    mid_pts = o[:, None] + mid_t[..., None] * d[:, None]
    g = field.grad(mid_pts)
    normals = safe_normalize(g, eps=0.05)
    rgb = torch.sum(w_shade[..., None] * field.rgb(mid_pts, d[:, None].expand(mid_pts.shape), normals, mid_feat), -2)
    normal = torch.sum(w_shade[..., None] * normals, -2)
    eik = torch.mean((safe_norm(g)[..., 0] - 1.0) ** 2)
    return rgb, acc, normal, eik


def loss_fn(field: Field, bg: Tensor, key: Key, data: Data, occ: Tensor, rc: dict, tc: dict):
    k_pix, k_render, _, k_eik, k_shell = key.split(5)
    f, h, w = data.masks.shape
    k1, k2, k3 = k_pix.split(3)
    n = tc["batch_rays"]
    fr = draw(k1, "randint", (n,), 0, f)
    xi = draw(k2, "randint", (n,), 0, w)
    yi = draw(k3, "randint", (n,), 0, h)
    xy = torch.stack([xi + 0.5, yi + 0.5], -1).float()
    rgb_gt, mask_gt, nrm_gt = data.images[fr, yi, xi], data.masks[fr, yi, xi], data.normals[fr, yi, xi]
    o, d, near, far = _rays(xy, data.K, data.R_rows[fr], data.Ts[fr], rc["bound"])
    rgb, acc, normal, eik = render(field, rc, o, d, near, far, k_render, occ)
    rgb_pred = rgb + (1.0 - acc[:, None]) * torch.sigmoid(bg)
    l_rgb = torch.abs(rgb_pred - rgb_gt).mean()
    a = clip(acc, 1e-4, 1.0 - 1e-4)
    l_mask = -(mask_gt * torch.log(a) + (1.0 - mask_gt) * torch.log(1.0 - a)).mean()
    pts_u = rc["bound"] * draw(k_eik, "uniform", (tc["n_eikonal_uniform"], 3), -1.0, 1.0)
    eik = 0.5 * (eik + torch.mean((safe_norm(field.grad(pts_u))[..., 0] - 1.0) ** 2))
    loss = tc["lw_rgb"] * l_rgb + tc["lw_mask"] * l_mask + tc["lw_eikonal"] * eik
    k_dir, k_rad = k_shell.split()
    dd = draw(k_dir, "normal", (128, 3))
    dd = dd / clip(torch.linalg.norm(dd, dim=-1, keepdim=True), 1e-9)
    rr = rc["bound"] * draw(k_rad, "uniform", (128, 1), tc["shell_radius"], 1.0)
    loss = loss + tc["lw_shell"] * torch.relu(tc["shell_margin"] - field.sdf(dd * rr)[0]).mean()
    pts_o = 0.05 * draw(k_shell.fold_in(1), "normal", (16, 3))
    loss = loss + tc["lw_origin"] * torch.relu(field.sdf(pts_o)[0] + tc["origin_margin"]).mean()
    n_cam = torch.einsum("nj,njk->nk", normal, data.R_rows[fr])
    nrm_ref = nrm_gt * nrm_gt.new_tensor([1.0, -1.0, -1.0])
    cos = torch.sum(safe_normalize(n_cam, eps=0.1) * safe_normalize(nrm_ref, eps=0.1), -1)
    return loss + tc["lw_normal"] * ((1.0 - cos) * mask_gt).sum() / (mask_gt.sum() + 1e-6)


class Trainer:
    """The field, Adam and its schedule, the background and the step count."""

    def __init__(self, seed: int, device, field_cfg: dict, rc: dict, tc: dict, quant=None):
        self.field = Field(field_cfg, Key(seed, device), quant)
        self.rc, self.tc = rc, tc
        self.opt = torch.optim.Adam(self.field.parameters(), lr=tc["lr"], betas=(0.9, 0.999), eps=1e-8)
        self.bg = torch.zeros(3, device=device, requires_grad=True)
        self.step = 0

    def lr_factor(self, count: int) -> float:
        warm, total = self.tc["warmup"], max(self.tc["num_steps"], self.tc["warmup"] + 1)
        if count < warm:
            return count / warm
        return 0.5 * (1.0 + math.cos(math.pi * min(count - warm, total - warm) / (total - warm)))

    def band(self, step: int):
        tc = self.tc

        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        frac = torch.clamp(f32(step) / max(tc["num_steps"], 1), 0, 1)
        s_max = tc["s_max_start"] * torch.pow(f32(tc["s_max_end"] / tc["s_max_start"]), frac)
        s_min = tc["s_min_start"] * torch.pow(f32(tc["s_min_end"] / tc["s_min_start"]), frac)
        return float(torch.log(s_min) / 10.0), float(torch.log(s_max) / 10.0)

    def train_step(self, key: Key, data: Data, occ: Tensor) -> Tensor:
        """One step; returns the loss before the update."""
        self.opt.zero_grad(set_to_none=True)
        self.bg.grad = None
        loss = loss_fn(self.field, self.bg, key, data, occ, self.rc, self.tc)
        loss.backward()
        grads = [p.grad for p in self.field.parameters() if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < 1.0, g, g / norm))
        for group in self.opt.param_groups:
            group["lr"] = self.tc["lr"] * self.lr_factor(self.step)
        self.opt.step()
        lo, hi = self.band(self.step)
        with torch.no_grad():
            self.field.variance.clamp_(lo, hi)
            self.bg -= 1e-2 * self.bg.grad
        self.step += 1
        return loss.detach()
