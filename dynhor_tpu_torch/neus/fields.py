"""Neural SDF + radiance fields of the reconstruction stage (PyTorch).

Port of ``dynhor_tpu/neus/fields.py``.  Two encoders share the colour head:

  * "pe":   frequency positional encoding + an MLP with a skip layer and
            the geometric (sphere) init of IGR/NeuS;
  * "hash": a multiresolution hash grid (instant-NGP) + a small MLP on top
            of the analytic sphere ``|x| - r``.

A third, "ngp", has no counterpart in the JAX package: instant-nsr-pl's
NeuS field (``configs/neus-blender.yaml``), tiny-cuda-nn's ``HashGrid``
(dense levels where the level's vertices fit the table, a half-cell
offset, ``include_xyz``) under a weight-normed, sphere-initialised
softplus MLP whose 13 outputs are the SDF and the feature, and a texture
MLP on the feature, the view direction's degree-4 spherical harmonics and
the normal (``NGPSDF``, ``SHTexture``).

``NeuSField`` holds the SDF network, the colour head and NeuS's global
``variance`` (inv_std = exp(10 v)).  Linear layers are ``nn.Linear``, so a
JAX weight ``w`` (d_in, d_out) is ``weight = w.T`` here
(``params_from_jax``).  The init draws through ``draws.draw`` along the
JAX init's key tree and reproduces its structure: zeroed PE columns in
layer 0 and the skip layer, a ``|N|`` sdf column, the out bias ``-r``, a
hash table in ±1e-4 and a final hash layer scaled by 0.01.

The hash encoder is a gather from one flattened table (``index_select``,
whose backward is ``index_add_``); nothing of this module is a TPU kernel
(the JAX package leaves it to XLA).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import profiling as PF
from . import draws
from .draws import Key

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    encoder: str = "pe"  # "pe" | "hash" | "ngp"
    # pe encoder / MLP
    pe_freqs: int = 6
    hidden: int = 256
    depth: int = 8
    skip_layer: int = 4
    feat_dim: int = 256
    geometric_init_radius: float = 0.5  # objects normalized to |v| <= 0.5
    # hash encoder
    hash_levels: int = 16
    hash_features: int = 2
    hash_table_size: int = 2**19
    hash_base_res: int = 16
    hash_max_res: int = 2048
    hash_hidden: int = 64
    hash_depth: int = 2
    # SDF spatial-gradient mode: "auto" = "analytic" for the PE and ngp
    # fields, "forward" for the hash encoder (the JAX package's choices;
    # both are the exact derivative, computed here by one reverse pass), or
    # "numerical" (central differences with grad_eps).
    grad_mode: str = "auto"  # "auto" | "analytic" | "forward" | "numerical"
    grad_eps: float = 2e-3
    # color head
    color_hidden: int = 256
    color_depth: int = 4
    dir_freqs: int = 4
    # domain
    bound: float = 1.0  # field domain [-bound, bound]^3
    # The "ngp" encoder reads hash_levels, hash_features, hash_table_size,
    # hash_base_res and hash_max_res (a level scale of (max / base)^(1 /
    # (L - 1))), hash_hidden and hash_depth (the geometry MLP's width and
    # hidden layers), feat_dim (its outputs, the SDF first among them),
    # color_hidden and color_depth (the texture's width and linear layers);
    # NGP_WIDTHS holds instant-nsr-pl's (``config_for("ngp")``).


NGP_WIDTHS = {"hash_base_res": 32, "hash_max_res": 2048, "hash_hidden": 64, "hash_depth": 1,
              "feat_dim": 13, "color_hidden": 64, "color_depth": 3}


def config_for(encoder: str) -> SDFConfig:
    """The default configuration of an encoder: ``SDFConfig``'s defaults,
    at instant-nsr-pl's widths for "ngp"."""
    return SDFConfig(encoder=encoder, **(NGP_WIDTHS if encoder == "ngp" else {}))


def clip(x: Tensor, lo: float | None = None, hi: float | None = None) -> Tensor:
    """``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` against a constant,
    with their gradient: at a tie the gradient is split in half
    (``torch.clamp`` would pass all of it).  The constant is a CPU scalar
    tensor, which a device kernel takes as an argument: no copy to the
    device, so no wait for it."""
    if lo is not None:
        x = torch.maximum(x, torch.tensor(lo, dtype=x.dtype))
    if hi is not None:
        x = torch.minimum(x, torch.tensor(hi, dtype=x.dtype))
    return x


def positional_encoding(x: Tensor, n_freqs: int) -> Tensor:
    """NeRF-style sin/cos encoding, the input first. x: (..., D) ->
    (..., D * (2 * n_freqs) + D)."""
    outs = [x]
    for i in range(n_freqs):
        f = (2.0**i) * math.pi
        outs.append(torch.sin(f * x))
        outs.append(torch.cos(f * x))
    return torch.cat(outs, dim=-1)


def _pe_dim(d: int, n_freqs: int) -> int:
    return d + d * 2 * n_freqs


def _linear(d_in: int, d_out: int, w: Tensor) -> nn.Linear:
    """An ``nn.Linear`` holding the JAX-layout weight ``w`` (d_in, d_out)
    and a zero bias (no default init, so the global RNG is not touched)."""
    lin = nn.Linear(d_in, d_out, device="meta").to_empty(device=w.device)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        lin.bias.zero_()
    return lin


class PESDF(nn.Module):
    """Positional encoding + ``depth`` softplus layers (skip at
    ``skip_layer``) + a linear (1 + feat_dim) head; geometric init
    (Atzmon & Lipman SAL / IGR): the network starts as an approximate
    sphere SDF of radius ``geometric_init_radius``."""

    def __init__(self, cfg: SDFConfig, key: Key):
        super().__init__()
        self.cfg = cfg
        in_dim = _pe_dim(3, cfg.pe_freqs)
        dims = [in_dim] + [cfg.hidden] * cfg.depth
        keys = key.split(cfg.depth + 1)
        layers = []
        for i in range(cfg.depth):
            d_in = dims[i] + (in_dim if i == cfg.skip_layer else 0)
            d_out = dims[i + 1]
            w = float(np.sqrt(2.0) / np.sqrt(d_out)) * draws.draw(keys[i], "normal", (d_in, d_out))
            if i == 0:  # only the raw-xyz part of the input contributes initially
                w[3:, :] = 0.0
            if i == cfg.skip_layer:
                w[dims[i] + 3:, :] = 0.0
            layers.append(_linear(d_in, d_out, w))
        self.layers = nn.ModuleList(layers)
        d_last = dims[-1]
        std = float(np.sqrt(np.pi) / np.sqrt(d_last))
        w_out = torch.empty((d_last, 1 + cfg.feat_dim), device=key.device)
        w_out[:, 0] = std * draws.draw(keys[-1], "normal", (d_last,)).abs()
        w_out[:, 1:] = 0.01 * draws.draw(keys[-1].split()[0], "normal", (d_last, cfg.feat_dim))
        self.out = _linear(d_last, 1 + cfg.feat_dim, w_out)
        with torch.no_grad():
            self.out.bias[0] = -cfg.geometric_init_radius

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x: (..., 3) -> (sdf (...,), feat (..., feat_dim)); sdf ~ |x| - r
        at init (negative inside)."""
        h0 = positional_encoding(x, self.cfg.pe_freqs)
        h = h0
        for i, lyr in enumerate(self.layers):
            if i == self.cfg.skip_layer:
                h = torch.cat([h, h0], dim=-1)
            h = F.softplus(lyr(h) * 100.0) / 100.0  # beta=100 softplus (IGR/NeuS)
        out = self.out(h)
        return out[..., 0], out[..., 1:]


# ---------------------------------------------------------------------------
# Multiresolution hash encoding (instant-NGP)
# ---------------------------------------------------------------------------

_HASH_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def hash_level_resolutions(cfg: SDFConfig) -> np.ndarray:
    growth = np.exp(
        (np.log(cfg.hash_max_res) - np.log(cfg.hash_base_res)) / max(cfg.hash_levels - 1, 1)
    )
    return np.floor(cfg.hash_base_res * growth ** np.arange(cfg.hash_levels)).astype(np.int32)


def hash_indices(x01: Tensor, cfg: SDFConfig) -> tuple[list[Tensor], list[Tensor]]:
    """Flat table rows and trilinear weights of the 8 cell corners at every
    level.  x01: (..., 3) in [0, 1].  Returns 8 index tensors (..., L)
    int64 into the (L*T, F) table and 8 weights (..., L, 1).

    The hash is instant-NGP's: a uint32 wrapping multiply by the primes,
    XOR, ``% T``; computed in int64 with the product masked to 32 bits, so
    the rows are exactly the JAX package's."""
    res = torch.as_tensor(hash_level_resolutions(cfg), dtype=x01.dtype, device=x01.device)
    t_size = cfg.hash_table_size
    level_off = torch.arange(cfg.hash_levels, device=x01.device, dtype=torch.int64) * t_size
    xs = x01[..., None, :] * res[:, None]  # (..., L, 3)
    x0 = torch.floor(xs)
    frac = xs - x0
    x0i = x0.to(torch.int64)
    rows, weights = [], []
    for ci in range(8):
        c = ((ci >> 2) & 1, (ci >> 1) & 1, ci & 1)
        h = [((x0i[..., d] + c[d]) * _HASH_PRIMES[d]) & _U32 for d in range(3)]
        rows.append((h[0] ^ h[1] ^ h[2]) % t_size + level_off)
        w = [frac[..., d] if c[d] else 1.0 - frac[..., d] for d in range(3)]
        weights.append((w[0] * w[1] * w[2])[..., None])
    return rows, weights


def hash_encode(table: Tensor, x01: Tensor, cfg: SDFConfig) -> Tensor:
    """Multiresolution hash encoding.  table: (L, T, F); x01: (..., 3) in
    [0, 1].  Returns (..., L*F)."""
    levels, feats_per = cfg.hash_levels, cfg.hash_features
    flat = table.reshape(levels * cfg.hash_table_size, feats_per)
    rows, weights = hash_indices(x01, cfg)
    feats = 0.0
    for idx, w in zip(rows, weights):
        g = flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (feats_per,))
        feats = feats + g * w
    return feats.reshape(feats.shape[:-2] + (levels * feats_per,))


class HashSDF(nn.Module):
    """Hash grid + ReLU MLP predicting a residual on ``|x| - r``, so the
    field starts as a true sphere (instant-nsr-pl style)."""

    def __init__(self, cfg: SDFConfig, key: Key):
        super().__init__()
        self.cfg = cfg
        keys = key.split(4)
        shape = (cfg.hash_levels, cfg.hash_table_size, cfg.hash_features)
        self.table = nn.Parameter(1e-4 * draws.draw(keys[0], "uniform", shape, -1.0, 1.0))
        enc_dim = cfg.hash_levels * cfg.hash_features
        dims = [enc_dim] + [cfg.hash_hidden] * cfg.hash_depth + [1 + cfg.feat_dim]
        mlp = []
        for i in range(len(dims) - 1):
            std = float(np.sqrt(2.0 / dims[i]))
            w = std * draws.draw(keys[1 + i % 2], "normal", (dims[i], dims[i + 1]))
            if i == len(dims) - 2:
                w = 0.01 * w  # zero-centred final layer
            mlp.append(_linear(dims[i], dims[i + 1], w))
        self.mlp = nn.ModuleList(mlp)

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x in [-bound, bound]^3 -> (sdf, feat)."""
        cfg = self.cfg
        x01 = clip((x / cfg.bound + 1.0) / 2.0, 0.0, 1.0)
        h = hash_encode(self.table, x01, cfg)
        for lyr in self.mlp[:-1]:
            h = torch.relu(lyr(h))
        out = self.mlp[-1](h)
        sphere = torch.linalg.norm(x, dim=-1) - cfg.geometric_init_radius
        return out[..., 0] + sphere, out[..., 1:]


# ---------------------------------------------------------------------------
# instant-nsr-pl's NeuS field: tiny-cuda-nn's hash grid, weight-normed MLPs
# ---------------------------------------------------------------------------

class NGPLevel(NamedTuple):
    scale: float  # s_l, rounded to f32
    res: int  # R_l = ceil(s_l) + 1 vertices an axis
    rows: int  # table rows: R_l^3 rounded up to 8 where that fits T, else T
    offset: int  # first row in the flat table
    dense: bool  # indexed densely (R_l^3 <= T), else hashed


def ngp_levels(cfg: SDFConfig) -> list[NGPLevel]:
    """tiny-cuda-nn's grid levels: s_l = base * scale^l - 1 with scale =
    (max_res / base)^(1 / (L - 1)), R_l = ceil(s_l) + 1; a level whose R_l^3
    vertices fit the table is indexed densely and holds only those rows
    (rounded up to a multiple of 8), as tiny-cuda-nn allocates it."""
    base = cfg.hash_base_res
    per_level = np.exp((np.log(cfg.hash_max_res) - np.log(base)) / max(cfg.hash_levels - 1, 1))
    out, offset = [], 0
    for lvl in range(cfg.hash_levels):
        scale = float(np.float32(base * per_level**lvl - 1.0))
        res = math.ceil(scale) + 1
        dense = res**3 <= cfg.hash_table_size
        rows = -(-res**3 // 8) * 8 if dense else cfg.hash_table_size
        out.append(NGPLevel(scale, res, rows, offset, dense))
        offset += rows
    return out


class NGPGrid(NamedTuple):
    """The levels' constants on a device, for ``ngp_indices``."""
    scale: Tensor  # (L,) s_l
    mult: Tensor  # (L, 3) int64: a dense level's strides (1, R, R^2), else the primes
    dense: Tensor  # (L,) bool
    rows: Tensor  # (L,) int64
    offset: Tensor  # (L,) int64
    bits: Tensor  # (8, 3) int64: corner i's step on axis d, bit d of i


def ngp_grid(cfg: SDFConfig, device) -> NGPGrid:
    levels = ngp_levels(cfg)

    def per_level(field, dtype=torch.int64):
        return torch.tensor([getattr(lv, field) for lv in levels], dtype=dtype, device=device)

    res, dense = per_level("res"), per_level("dense", torch.bool)
    strides = torch.stack([torch.ones_like(res), res, res * res], dim=-1)
    mult = torch.where(dense[:, None], strides, strides.new_tensor(_HASH_PRIMES))
    bits = (torch.arange(8, device=device)[:, None] >> torch.arange(3, device=device)) & 1
    return NGPGrid(per_level("scale", torch.float32), mult, dense, per_level("rows"),
                   per_level("offset"), bits)


def ngp_indices(x01: Tensor, grid: NGPGrid) -> tuple[Tensor, Tensor]:
    """Flat table rows and trilinear weights of the 8 cell corners at every
    level, tiny-cuda-nn's order (corner i takes c + 1 on axis d where bit d
    of i is set).  x01: (..., 3) in [0, 1].  Returns rows (8, ..., L) int64
    into the flat table and weights (8, ..., L, 1), the corners first.

    The cell: p = x01 * s_l + 0.5, c = floor(p), weights from p - c.  A
    dense level's row is (c_x + R c_y + R^2 c_z) mod its rows, a hashed
    level's (c_x ^ c_y * 2654435761 ^ c_z * 805459861) mod 2^32 mod T; the
    level's first row is added.  Every corner at once, in a few passes."""
    p = x01[..., None, :] * grid.scale[:, None] + 0.5  # (..., L, 3)
    c = torch.floor(p)
    frac = p - c
    bits = grid.bits.reshape((8,) + (1,) * (p.dim() - 1) + (3,))
    t = ((c.to(torch.int64) + bits) * grid.mult) & _U32  # (8, ..., L, 3)
    rows = torch.where(grid.dense, t.sum(-1), t[..., 0] ^ t[..., 1] ^ t[..., 2])
    w = torch.where(bits.bool(), frac, 1.0 - frac)
    return rows % grid.rows + grid.offset, (w[..., 0] * w[..., 1] * w[..., 2])[..., None]


def interpolate(table: Tensor, rows: Tensor, weights: Tensor) -> Tensor:
    """The weighted sum over the corners of the rows of ``table`` (R, F):
    rows and weights as ``ngp_indices`` gives them.  One gather of every
    corner's rows, so that the backward scatter-adds into one gradient of
    the table.  Returns (..., L*F)."""
    g = table.index_select(0, rows.reshape(-1)).reshape(rows.shape + table.shape[1:])
    feats = (g * weights).sum(0)
    return feats.reshape(feats.shape[:-2] + (-1,))


class WNLinear(nn.Module):
    """A weight-normed linear layer: w = g * v / |v| per output row (``g``
    (out, 1), ``v`` (out, in)), then the bias."""

    def __init__(self, v: Tensor, bias: Tensor):
        super().__init__()
        self.g = nn.Parameter(v.norm(dim=1, keepdim=True))
        self.v = nn.Parameter(v)
        self.bias = nn.Parameter(bias)

    def forward(self, h: Tensor) -> Tensor:
        return F.linear(h, self.v * (self.g / self.v.norm(dim=1, keepdim=True)), self.bias)


class NGPSDF(nn.Module):
    """instant-nsr-pl's geometry: u = clip((x / bound + 1) / 2, 0, 1), the
    encoding [2u - 1, the hash grid's L * F features], weight-normed linear
    layers with softplus(beta = 100) between, sphere init (first layer: the
    grid's columns 0, the xyz columns N(0, sqrt(2 / width)); hidden layers
    N(0, sqrt(2 / width)); last layer N(sqrt(pi / width), 1e-4) with bias
    -r).  The SDF is output 0, the feature all ``feat_dim`` outputs.

    The table (sum of the levels' rows, F) starts uniform in +-1e-4.  Under
    the recorder each call's encoding is the span ``neus.encode``, its
    backward ``neus.encode_bwd`` (from the encoding's gradient to the last
    of the table's and the points' that the pass computes; under
    ``sdf_grad``'s graph, also the backward of that backward, from the
    gradient of the points' gradient to that of the encoding's), with the
    counters ``neus.encoded_points`` and
    ``neus.hash_lookups`` (8 corner reads a level a point)."""

    def __init__(self, cfg: SDFConfig, key: Key):
        super().__init__()
        self.cfg = cfg
        k_table, k_first, k_mid, k_last = key.split(4)
        rows = sum(lv.rows for lv in ngp_levels(cfg))
        self.table = nn.Parameter(
            1e-4 * draws.draw(k_table, "uniform", (rows, cfg.hash_features), -1.0, 1.0))
        hid = cfg.hash_hidden
        n_in = 3 + cfg.hash_levels * cfg.hash_features
        std = float(np.sqrt(2.0) / np.sqrt(hid))
        dev = key.device
        v_first = torch.zeros((hid, n_in), device=dev)
        v_first[:, :3] = std * draws.draw(k_first, "normal", (hid, 3))
        layers = [WNLinear(v_first, torch.zeros(hid, device=dev))]
        for i in range(cfg.hash_depth - 1):
            v = std * draws.draw(k_mid.fold_in(i), "normal", (hid, hid))
            layers.append(WNLinear(v, torch.zeros(hid, device=dev)))
        v_last = float(np.sqrt(np.pi) / np.sqrt(hid)) + 1e-4 * draws.draw(
            k_last, "normal", (cfg.feat_dim, hid))
        layers.append(WNLinear(v_last, torch.full((cfg.feat_dim,), -cfg.geometric_init_radius,
                                                  device=dev)))
        self.layers = nn.ModuleList(layers)
        self._grids: dict = {}  # device -> the levels' constants there

    def encode(self, x: Tensor) -> Tensor:
        """x in [-bound, bound]^3 -> (..., 3 + L*F)."""
        cfg = self.cfg
        with PF.span("neus.encode"):
            # Views, nodes of this call's own that the backward span waits for
            # (a leaf's gradient cannot be awaited in ``torch.autograd.grad``).
            x, table = x.view_as(x), self.table.view_as(self.table)
            x01 = clip((x / cfg.bound + 1.0) / 2.0, 0.0, 1.0)
            grid = self._grids.get(x.device)
            if grid is None:
                grid = self._grids[x.device] = ngp_grid(cfg, x.device)
            enc = torch.cat([2.0 * x01 - 1.0, interpolate(table, *ngp_indices(x01, grid))], dim=-1)
        n = x.numel() // 3
        PF.count("neus.encoded_points", n)
        PF.count("neus.hash_lookups", n * cfg.hash_levels * 8)
        PF.span_between_grads("neus.encode_bwd", enc, table, x)
        return enc

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """x in [-bound, bound]^3 -> (sdf (...,), feat (..., feat_dim))."""
        h = self.encode(x)
        for lyr in self.layers[:-1]:
            h = F.softplus(lyr(h), beta=100.0)
        out = self.layers[-1](h)
        return out[..., 0], out


def sh4(d: Tensor) -> Tensor:
    """Real spherical harmonics of degree 0..3 of unit directions (..., 3),
    tiny-cuda-nn's ``SphericalHarmonics`` basis and order (16 values)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * xx - 0.54627421529603959 * yy,
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


class SHTexture(nn.Module):
    """instant-nsr-pl's texture: [feature, SH_4(dir), normal] -> ReLU MLP
    without biases (tiny-cuda-nn's ``FullyFusedMLP``, Xavier-uniform init)
    -> sigmoid rgb.  The point itself is not an input."""

    def __init__(self, cfg: SDFConfig, key: Key):
        super().__init__()
        dims = [cfg.feat_dim + 16 + 3] + [cfg.color_hidden] * (cfg.color_depth - 1) + [3]
        keys = key.split(len(dims) - 1)
        layers = []
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            a = float(np.sqrt(6.0 / (d_in + d_out)))
            lin = nn.Linear(d_in, d_out, bias=False, device="meta").to_empty(device=key.device)
            with torch.no_grad():
                lin.weight.copy_(draws.draw(keys[i], "uniform", (d_out, d_in), -a, a))
            layers.append(lin)
        self.layers = nn.ModuleList(layers)

    def forward(self, x, dirs, normals, feat) -> Tensor:
        h = torch.cat([feat, sh4(dirs), normals], dim=-1)
        for i, lyr in enumerate(self.layers):
            h = lyr(h)
            if i + 1 < len(self.layers):
                h = torch.relu(h)
        return torch.sigmoid(h)


# ---------------------------------------------------------------------------
# Color head + variance (shared)
# ---------------------------------------------------------------------------

class ColorHead(nn.Module):
    """(x, dir PE, normal, feat) -> ReLU MLP -> sigmoid rgb."""

    def __init__(self, cfg: SDFConfig, key: Key):
        super().__init__()
        self.cfg = cfg
        in_dim = 3 + _pe_dim(3, cfg.dir_freqs) + 3 + cfg.feat_dim
        dims = [in_dim] + [cfg.color_hidden] * (cfg.color_depth - 1) + [3]
        keys = key.split(len(dims))
        self.layers = nn.ModuleList(
            _linear(d_in, d_out,
                    float(np.sqrt(2.0 / d_in)) * draws.draw(keys[i], "normal", (d_in, d_out)))
            for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:]))
        )

    def forward(self, x, dirs, normals, feat) -> Tensor:
        h = torch.cat([x, positional_encoding(dirs, self.cfg.dir_freqs), normals, feat], dim=-1)
        n = len(self.layers)
        for i, lyr in enumerate(self.layers):
            h = lyr(h)
            if i + 1 < n:
                h = torch.relu(h)
        return torch.sigmoid(h)


def init_variance(init_val: float = 0.3) -> Tensor:
    """NeuS single global variance parameter; s = exp(10 * v)."""
    return torch.tensor(init_val)


def inv_std(variance: Tensor) -> Tensor:
    return torch.exp(10.0 * variance)


class NeuSField(nn.Module):
    """The SDF network (PE, hash or ngp), the colour head (the ngp field's
    texture) and ``variance``, initialised from ``key`` as
    ``init_field_params`` splits its key."""

    def __init__(self, cfg: SDFConfig, key: Key | None = None):
        super().__init__()
        key = key if key is not None else Key(0)
        k1, k2 = key.split()
        self.cfg = cfg
        if cfg.encoder == "ngp":
            self.sdf, self.color = NGPSDF(cfg, k1), SHTexture(cfg, k2)
        elif cfg.encoder in ("pe", "hash"):
            self.sdf = HashSDF(cfg, k1) if cfg.encoder == "hash" else PESDF(cfg, k1)
            self.color = ColorHead(cfg, k2)
        else:
            raise ValueError(f"unknown encoder {cfg.encoder!r}")
        self.variance = nn.Parameter(init_variance().to(key.device))


def params_from_jax(tree) -> dict[str, Tensor]:
    """The JAX package's field parameters (``init_field_params``' tree, as
    numpy or JAX arrays) as a ``NeuSField`` state dict."""
    sd = {}

    def lin(prefix, p):
        sd[prefix + ".weight"] = torch.as_tensor(np.asarray(p["w"]).T.copy())
        sd[prefix + ".bias"] = torch.as_tensor(np.asarray(p["b"]).copy())

    sdf = tree["sdf"]
    if "table" in sdf:
        sd["sdf.table"] = torch.as_tensor(np.asarray(sdf["table"]).copy())
        for i, p in enumerate(sdf["mlp"]):
            lin(f"sdf.mlp.{i}", p)
    else:
        for i, p in enumerate(sdf["layers"]):
            lin(f"sdf.layers.{i}", p)
        lin("sdf.out", sdf["out"])
    for i, p in enumerate(tree["color"]["layers"]):
        lin(f"color.layers.{i}", p)
    sd["variance"] = torch.as_tensor(np.asarray(tree["variance"], np.float32).copy())
    return sd


def sdf_forward(field: NeuSField, x: Tensor) -> tuple[Tensor, Tensor]:
    return field.sdf(x)


def sdf_only(field: NeuSField, x: Tensor) -> Tensor:
    return field.sdf(x)[0]


def sdf_grad(field: NeuSField, x: Tensor) -> Tensor:
    """Spatial gradient of the SDF at points x (..., 3).

    "analytic" and "forward" (the hash encoder's "auto") are the exact
    derivative, taken by one reverse pass over the points; the graph is
    kept when gradients are enabled, since the Eikonal and normal terms
    differentiate it again.  The points carry no gradient of their own
    (no caller's points depend on the parameters).  "numerical" is the
    central difference with ``grad_eps``.
    """
    cfg = field.cfg
    mode = cfg.grad_mode
    if mode == "auto":
        mode = "forward" if cfg.encoder == "hash" else "analytic"
    if mode in ("analytic", "forward"):
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sdf_only(field, xg).sum(), xg, create_graph=keep)
        return g if keep else g.detach()
    if mode != "numerical":
        raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
    eps = cfg.grad_eps
    offsets = torch.tensor(
        [[eps, 0, 0], [-eps, 0, 0], [0, eps, 0], [0, -eps, 0], [0, 0, eps], [0, 0, -eps]],
        dtype=x.dtype, device=x.device,
    )
    s = sdf_only(field, x[..., None, :] + offsets)  # (..., 6)
    return torch.stack(
        [(s[..., 0] - s[..., 1]) / (2 * eps),
         (s[..., 2] - s[..., 3]) / (2 * eps),
         (s[..., 4] - s[..., 5]) / (2 * eps)],
        dim=-1,
    )
