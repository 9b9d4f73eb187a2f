"""Neural SDF + radiance fields of the reconstruction stage (PyTorch).

Port of ``dynhor_tpu/neus/fields.py``.  Two encoders share the colour head:

  * "pe":   frequency positional encoding + an MLP with a skip layer and
            the geometric (sphere) init of IGR/NeuS;
  * "hash": a multiresolution hash grid (instant-NGP) + a small MLP on top
            of the analytic sphere ``|x| - r``.

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

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import draws
from .draws import Key

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SDFConfig:
    encoder: str = "pe"  # "pe" | "hash"
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
    # SDF spatial-gradient mode: "auto" = "analytic" for the PE field,
    # "forward" for the hash encoder (the JAX package's choices; both are
    # the exact derivative, computed here by one reverse pass), or
    # "numerical" (central differences with grad_eps).
    grad_mode: str = "auto"  # "auto" | "analytic" | "forward" | "numerical"
    grad_eps: float = 2e-3
    # color head
    color_hidden: int = 256
    color_depth: int = 4
    dir_freqs: int = 4
    # domain
    bound: float = 1.0  # field domain [-bound, bound]^3


def clip(x: Tensor, lo: float | None = None, hi: float | None = None) -> Tensor:
    """``jnp.clip`` / ``jnp.maximum`` / ``jnp.minimum`` against a constant,
    with their gradient: at a tie the gradient is split in half
    (``torch.clamp`` would pass all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
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
    """The SDF network (PE or hash), the colour head and ``variance``,
    initialised from ``key`` as ``init_field_params`` splits its key."""

    def __init__(self, cfg: SDFConfig, key: Key | None = None):
        super().__init__()
        key = key if key is not None else Key(0)
        k1, k2 = key.split()
        self.cfg = cfg
        self.sdf = HashSDF(cfg, k1) if cfg.encoder == "hash" else PESDF(cfg, k1)
        self.color = ColorHead(cfg, k2)
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
