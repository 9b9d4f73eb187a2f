"""DINOv2 ViT in PyTorch (functional, parameters as a plain dict).

Port of ``dynhor_tpu/models/dino.py``: the frozen ``dinov2_vitb14`` the
reference uses as a differentiable perceptual-loss backbone (gradients flow
THROUGH the frozen weights into the rendered image,
pose_initializtion.py:170-184).

The parameter layout is the JAX package's, so ``params_from_jax`` carries
its parameters across unchanged: blocks stacked on a leading depth axis,
kernels as (in, out) matrices applied as ``x @ W + b``, and
``patch_kernel`` (3*p*p, D) in (c, u, v) order.  ``DinoConfig.attn_impl``
selects the attention as in the JAX package: "xla" (the default) writes it
out (matmul, softmax, matmul); "flash" and "splash", two TPU kernels there,
both select ``ops/flash_attention.flash_attention`` here, one hand-written
CUDA flash attention (bf16 at head dim 64 on the card, its plain version on
the CPU).  There is no quiet switch back to "xla".  The path runs without
recomputation (the ViT has no weight gradients, and the step fits in the
card's memory).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from ..ops.flash_attention import flash_attention
from ..ops.resize import _bicubic_matrix_ac, resize_bicubic_halfpix

Tensor = torch.Tensor

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    """ViT-B/14 (dinov2_vitb14) — reference model at ObjTracker/dino.py:5."""

    patch_size: int = 14
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    pos_grid: int = 37  # native pos-embed grid (518 / 14)
    smaller_edge_size: int = 518  # reference dino.py:5
    layer_norm_eps: float = 1e-6
    # "xla": attention written out (the name is the JAX package's); "flash"
    # or "splash": ops/flash_attention.flash_attention, which picks its own
    # tiles (the TPU tile knobs flash_block, splash_block and
    # splash_fused_bwd have no counterpart).
    attn_impl: str = "xla"

    def __post_init__(self):
        if self.attn_impl not in ("xla", "flash", "splash"):
            raise ValueError(
                "attn_impl must be 'xla', 'flash' or 'splash', "
                f"got {self.attn_impl!r}"
            )

    @property
    def feat_size(self) -> int:
        return self.smaller_edge_size // self.patch_size


def init_params(
    cfg: DinoConfig = DinoConfig(),
    generator: torch.Generator | None = None,
) -> dict[str, Any]:
    """Deterministic random init (trunc-normal 0.02 within 2 std), the JAX
    package's layout, as CPU tensors drawn from ``generator``.  Placement is
    the caller's: ``refine_poses`` moves the parameters to its device."""
    d = cfg.embed_dim
    h = cfg.mlp_ratio * d
    n_pos = cfg.pos_grid * cfg.pos_grid + 1

    def tn(*shape):
        t = torch.empty(shape)
        torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04, generator=generator)
        return t

    def full(value, *shape):
        return torch.full(shape, value, dtype=torch.float32)

    params = {
        "cls_token": tn(1, 1, d),
        "pos_embed": tn(1, n_pos, d),
        "patch_kernel": tn(3 * cfg.patch_size**2, d),
        "patch_bias": full(0.0, d),
        "blocks": {
            "norm1_scale": full(1.0, cfg.depth, d),
            "norm1_bias": full(0.0, cfg.depth, d),
            "qkv_kernel": tn(cfg.depth, d, 3 * d),
            "qkv_bias": full(0.0, cfg.depth, 3 * d),
            "proj_kernel": tn(cfg.depth, d, d),
            "proj_bias": full(0.0, cfg.depth, d),
            "ls1": full(1e-5, cfg.depth, d),
            "norm2_scale": full(1.0, cfg.depth, d),
            "norm2_bias": full(0.0, cfg.depth, d),
            "fc1_kernel": tn(cfg.depth, d, h),
            "fc1_bias": full(0.0, cfg.depth, h),
            "fc2_kernel": tn(cfg.depth, h, d),
            "fc2_bias": full(0.0, cfg.depth, d),
            "ls2": full(1e-5, cfg.depth, d),
        },
        "norm_scale": full(1.0, d),
        "norm_bias": full(0.0, d),
    }
    return params


def map_params(params: dict[str, Any], fn) -> dict[str, Any]:
    """Apply ``fn`` to every leaf of a (nested) parameter dict."""
    return {
        k: map_params(v, fn) if isinstance(v, dict) else fn(v)
        for k, v in params.items()
    }


def params_from_jax(tree: dict[str, Any]) -> dict[str, Any]:
    """The JAX package's parameter pytree (leaves as numpy arrays, e.g. via
    ``jax.tree.map(np.asarray, params)``) -> this module's parameter dict of
    CPU tensors.  The layout is the same, so this only copies the arrays."""
    return map_params(tree, lambda a: torch.as_tensor(np.array(a, np.float32)))


def _layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    # Statistics in f32 (bf16 mean/variance loses too much), output in the
    # compute dtype.
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * scale + bias


def _attention(q: Tensor, k: Tensor, v: Tensor, hd: int) -> Tensor:
    """Multi-head attention, (B, H, N, hd) -> (B, H, N, hd), written out.

    As in the JAX package: the exp output is cast to the compute dtype
    BEFORE normalization and the 1/sum is folded in AFTER the
    probabilities @ V product, so every N x N buffer beyond the f32 scores
    is in the compute dtype.
    """
    dtype = q.dtype
    s = torch.matmul(q, k.transpose(-1, -2)) * torch.tensor(1.0 / math.sqrt(hd), dtype=dtype)
    s32 = s.float()
    m = s32.amax(-1, keepdim=True).detach()
    p32 = torch.exp(s32 - m)
    denom = p32.sum(-1, keepdim=True)  # (B, H, N, 1) f32
    o = torch.matmul(p32.to(dtype), v)
    return o * (1.0 / denom).to(dtype)


def _block(
    x: Tensor, p: dict[str, Tensor], num_heads: int, eps: float, attn_impl: str = "xla"
) -> Tensor:
    b, n, d = x.shape
    hd = d // num_heads
    h = _layer_norm(x, p["norm1_scale"], p["norm1_bias"], eps)
    qkv = h @ p["qkv_kernel"] + p["qkv_bias"]  # (B, N, 3D)
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    if attn_impl == "xla":
        o = _attention(q, k, v, hd)
    else:  # q, k, v go in as the strided views they are
        o = flash_attention(q, k, v, 1.0 / math.sqrt(hd))
    o = o.transpose(1, 2).reshape(b, n, d)
    o = o @ p["proj_kernel"] + p["proj_bias"]
    x = x + p["ls1"] * o
    h = _layer_norm(x, p["norm2_scale"], p["norm2_bias"], eps)
    h = torch.nn.functional.gelu(h @ p["fc1_kernel"] + p["fc1_bias"], approximate="none")
    h = h @ p["fc2_kernel"] + p["fc2_bias"]
    return x + p["ls2"] * h


def _interp_pos_embed(pos_embed: Tensor, grid0: int, gh: int, gw: int) -> Tensor:
    """Bicubic pos-embed interpolation (dinov2 interpolate_pos_encoding)."""
    if gh == grid0 and gw == grid0:
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].reshape(grid0, grid0, d).permute(2, 0, 1)  # (D, g, g)
    grid = resize_bicubic_halfpix(grid, gh, gw)
    out = grid.permute(1, 2, 0).reshape(1, gh * gw, d)
    return torch.cat([pos_embed[:, :1], out.to(pos_embed.dtype)], dim=1)


def _trunk(params: dict[str, Any], x: Tensor, cfg: DinoConfig, gh: int, gw: int) -> Tensor:
    """cls + pos-embed + blocks + final LN on patch-embedded tokens
    x (B, gh*gw, D); returns the patch tokens."""
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    pos = _interp_pos_embed(params["pos_embed"].float(), cfg.pos_grid, gh, gw)
    x = x + pos.to(x.dtype)
    blocks = params["blocks"]
    for i in range(cfg.depth):
        x = _block(
            x, {k: v[i] for k, v in blocks.items()}, cfg.num_heads, cfg.layer_norm_eps,
            cfg.attn_impl,
        )
    x = _layer_norm(x, params["norm_scale"], params["norm_bias"], cfg.layer_norm_eps)
    return x[:, 1:]


def forward_tokens(params: dict[str, Any], images: Tensor, cfg: DinoConfig = DinoConfig()) -> Tensor:
    """ViT forward; final-layernormed PATCH tokens (B, N, D) of
    ImageNet-normalized images (B, 3, H, W), H and W divisible by the patch
    (dinov2 ``get_intermediate_layers(x)[0]``, norm=True)."""
    p = cfg.patch_size
    b, c, hh, ww = images.shape
    gh, gw = hh // p, ww // p
    x = images.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, c * p * p).to(params["patch_kernel"].dtype)
    x = x @ params["patch_kernel"] + params["patch_bias"]
    return _trunk(params, x, cfg, gh, gw)


@functools.lru_cache(maxsize=16)
def _fused_resize_factor(small: int, edge: int, patch: int, device: str) -> Tensor:
    """(g, patch, small) bicubic align-corners resampling matrix, grouped
    by patch row: row (a, u) is resized pixel a*patch+u over the `small`
    source pixels."""
    w = _bicubic_matrix_ac(small, edge).reshape(edge // patch, patch, small)
    # A normal tensor even when first asked for under inference mode (the
    # prior scoring), since the refine's backward saves it later.
    with torch.inference_mode(False):
        return torch.as_tensor(w, device=device)


def fused_patch_tokens(
    params: dict[str, Any], rgb_small: Tensor, cfg: DinoConfig = DinoConfig()
) -> Tensor:
    """Patch-embed tokens straight from a small crop: the exact linear
    composition of (bicubic align-corners resize to ``smaller_edge_size``)
    o (ImageNet normalization) o (patchify + embed matmul), as three small
    contractions; the resized image never exists.

    Resampling runs in f32; the embedding matmul in the params' dtype.

    Args:
      rgb_small: (B, 3, s, s) in [0, 1] — NOT ImageNet-normalized.

    Returns: (B, g*g, D) tokens, g = smaller_edge_size // patch_size.
    """
    p = cfg.patch_size
    edge = cfg.smaller_edge_size
    if edge % p:
        raise ValueError(f"smaller_edge_size {edge} not divisible by patch {p}")
    g = edge // p
    b, c, s, _ = rgb_small.shape
    W = _fused_resize_factor(s, edge, p, str(rgb_small.device))  # (g, p, s)
    kernel = params["patch_kernel"]  # (3*p*p, D)
    dtype = kernel.dtype
    d = kernel.shape[-1]
    k32 = kernel.float().reshape(c, p, p, d)
    inv_std = torch.as_tensor(1.0 / IMAGENET_STD, device=kernel.device)
    kn = (k32 * inv_std[:, None, None, None]).to(dtype)  # (c, p, p, D)
    # Constant inputs resize to themselves (clamped-tap rows sum to 1), so
    # the mean-subtraction folds into one bias correction.
    mean_over_std = torch.as_tensor(IMAGENET_MEAN / IMAGENET_STD, device=kernel.device)
    bias = params["patch_bias"].float() - torch.einsum("cuvd,c->d", k32, mean_over_std)
    x = rgb_small.float()
    y = torch.einsum("aup,bcpq->bcuaq", W, x)  # rows resampled
    z = torch.einsum("bcuaq,nvq->bcuanv", y, W)  # cols resampled
    t = torch.einsum("bcuanv,cuvd->band", z.to(dtype), kn)
    return (t + bias.to(dtype)).reshape(b, g * g, d)


def forward_tokens_from_crop(
    params: dict[str, Any], rgb_small: Tensor, cfg: DinoConfig = DinoConfig()
) -> Tensor:
    """ViT tokens from an un-normalized SMALL crop (B, 3, s, s) in [0, 1]:
    fused resize+normalize+patch-embed, then the shared trunk.  Equals
    ``forward_tokens(params, normalize(resize(rgb, edge)), cfg)``."""
    g = cfg.feat_size
    return _trunk(params, fused_patch_tokens(params, rgb_small, cfg), cfg, g, g)


def extract_features(
    params: dict[str, Any], images01: Tensor, cfg: DinoConfig = DinoConfig()
) -> Tensor:
    """ImageNet-normalize images (B, 3, H, W) in [0, 1], then run the ViT
    (reference dino.py:19-22).  Differentiable in the images."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images01.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=images01.device).reshape(1, 3, 1, 1)
    return forward_tokens(params, (images01 - mean) / std, cfg)
