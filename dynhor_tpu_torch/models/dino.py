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
the CPU).  There is no quiet switch back to "xla".  ``remat`` (the refine's
``RefineConfig.dino_remat``) is the JAX package's recomputation policy for
the backward, keeping what it keeps (``_trunk``): "frozen" keeps each
block's input, ``qkv``, mid residual and fc1 output; "dots" every matmul
output; True only the block inputs; False everything.  ``load_params``
reads a torch state_dict (.pth, or .npz of the same keys) through
``convert_torch_state_dict``, or draws random weights from a seed.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

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


# The torch.hub DINOv2 family (the reference hard-codes 'dinov2_vitb14',
# ObjTracker/dino.py:5; s/b/l share the block structure, all at head dim
# 64).  vitg14's SwiGLU FFN is not supported.
MODEL_PRESETS: dict[str, dict[str, int]] = {
    "dinov2_vits14": {"embed_dim": 384, "depth": 12, "num_heads": 6},
    "dinov2_vitb14": {"embed_dim": 768, "depth": 12, "num_heads": 12},
    "dinov2_vitl14": {"embed_dim": 1024, "depth": 24, "num_heads": 16},
}


def config_for_model(name: str, **overrides) -> DinoConfig:
    """DinoConfig for a torch.hub DINOv2 model name (see MODEL_PRESETS)."""
    if name not in MODEL_PRESETS:
        raise ValueError(
            f"unknown DINOv2 model {name!r}; supported: {sorted(MODEL_PRESETS)} "
            "(vitg14's SwiGLU FFN is not implemented)"
        )
    return dataclasses.replace(DinoConfig(), **MODEL_PRESETS[name], **overrides)


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


def _attention_core(qkv: Tensor, num_heads: int, attn_impl: str) -> Tensor:
    """(B, N, 3D) qkv -> (B, N, D) attention output, before the projection."""
    b, n, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    if attn_impl == "xla":
        o = _attention(q, k, v, hd)
    else:  # q, k, v go in as the strided views they are
        o = flash_attention(q, k, v, 1.0 / math.sqrt(hd))
    return o.transpose(1, 2).reshape(b, n, d)


def _call(fn, *args):
    return fn(*args)


def _recomputed(fn, *args):
    """fn(*args), keeping only its tensor arguments for the backward, which
    runs fn again (the ViT draws no random numbers, so no RNG state)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False
    )


def _block(
    x: Tensor, p: dict[str, Tensor], num_heads: int, eps: float, attn_impl: str = "xla",
    frozen: bool = False,
) -> Tensor:
    """One pre-norm block.  With ``frozen`` (the JAX package's "frozen"
    policy) the layer norms and the attention core run as recomputed
    segments, so the backward keeps exactly the block input, ``qkv``, the
    mid residual and the fc1 output: a matmul by a weight that needs no
    gradient keeps only the weight, and the GELU keeps its input, the fc1
    output."""
    seg = _recomputed if frozen else _call
    h = seg(_layer_norm, x, p["norm1_scale"], p["norm1_bias"], eps)
    qkv = h @ p["qkv_kernel"] + p["qkv_bias"]  # (B, N, 3D)
    o = seg(_attention_core, qkv, num_heads, attn_impl)
    o = o @ p["proj_kernel"] + p["proj_bias"]
    x = x + p["ls1"] * o
    h = seg(_layer_norm, x, p["norm2_scale"], p["norm2_bias"], eps)
    h = torch.nn.functional.gelu(h @ p["fc1_kernel"] + p["fc1_bias"], approximate="none")
    h = h @ p["fc2_kernel"] + p["fc2_bias"]
    return x + p["ls2"] * h


# The ops whose outputs "dots" keeps: every matmul (a 3-D @ 2-D matmul runs
# as mm, a batched one as bmm).  The hand-written attention (ctypes, outside
# the dispatcher) is no matmul here, as the Pallas call is no dot_general in
# the JAX package: it runs again in the backward.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    CP = torch.utils.checkpoint.CheckpointPolicy
    return CP.MUST_SAVE if op in _DOTS else CP.PREFER_RECOMPUTE


def _dots_context():
    return torch.utils.checkpoint.create_selective_checkpoint_contexts(_dots_policy)


def _interp_pos_embed(pos_embed: Tensor, grid0: int, gh: int, gw: int) -> Tensor:
    """Bicubic pos-embed interpolation (dinov2 interpolate_pos_encoding)."""
    if gh == grid0 and gw == grid0:
        return pos_embed
    d = pos_embed.shape[-1]
    grid = pos_embed[0, 1:].reshape(grid0, grid0, d).permute(2, 0, 1)  # (D, g, g)
    grid = resize_bicubic_halfpix(grid, gh, gw)
    out = grid.permute(1, 2, 0).reshape(1, gh * gw, d)
    return torch.cat([pos_embed[:, :1], out.to(pos_embed.dtype)], dim=1)


def _trunk(
    params: dict[str, Any], x: Tensor, cfg: DinoConfig, gh: int, gw: int,
    remat: bool | str = False,
) -> Tensor:
    """cls + pos-embed + blocks + final LN on patch-embedded tokens
    x (B, gh*gw, D); returns the patch tokens.

    ``remat`` is the JAX package's policy for what the backward keeps of
    each block (``dynhor_tpu/models/dino.py:_trunk``); the numbers are the
    same under every policy:
      False     every activation;
      "frozen"  the block input, ``qkv``, the mid residual and the fc1
                output, 9·D values a token, nothing of size N²; the backward
                recomputes the layer norms and the attention core (QKᵀ and
                the softmax, or the flash forward), as the JAX policy's named
                saves do with weights that take no gradient;
      "dots"    the block input and every matmul output (selective
                checkpointing: the scores but not the softmax); the rest,
                the flash kernel included, runs again in the backward;
      True      the block inputs only; the backward runs each block again.
    What "frozen" keeps holds for weights that take no gradient (the
    refine's); weights that do take one also keep the inputs of their
    matmuls, and their gradients are right under every policy.
    """
    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim).to(x.dtype)
    x = torch.cat([cls, x], dim=1)
    pos = _interp_pos_embed(params["pos_embed"].float(), cfg.pos_grid, gh, gw)
    x = x + pos.to(x.dtype)
    blocks = params["blocks"]
    policy = remat if torch.is_grad_enabled() else False
    for i in range(cfg.depth):
        args = (x, {k: v[i] for k, v in blocks.items()}, cfg.num_heads,
                cfg.layer_norm_eps, cfg.attn_impl)
        if policy == "frozen":
            x = _block(*args, frozen=True)
        elif policy == "dots":
            x = torch.utils.checkpoint.checkpoint(
                _block, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=_dots_context,
            )
        elif policy:
            x = _recomputed(_block, *args)
        else:
            x = _block(*args)
    x = _layer_norm(x, params["norm_scale"], params["norm_bias"], cfg.layer_norm_eps)
    return x[:, 1:]


def forward_tokens(
    params: dict[str, Any], images: Tensor, cfg: DinoConfig = DinoConfig(),
    remat: bool | str = False,
) -> Tensor:
    """ViT forward; final-layernormed PATCH tokens (B, N, D) of
    ImageNet-normalized images (B, 3, H, W), H and W divisible by the patch
    (dinov2 ``get_intermediate_layers(x)[0]``, norm=True)."""
    p = cfg.patch_size
    b, c, hh, ww = images.shape
    gh, gw = hh // p, ww // p
    x = images.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, c * p * p).to(params["patch_kernel"].dtype)
    x = x @ params["patch_kernel"] + params["patch_bias"]
    return _trunk(params, x, cfg, gh, gw, remat)


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
    params: dict[str, Any], rgb_small: Tensor, cfg: DinoConfig = DinoConfig(),
    remat: bool | str = False,
) -> Tensor:
    """ViT tokens from an un-normalized SMALL crop (B, 3, s, s) in [0, 1]:
    fused resize+normalize+patch-embed, then the shared trunk.  Equals
    ``forward_tokens(params, normalize(resize(rgb, edge)), cfg, remat)``."""
    g = cfg.feat_size
    return _trunk(params, fused_patch_tokens(params, rgb_small, cfg), cfg, g, g, remat)


def extract_features(
    params: dict[str, Any], images01: Tensor, cfg: DinoConfig = DinoConfig()
) -> Tensor:
    """ImageNet-normalize images (B, 3, H, W) in [0, 1], then run the ViT
    (reference dino.py:19-22).  Differentiable in the images."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images01.device).reshape(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=images01.device).reshape(1, 3, 1, 1)
    return forward_tokens(params, (images01 - mean) / std, cfg)


# --------------------------------------------------------------------------
# Torch checkpoint conversion
# --------------------------------------------------------------------------

def convert_torch_state_dict(sd: dict[str, Any], cfg: DinoConfig = DinoConfig()):
    """A torch DINOv2 state_dict -> (this module's parameter dict, cfg).

    Accepts the official facebookresearch/dinov2 naming
    (``blocks.N.attn.qkv.weight`` ...) or the HuggingFace transformers
    naming (``encoder.layer.N.attention.attention.query.weight`` ...);
    values may be tensors or numpy arrays.  The architecture (embed_dim,
    depth, num_heads = embed_dim / 64) and the position grid are read from
    the weights; ``cfg`` supplies the rest (smaller_edge_size, eps).
    """

    def a(t):
        if isinstance(t, Tensor):
            t = t.detach().cpu().numpy()
        return np.asarray(t, np.float32)

    def has(k):
        return k in sd

    official = has("blocks.0.attn.qkv.weight") or has("patch_embed.proj.weight")
    cls_key = "cls_token" if official else "embeddings.cls_token"
    d = int(np.shape(sd[cls_key])[-1])
    blk_fmt = "blocks.{}.norm1.weight" if official else "encoder.layer.{}.norm1.weight"
    depth = 0
    while has(blk_fmt.format(depth)):
        depth += 1
    if (d, depth) != (cfg.embed_dim, cfg.depth):
        # num_heads is not stored in the weights; the supported family
        # runs head dim 64.
        if d % 64 != 0 or depth == 0:
            raise ValueError(
                f"unsupported DINOv2 checkpoint: embed_dim={d}, depth={depth} "
                "(expected head-dim-64 family; vitg14/SwiGLU is not supported)"
            )
        cfg = dataclasses.replace(cfg, embed_dim=d, depth=depth, num_heads=d // 64)

    def stack(fn):
        return np.stack([fn(i) for i in range(cfg.depth)])

    if official:
        patch_w = a(sd["patch_embed.proj.weight"])  # (D, 3, p, p)
        patch_kernel = patch_w.reshape(d, -1).T  # (3*p*p, D)
        patch_bias = a(sd["patch_embed.proj.bias"])
        cls_token = a(sd["cls_token"])
        pos_embed = a(sd["pos_embed"])

        def g(i, name, transpose=False):
            x = a(sd[f"blocks.{i}.{name}"])
            return x.T if transpose else x

        blocks = {
            "norm1_scale": stack(lambda i: g(i, "norm1.weight")),
            "norm1_bias": stack(lambda i: g(i, "norm1.bias")),
            "qkv_kernel": stack(lambda i: g(i, "attn.qkv.weight", True)),
            "qkv_bias": stack(lambda i: g(i, "attn.qkv.bias")),
            "proj_kernel": stack(lambda i: g(i, "attn.proj.weight", True)),
            "proj_bias": stack(lambda i: g(i, "attn.proj.bias")),
            "ls1": stack(lambda i: g(i, "ls1.gamma")),
            "norm2_scale": stack(lambda i: g(i, "norm2.weight")),
            "norm2_bias": stack(lambda i: g(i, "norm2.bias")),
            "fc1_kernel": stack(lambda i: g(i, "mlp.fc1.weight", True)),
            "fc1_bias": stack(lambda i: g(i, "mlp.fc1.bias")),
            "fc2_kernel": stack(lambda i: g(i, "mlp.fc2.weight", True)),
            "fc2_bias": stack(lambda i: g(i, "mlp.fc2.bias")),
            "ls2": stack(lambda i: g(i, "ls2.gamma")),
        }
        norm_scale = a(sd["norm.weight"])
        norm_bias = a(sd["norm.bias"])
    else:  # transformers naming
        patch_w = a(sd["embeddings.patch_embeddings.projection.weight"])
        patch_kernel = patch_w.reshape(d, -1).T
        patch_bias = a(sd["embeddings.patch_embeddings.projection.bias"])
        cls_token = a(sd["embeddings.cls_token"])
        pos_embed = a(sd["embeddings.position_embeddings"])

        def g(i, name):
            return a(sd[f"encoder.layer.{i}.{name}"])

        def qkv(i, part):
            return [g(i, f"attention.attention.{n}.{part}") for n in ("query", "key", "value")]

        blocks = {
            "norm1_scale": stack(lambda i: g(i, "norm1.weight")),
            "norm1_bias": stack(lambda i: g(i, "norm1.bias")),
            "qkv_kernel": stack(lambda i: np.concatenate([w.T for w in qkv(i, "weight")], axis=1)),
            "qkv_bias": stack(lambda i: np.concatenate(qkv(i, "bias"))),
            "proj_kernel": stack(lambda i: g(i, "attention.output.dense.weight").T),
            "proj_bias": stack(lambda i: g(i, "attention.output.dense.bias")),
            "ls1": stack(lambda i: g(i, "layer_scale1.lambda1")),
            "norm2_scale": stack(lambda i: g(i, "norm2.weight")),
            "norm2_bias": stack(lambda i: g(i, "norm2.bias")),
            "fc1_kernel": stack(lambda i: g(i, "mlp.fc1.weight").T),
            "fc1_bias": stack(lambda i: g(i, "mlp.fc1.bias")),
            "fc2_kernel": stack(lambda i: g(i, "mlp.fc2.weight").T),
            "fc2_bias": stack(lambda i: g(i, "mlp.fc2.bias")),
            "ls2": stack(lambda i: g(i, "layer_scale2.lambda1")),
        }
        norm_scale = a(sd["layernorm.weight"])
        norm_bias = a(sd["layernorm.bias"])

    grid = int(round(float(np.sqrt(pos_embed.shape[1] - 1))))
    params = {
        "cls_token": cls_token,
        "pos_embed": pos_embed,
        "patch_kernel": patch_kernel,
        "patch_bias": patch_bias,
        "blocks": blocks,
        "norm_scale": norm_scale,
        "norm_bias": norm_bias,
    }
    params = map_params(params, lambda x: torch.from_numpy(np.ascontiguousarray(x)))
    return params, dataclasses.replace(cfg, pos_grid=grid)


def load_params(checkpoint_path: str | None, cfg: DinoConfig = DinoConfig(), seed: int = 0):
    """Converted torch weights from ``checkpoint_path`` (a torch-saved
    state_dict ``.pth``, or a numpy ``.npz`` of the same keys); with no path,
    ``init_params`` drawn from ``torch.Generator().manual_seed(seed)`` (a
    draw that differs from the JAX package's).  Returns (params as CPU
    tensors, cfg)."""
    if checkpoint_path:
        import os

        if not os.path.exists(checkpoint_path):
            raise FileNotFoundError(checkpoint_path)
        if checkpoint_path.endswith(".npz"):
            sd = dict(np.load(checkpoint_path))
        else:
            sd = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
        return convert_torch_state_dict(sd, cfg)
    return init_params(cfg, torch.Generator().manual_seed(seed)), cfg
