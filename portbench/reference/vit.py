"""Plain DINOv2 ViT (dinov2_vitb14's block), in float32.

Pre-norm blocks with LayerScale: ``x + ls1 * proj(attn(LN(x)))`` then
``x + ls2 * fc2(gelu(fc1(LN(x))))``, 12 heads of softmax(q kᵀ / 8) v, a final
LayerNorm, the patch tokens out.  A crop in [0, 1] is resized bicubically
(corners aligned) to the ViT's edge, ImageNet-normalized and cut into
14-pixel patches in (channel, row, column) order; at an edge other than
518 the 37 x 37 position grid is resized bicubically (half-pixel centres).

The parameters are the layout the benchmark draws (``scene.vit_weights``):
blocks stacked on a leading depth axis, kernels (in, out).  ``quant``, when
given, rounds both operands of every matrix product and the residual stream
after every addition (the control: the ViT computed in a lower precision).  Plain PyTorch only; this file imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _mm(a: Tensor, b: Tensor, quant) -> Tensor:
    if quant is not None:
        a, b = quant(a), quant(b)
    return a @ b


def _q(x: Tensor, quant) -> Tensor:
    return x if quant is None else quant(x)


def fp8_e4m3(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in f32;
    the gradient passes straight through."""
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-30) / 448.0
    q = (xd / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - xd)


def patch_tokens(params: dict, rgb: Tensor, edge: int, patch: int = 14, quant=None) -> Tensor:
    """(B, 3, s, s) crops in [0, 1] -> (B, g*g, D) embedded patches."""
    x = F.interpolate(rgb.float(), size=(edge, edge), mode="bicubic", align_corners=True)
    mean = torch.tensor(MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    b, c = x.shape[:2]
    g = edge // patch
    x = x.reshape(b, c, g, patch, g, patch).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, -1)
    return _mm(x, params["patch_kernel"].float(), quant) + params["patch_bias"].float()


def _ln(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    return F.layer_norm(x, x.shape[-1:], scale.float(), bias.float(), eps)


def trunk(params: dict, x: Tensor, heads: int, grid0: int = 37, eps: float = 1e-6,
          quant=None) -> Tensor:
    """cls + position + blocks + final norm on (B, g*g, D) patch tokens;
    returns the patch tokens."""
    b, n, d = x.shape
    g = int(round(math.sqrt(n)))
    pos = params["pos_embed"].float()
    if g != grid0:
        grid = pos[0, 1:].reshape(grid0, grid0, d).permute(2, 0, 1)[None]
        grid = F.interpolate(grid, size=(g, g), mode="bicubic", align_corners=False)
        pos = torch.cat([pos[:, :1], grid[0].permute(1, 2, 0).reshape(1, g * g, d)], 1)
    x = _q(torch.cat([params["cls_token"].float().expand(b, 1, d), x], 1) + pos, quant)
    blk = params["blocks"]
    hd = d // heads
    for i in range(blk["qkv_kernel"].shape[0]):
        p = {k: v[i].float() for k, v in blk.items()}
        h = _ln(x, p["norm1_scale"], p["norm1_bias"], eps)
        qkv = _mm(h, p["qkv_kernel"], quant) + p["qkv_bias"]
        q, k, v = qkv.reshape(b, n + 1, 3, heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(_mm(q, k.transpose(-1, -2), quant) / math.sqrt(hd), dim=-1)
        o = _mm(att, v, quant).transpose(1, 2).reshape(b, n + 1, d)
        x = _q(x + p["ls1"] * (_mm(o, p["proj_kernel"], quant) + p["proj_bias"]), quant)
        h = _ln(x, p["norm2_scale"], p["norm2_bias"], eps)
        h = F.gelu(_mm(h, p["fc1_kernel"], quant) + p["fc1_bias"])
        x = _q(x + p["ls2"] * (_mm(h, p["fc2_kernel"], quant) + p["fc2_bias"]), quant)
    x = _ln(x, params["norm_scale"], params["norm_bias"], eps)
    return x[:, 1:]


def tokens_from_crop(params: dict, rgb: Tensor, vit: dict, edge: int, quant=None) -> Tensor:
    """Patch tokens of crops at ViT edge ``edge``; ``vit`` the
    configuration's widths."""
    p = vit["patch_size"]
    x = patch_tokens(params, rgb, edge, p, quant)
    return trunk(params, x, vit["num_heads"], vit["smaller_edge_size"] // p, quant=quant)


def normalized_tokens(params: dict, rgb: Tensor, vit: dict, edge: int, quant=None) -> Tensor:
    """L2-normalized patch tokens (B, P, D): the features that scores and
    the semantic loss compare."""
    t = tokens_from_crop(params, rgb, vit, edge, quant)
    return t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp_min(1e-6)
