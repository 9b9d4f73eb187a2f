"""Floating-point operations of the ViT (a multiply-add counts as 2).

The algorithm's matrix products: the patch embedding, and per block qkv,
q kᵀ, the attention-weighted values, the projection and the two MLP
layers.  A backward into the input alone (the refine's weights are
frozen, so there is no weight gradient) costs each linear layer its
forward again, and the attention core twice its forward (dQ and dK; dA and
dV).  Recomputation is the implementation's and is not counted.
"""
from __future__ import annotations


def forward_flops(vit: dict, edge: int) -> float:
    """One crop's forward at ViT edge ``edge`` (tokens include the class
    token)."""
    d, depth = vit["embed_dim"], vit["depth"]
    g = edge // vit["patch_size"]
    n = g * g + 1
    linear = 2 * n * d * (3 * d + d + 2 * vit["mlp_ratio"] * d)
    attn = 2 * 2 * n * n * d
    embed = 2 * g * g * 3 * vit["patch_size"] ** 2 * d
    return float(embed + depth * (linear + attn))


def forward_input_backward_flops(vit: dict, edge: int) -> float:
    """One crop's forward and backward into the input."""
    d, depth = vit["embed_dim"], vit["depth"]
    g = edge // vit["patch_size"]
    n = g * g + 1
    linear = 2 * n * d * (3 * d + d + 2 * vit["mlp_ratio"] * d)
    attn = 2 * 2 * n * n * d
    embed = 2 * g * g * 3 * vit["patch_size"] ** 2 * d
    return float(embed + depth * (2 * linear + 3 * attn))
