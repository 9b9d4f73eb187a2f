"""Flash attention: softmax(Q K^T * scale) V without the N x N tensors.

Port of ``dynhor_tpu/models/dino.py``'s ``_flash_attention`` and
``_splash_attention``.  The two TPU kernels compute the same function on the
valid tokens and differ in tiling and padding only, so ``flash_attention``
is the counterpart of both.  Nothing is padded: the true token count goes to
the kernels, which mask the ragged edge themselves.

For CUDA tensors the forward and the backward are hand-written kernels at
head dim 64: bf16 goes to ``csrc/flash_attention.cu`` (TMA and ``wgmma``),
f32 to ``csrc/flash_attention_f32.cu`` (f32 FMAs on the CUDA cores, as the
ViT computes with ``dino_dtype="float32"``); any other dtype or head dim
raises ``ValueError``, with no cast and no plain version on the card.
For CPU tensors they are the plain versions below, which repeat the
kernels' arithmetic block by block: scores and exp in the accumulation type
(f32; f64 for f64 inputs), the probabilities rounded to the input type
before the P V product, division by the row sum at the end, and a backward
that is written out (not left to autograd) from the saved row log-sum-exp.

Layout: (B, H, N, hd) at this module's functions, any strides as long as hd
is contiguous.  The kernels write ``o`` as (B, N, H, hd) in memory, so the
caller's ``o.transpose(1, 2).reshape(B, N, H * hd)`` is a view, and read
q, k, v through their strides, so the views of one (B, N, 3, H, hd)
projection need no copy.
"""
from __future__ import annotations

import torch

from .. import kernels

Tensor = torch.Tensor

PLAIN_BLOCK = 128  # keys per step of the plain versions (the kernels' key tile)


def _acc_dtype(x: Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def flash_fwd_plain(
    q: Tensor, k: Tensor, v: Tensor, sm_scale: float, block: int = PLAIN_BLOCK
) -> tuple[Tensor, Tensor]:
    """Blockwise online-softmax forward.  Returns (o (B, H, N, hd) in the
    input type, lse (B, H, N) row log-sum-exp of the scaled scores)."""
    dtype, acc_t = q.dtype, _acc_dtype(q)
    b, h, n, d = q.shape
    qa = q.to(acc_t)
    m = torch.full((b, h, n), float("-inf"), dtype=acc_t, device=q.device)
    l = torch.zeros((b, h, n), dtype=acc_t, device=q.device)
    acc = torch.zeros((b, h, n, d), dtype=acc_t, device=q.device)
    for s in range(0, n, block):
        kb, vb = k[:, :, s : s + block].to(acc_t), v[:, :, s : s + block].to(acc_t)
        sc = torch.matmul(qa, kb.transpose(-1, -2)) * sm_scale
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)  # 0 at the first block
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(dtype).to(acc_t), vb)
        m = m_new
    return (acc / l[..., None]).to(dtype), m + torch.log(l)


def flash_delta_plain(o: Tensor, d_o: Tensor) -> Tensor:
    """delta = rowsum(dO * O), (B, H, N) in the accumulation type."""
    acc_t = _acc_dtype(o)
    return (d_o.to(acc_t) * o.to(acc_t)).sum(-1)


def flash_bwd_plain(
    q: Tensor, k: Tensor, v: Tensor, d_o: Tensor, lse: Tensor, delta: Tensor,
    sm_scale: float, block: int = PLAIN_BLOCK,
) -> tuple[Tensor, Tensor, Tensor]:
    """The flash backward, written out: per key block, P recomputed from the
    saved log-sum-exp; dV = P^T dO; dP = dO V^T; dS = P * (dP - delta);
    dQ += dS K * scale; dK = dS^T Q * scale.  P and dS are rounded to the
    input type for their products.  Returns (dq, dk, dv) in the input type."""
    dtype, acc_t = q.dtype, _acc_dtype(q)
    n = q.shape[2]
    qa, ga = q.to(acc_t), d_o.to(acc_t)
    dq = torch.zeros_like(qa)
    dk, dv = [], []
    for s in range(0, n, block):
        kb, vb = k[:, :, s : s + block].to(acc_t), v[:, :, s : s + block].to(acc_t)
        sc = torch.matmul(qa, kb.transpose(-1, -2)) * sm_scale
        p = torch.exp(sc - lse[..., None])
        dv.append(torch.matmul(p.to(dtype).to(acc_t).transpose(-1, -2), ga))
        dp = torch.matmul(ga, vb.transpose(-1, -2))
        ds = (p * (dp - delta[..., None])).to(dtype).to(acc_t)
        dq = dq + torch.matmul(ds, kb)
        dk.append(torch.matmul(ds.transpose(-1, -2), qa) * sm_scale)
    return (dq * sm_scale).to(dtype), torch.cat(dk, dim=2).to(dtype), torch.cat(dv, dim=2).to(dtype)


# --------------------------------------------------------------------------
# Dispatch: plain version for CPU tensors, the kernel for CUDA tensors.
# --------------------------------------------------------------------------


def flash_fwd(q, k, v, sm_scale):
    """K5 forward: ``flash_fwd_plain`` on the CPU, the CUDA kernel otherwise."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale)
    return kernels.flash_fwd(q, k, v, sm_scale)


def flash_bwd(q, k, v, o, lse, d_o, sm_scale):
    """K5 backward: the plain versions on the CPU, the three CUDA kernels
    (delta, dK/dV, dQ) otherwise.  Returns (dq, dk, dv)."""
    if q.device.type == "cpu":
        delta = flash_delta_plain(o, d_o)
        return flash_bwd_plain(q, k, v, d_o, lse, delta, sm_scale)
    try:
        kernels.tma_layout(d_o, "d_o")
    except ValueError:
        # A cotangent that autograd expanded or sliced (a broadcast sum's,
        # say), which the kernels' tensor maps cannot read: it is copied.
        d_o = d_o.contiguous()
    delta = kernels.flash_bwd_delta(o, d_o)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, d_o, lse, delta, sm_scale)
    dq = kernels.flash_bwd_dq(q, k, v, d_o, lse, delta, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Saves q, k, v, o and the row log-sum-exp, nothing of size N x N; under
    ``torch.inference_mode`` or ``torch.no_grad`` it saves nothing."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, lse = flash_fwd(q, k, v, sm_scale)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, d_o, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, sm_scale: float) -> Tensor:
    """Multi-head attention, (B, H, N, hd) -> (B, H, N, hd), differentiable
    in q, k and v.  On CUDA tensors it launches the kernels, bf16 or f32 at
    hd 64, or raises (f16, f64, another hd); on CPU tensors it runs the
    plain versions at any float type."""
    return _FlashAttention.apply(q, k, v, float(sm_scale))
