"""The port's flash attention (plain versions, CPU, f32) vs the JAX package.

``ops/flash_attention.flash_attention`` is the counterpart of both
``dino._flash_attention`` and ``dino._splash_attention``.  The same numpy
inputs go through both sides; the JAX side runs as the JAX package's own
tests run it on the CPU: ``_attention`` as it is, ``_flash_attention`` with
the Pallas call replaced by the module's own jnp reference, and
``_splash_attention`` in Pallas interpret mode.  Layouts: JAX (B, N, H, hd),
port (B, H, N, hd).  Tolerances: 1e-5 on outputs and gradients (f32 sums in
another order), 2e-5 against the splash kernel (as tests/test_dino.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.ops import flash_attention as FA


def _inputs(b, n, h, hd, seed=0):
    """q, k, v and a cotangent, (B, N, H, hd) f32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, hd)).astype(np.float32) for _ in range(4)]


def _port(q, k, v, ct, hd):
    """Output and (dq, dk, dv) of the port, back in the JAX layout.  q, k, v
    go in as the strided views models/dino._block makes of one buffer."""
    b, n, h, _ = q.shape
    qkv = torch.tensor(np.stack([q, k, v], axis=2), requires_grad=True)  # (B, N, 3, H, hd)
    qt, kt, vt = qkv.permute(2, 0, 3, 1, 4)
    assert not qt.is_contiguous()
    o = FA.flash_attention(qt, kt, vt, 1.0 / math.sqrt(hd))
    o.backward(torch.tensor(ct).permute(0, 2, 1, 3))
    grads = qkv.grad.numpy()
    return o.detach().permute(0, 2, 1, 3).numpy(), [grads[:, :, i] for i in range(3)]


def _jax(fn, q, k, v, ct):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(ct))]


@pytest.mark.parametrize("shape", [(2, 45, 3, 16), (1, 70, 2, 64)])
def test_plain_matches_jax_attention(shape):
    b, n, h, hd = shape
    q, k, v, ct = _inputs(*shape)
    o_j, g_j = _jax(lambda q, k, v: JD._attention(q, k, v, hd), q, k, v, ct)
    o_t, g_t = _port(q, k, v, ct, hd)
    np.testing.assert_allclose(o_t, o_j, atol=1e-5)
    for name, a, e in zip("qkv", g_t, g_j):
        np.testing.assert_allclose(a, e, atol=1e-5, err_msg=f"d{name}")


def test_plain_matches_jax_flash_wrapper(monkeypatch):
    """Against ``_flash_attention`` with its padding to the block and its
    segment ids, the Pallas call replaced by the module's own reference as
    in tests/test_dino.py; ``mha_reference_no_custom_vjp`` is that reference
    left to JAX's autodiff (the custom VJP of ``mha_reference`` refuses a
    scale other than 1)."""
    import jax.experimental.pallas.ops.tpu.flash_attention as fa

    def fake_flash(q, k, v, ab=None, segment_ids=None, *, causal=False,
                   sm_scale=1.0, block_sizes=None):
        return fa.mha_reference_no_custom_vjp(
            q, k, v, ab, segment_ids=segment_ids, causal=causal, sm_scale=sm_scale
        )

    monkeypatch.setattr(fa, "flash_attention", fake_flash)
    shape = (2, 45, 3, 16)  # n not a multiple of the block
    q, k, v, ct = _inputs(*shape, seed=1)
    o_j, g_j = _jax(lambda q, k, v: JD._flash_attention(q, k, v, 16, block=16), q, k, v, ct)
    o_t, g_t = _port(q, k, v, ct, 16)
    np.testing.assert_allclose(o_t, o_j, atol=1e-5)
    for name, a, e in zip("qkv", g_t, g_j):
        np.testing.assert_allclose(a, e, atol=1e-5, err_msg=f"d{name}")


def test_plain_matches_jax_splash_kernel(monkeypatch):
    """Against ``_splash_attention`` with the real splash kernel in Pallas
    interpret mode (n = 45 padded to its smallest legal block, 128)."""
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as splash,
    )

    real = splash.make_splash_mha

    def interp_mha(mask, **kw):
        kw["interpret"] = True
        return real(mask, **kw)

    monkeypatch.setattr(splash, "make_splash_mha", interp_mha)
    shape = (1, 45, 2, 16)
    q, k, v, ct = _inputs(*shape, seed=2)
    o_j = np.asarray(JD._splash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16, block=128))
    o_t, _ = _port(q, k, v, ct, 16)
    np.testing.assert_allclose(o_t, o_j, atol=2e-5)


# N smaller than, equal to and one more than the plain versions' block (and
# than half of it), and two blocks with a ragged third.
@pytest.mark.parametrize("n", [5, 64, 65, 137, FA.PLAIN_BLOCK, FA.PLAIN_BLOCK + 1,
                               2 * FA.PLAIN_BLOCK + 9])
def test_plain_backward_matches_autograd_f64(n):
    """The written-out backward against autograd, in f64: through a softmax
    attention kept in f64 (1e-12), and through the port's written-out
    ``_attention``, whose softmax runs in f32 (1e-6)."""
    gen = torch.Generator().manual_seed(n)
    q, k, v, g = (torch.randn((2, 2, n, 8), generator=gen, dtype=torch.float64) for _ in range(4))
    scale = 1.0 / math.sqrt(8)

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fn(*xs)
        o.backward(g)
        return [o.detach()] + [x.grad for x in xs]

    got = grads(lambda q, k, v: FA.flash_attention(q, k, v, scale))
    exact = grads(lambda q, k, v: torch.softmax(q @ k.transpose(-1, -2) * scale, -1) @ v)
    written = grads(lambda q, k, v: TD._attention(q, k, v, 8))
    for a, e, w in zip(got, exact, written):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, e, rtol=0, atol=1e-12)
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)


def test_log_sum_exp_and_block_size_do_not_matter():
    gen = torch.Generator().manual_seed(3)
    q, k, v, g = (torch.randn((1, 2, 37, 16), generator=gen) for _ in range(4))
    o, lse = FA.flash_fwd_plain(q, k, v, 0.25)
    ref = torch.logsumexp(q @ k.transpose(-1, -2) * 0.25, -1)
    torch.testing.assert_close(lse, ref, rtol=0, atol=1e-5)
    o7, lse7 = FA.flash_fwd_plain(q, k, v, 0.25, block=7)
    torch.testing.assert_close(o7, o, rtol=0, atol=1e-6)
    delta = FA.flash_delta_plain(o, g)
    for a, e in zip(FA.flash_bwd_plain(q, k, v, g, lse, delta, 0.25, block=7),
                    FA.flash_bwd_plain(q, k, v, g, lse, delta, 0.25)):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-5)


def test_bf16_probabilities_round_before_the_product():
    """In bf16 the plain version rounds P before P V and divides by the f32
    sum afterwards, as ``_attention`` does: the two stay within one bf16
    step of each other (2^-7 of the largest output)."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 2, 70, 64), generator=gen).bfloat16() for _ in range(3))
    o = FA.flash_attention(q, k, v, 0.125)
    ref = TD._attention(q, k, v, 64)
    assert o.dtype == torch.bfloat16
    err = float((o.float() - ref.float()).abs().max())
    assert err <= 2.0**-7 * float(ref.float().abs().max())


def test_forward_under_inference_mode():
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((1, 2, 9, 16), generator=gen) for _ in range(3))
    with torch.inference_mode():
        o = FA.flash_attention(q, k, v, 0.25)
    assert o.is_inference() and not o.requires_grad
    torch.testing.assert_close(o, TD._attention(q, k, v, 16), rtol=0, atol=1e-6)


def test_attn_impl_names():
    for name in ("xla", "flash", "splash"):
        assert TD.DinoConfig(attn_impl=name).attn_impl == name
    assert TD.DinoConfig().attn_impl == "flash"  # the port's default: the kernel
    assert JD.DinoConfig().attn_impl == "xla"
    with pytest.raises(ValueError, match="attn_impl must be"):
        TD.DinoConfig(attn_impl="flsh")
    assert not hasattr(TD.DinoConfig(), "flash_block")  # TPU tile knobs are not ported
    assert TD.DinoConfig().splash_fused_bwd is JD.DinoConfig().splash_fused_bwd is False


@pytest.mark.parametrize("which", ["flash_fwd", "flash_bwd_delta", "flash_bwd_dkv", "flash_bwd_dq"])
def test_flash_wrappers_refuse_cpu_tensors(which):
    x = torch.zeros((1, 1, 4, 64), dtype=torch.bfloat16)
    s = torch.zeros((1, 1, 4))
    before = getattr(kernels, which).launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        if which == "flash_fwd":
            kernels.flash_fwd(x, x, x, 0.125)
        elif which == "flash_bwd_delta":
            kernels.flash_bwd_delta(x, x)
        else:
            getattr(kernels, which)(x, x, x, x, s, s, 0.125)
    assert getattr(kernels, which).launches == before


def test_tma_layout_of_the_vit_views():
    """The tensor maps of the q, k and v views of one (B, N, 3, H, 64)
    projection and of a (B, N, H, 64) cotangent: dims (64, N, H, B) and the
    token, head and batch strides in bytes."""
    b, n, h = 2, 37, 3
    qkv = torch.zeros((b, n, 3, h, 64), dtype=torch.bfloat16)
    row = 3 * h * 64 * 2  # bytes from one token to the next
    for i, x in enumerate(qkv.permute(2, 0, 3, 1, 4)):
        dims, strides = kernels.tma_layout(x)
        assert dims == (64, n, h, b)
        assert strides == (row, 128, n * row)
        assert x.data_ptr() - qkv.data_ptr() == i * h * 128
    g = torch.zeros((b, n, h * 64), dtype=torch.bfloat16).reshape(b, n, h, 64).transpose(1, 2)
    assert kernels.tma_layout(g) == ((64, n, h, b), (h * 128, 128, n * h * 128))
    # A dim of extent 1 takes the span of the dims inside it.
    one = torch.zeros((1, 1, n, 64), dtype=torch.bfloat16)
    assert kernels.tma_layout(one) == ((64, n, 1, 1), (128, n * 128, n * 128))


@pytest.mark.parametrize("case", ["padded", "sliced", "strided-head", "broadcast"])
def test_tma_layout_refuses_what_tma_cannot_read(case):
    base = torch.zeros((2, 3, 9, 68), dtype=torch.bfloat16)
    x = {
        "padded": base[..., :64],  # rows 136 bytes apart
        "sliced": torch.zeros((2, 3, 9, 72), dtype=torch.bfloat16)[..., 4:68],  # base + 8 bytes
        "strided-head": torch.zeros((2, 3, 9, 128), dtype=torch.bfloat16)[..., ::2],
        "broadcast": torch.zeros((2, 3, 1, 64), dtype=torch.bfloat16).expand(2, 3, 9, 64),
    }[case]
    assert x.shape == (2, 3, 9, 64)
    with pytest.raises(ValueError):
        kernels.tma_layout(x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16, torch.float64])
def test_flash_dtype_rule(dtype):
    """The K5 dispatch's dtype rule needs no card: bf16 and f32 each have
    kernels of their own, f16 and f64 are refused (no cast, no plain version
    on the card)."""
    if dtype in (torch.bfloat16, torch.float32):
        assert kernels.flash_dtype(dtype) is dtype
    else:
        with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
            kernels.flash_dtype(dtype, "q")


def test_tma_layout_of_f32_views():
    """The f32 kernels read 16-byte pieces of rows as the bf16 kernels' tensor
    maps do: the same layout rule in bytes, for 4-byte values."""
    b, n, h = 2, 37, 3
    qkv = torch.zeros((b, n, 3, h, 64))
    row = 3 * h * 64 * 4
    for x in qkv.permute(2, 0, 3, 1, 4):
        assert kernels.tma_layout(x) == ((64, n, h, b), (row, 256, n * row))
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.tma_layout(torch.zeros((2, 3, 9, 66))[..., :64])  # rows 264 bytes apart
    with pytest.raises(ValueError, match="2- or 4-byte"):
        kernels.tma_layout(torch.zeros((2, 3, 9, 64), dtype=torch.float64))


def test_f32_vit_with_flash_matches_jax_attention():
    """The port's ViT at head dim 64 (two heads of a 128-wide tiny config)
    with f32 parameters and attn_impl="flash" (on the CPU the plain
    versions, the f32 kernels' arithmetic) against the JAX ViT's written-out
    ``_attention``: tokens and d(tokens)/d(rgb) within 1e-5 (f32 sums in
    another order)."""
    kw = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, smaller_edge_size=32, pos_grid=4)
    cfg_j = JD.DinoConfig(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params_j
    )
    params_t = TD.params_from_jax(jax.tree.map(np.asarray, params_j))
    rgb = rng.random((2, 3, 48, 48)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 128)).astype(np.float32)
    tok_j, vjp = jax.vjp(
        lambda x: JD.forward_tokens_from_crop(params_j, x, cfg_j, remat=False), jnp.asarray(rgb)
    )
    (g_j,) = vjp(jnp.asarray(ct))
    x = torch.tensor(rgb, requires_grad=True)
    tok_t = TD.forward_tokens_from_crop(params_t, x, TD.DinoConfig(attn_impl="flash", **kw))
    (tok_t * torch.tensor(ct)).sum().backward()
    assert tok_t.dtype == torch.float32
    np.testing.assert_allclose(tok_t.detach().numpy(), np.asarray(tok_j), atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=1e-5)


# --------------------------------------------------------------------------
# The f32 kernels' 3xTF32 split (csrc/flash_attention_f32.cu), emulated.
# --------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as the f32 kernels write it: half a unit of the 13
    dropped mantissa bits carried in, then the bits cleared (round to
    nearest, ties away from zero)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels compute it: three TF32 products (each product of
    two 11-bit mantissas exact in f32), small terms first, summed in f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding_of_the_split():
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-23,
                      1.0 + 3 * 2.0**-11, 3.0e-39, 0.0])
    hi = _tf32(x)
    # Ties go away from zero; below a tie rounds down; low 13 bits clear.
    assert hi[:4].tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.0 + 2 * 2.0**-10]
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    y = torch.as_tensor(np.random.default_rng(1).standard_normal(10000).astype(np.float32))
    h, l = _split(y)
    rel = ((h.double() + l.double() - y.double()).abs() / y.double().abs()).max()
    assert float(rel) <= 2.0**-21


def _attention_operands(n=300, seed=2):
    """The six products of flash attention at ViT-like magnitudes (q, k, v
    of a few units, scale 1/8), their f32 operands made from the f64
    softmax and its backward."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.as_tensor(1.5 * rng.standard_normal((2, n, 64))) for _ in range(4))
    s = q @ k.transpose(-1, -2) * 0.125
    p = torch.softmax(s, -1)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - (g * (p @ v)).sum(-1, keepdim=True))
    f = {name: x.float() for name, x in (("q", q), ("k", k), ("v", v), ("g", g), ("p", p),
                                         ("ds", ds))}
    return {
        "S = Q K^T": (f["q"], f["k"].transpose(-1, -2)),
        "O = P V": (f["p"], f["v"]),
        "dV = P^T dO": (f["p"].transpose(-1, -2), f["g"]),
        "dP = dO V^T": (f["g"], f["v"].transpose(-1, -2)),
        "dK = dS^T Q": (f["ds"].transpose(-1, -2), f["q"]),
        "dQ = dS K": (f["ds"], f["k"]),
    }


@pytest.mark.parametrize("product", ["S = Q K^T", "O = P V", "dV = P^T dO", "dP = dO V^T",
                                     "dK = dS^T Q", "dQ = dS K"])
def test_three_tf32_products_meet_1e5_where_one_does_not(product):
    """Each product of the f32 kernels, as three TF32 products, within 1e-5
    of the largest magnitude of the f64 product of the same f32 operands;
    one TF32 product (what the tensor cores give for raw f32) is not."""
    a, b = _attention_operands()[product]
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    err3 = float((_mm3(a, b).double() - ref).abs().max()) / scale
    err1 = float(((_tf32(a) @ _tf32(b)).double() - ref).abs().max()) / scale
    assert err3 <= 1e-5, (product, err3)
    assert err1 > 1e-5, (product, err1)
