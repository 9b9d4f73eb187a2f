"""The port's fused attention backward (``flash_attention(..., fused_bwd=True)``,
K5c's plain version on the CPU) against the JAX package's fused splash
backward, and against the port's two-pass backward.

``dino._splash_attention(..., fused_bwd=True)`` runs the splash kernel with
``use_fused_bwd_kernel`` in Pallas interpret mode, as
tests/test_torch_flash.py runs the splash kernel.  At N 260 both sides cut
the keys into three blocks (the port's of 128 keys, the JAX side's of
``block`` 128 after padding to 384), so each sums three dQ partials.
Layouts: JAX (B, N, H, hd), port (B, H, N, hd).  Tolerances: 2e-5 against
the splash kernel in f32 (f32 sums in another order, as tests/test_dino.py);
in bf16, both cutting the keys at the same 128-key blocks, 2^-7 of the
largest dq (both round each block's partial to bf16 once and their sum
once, at the same points, but each side's own forward gives o and the
log-sum-exp, whose last-bit differences move some dS across a bf16
rounding boundary: one bf16 step, 2^-8 relative, 2^-7 at a binade's lower
edge); against the two-pass backward 1e-6 in f32 (the same products; each
partial's scale is a power of two) and 2^-7 of the largest value in bf16
(each partial rounds to bf16 before the sum, the two-pass dq once).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import flash_attention as FA


def _inputs(b, n, h, hd, seed=0):
    """q, k, v and a cotangent, (B, N, H, hd) f32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, h, hd)).astype(np.float32) for _ in range(4)]


def test_fused_matches_jax_splash_fused_kernel(monkeypatch):
    import jax
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as splash,
    )

    real = splash.make_splash_mha

    def interp_mha(mask, **kw):
        kw["interpret"] = True
        return real(mask, **kw)

    monkeypatch.setattr(splash, "make_splash_mha", interp_mha)
    b, n, h, hd = 2, 260, 3, 16
    q, k, v, ct = _inputs(b, n, h, hd, seed=5)

    def jax_fn(q, k, v):
        return JD._splash_attention(q, k, v, hd, block=128, fused_bwd=True)

    o_j, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_j = [np.asarray(g) for g in vjp(jnp.asarray(ct))]

    qkv = torch.tensor(np.stack([q, k, v], axis=2), requires_grad=True)  # (B, N, 3, H, hd)
    qt, kt, vt = qkv.permute(2, 0, 3, 1, 4)
    o_t = FA.flash_attention(qt, kt, vt, 1.0 / math.sqrt(hd), fused_bwd=True)
    o_t.backward(torch.tensor(ct).permute(0, 2, 1, 3))
    np.testing.assert_allclose(o_t.detach().permute(0, 2, 1, 3).numpy(), np.asarray(o_j),
                               atol=2e-5)
    for i, (name, e) in enumerate(zip("qkv", g_j)):
        np.testing.assert_allclose(qkv.grad[:, :, i].numpy(), e, atol=2e-5, err_msg=f"d{name}")


def test_fused_bf16_matches_jax_splash_fused_at_the_same_blocks(monkeypatch):
    """bf16 dq of the port's plain fused backward against the JAX fused
    splash backward at ``block`` 128, N 300 (three partials on both sides:
    keys [0, 128), [128, 256), [256, 300)), at 2^-7 of the largest dq."""
    import jax
    from jax.experimental.pallas.ops.tpu.splash_attention import (
        splash_attention_kernel as splash,
    )

    real = splash.make_splash_mha

    def interp_mha(mask, **kw):
        kw["interpret"] = True
        return real(mask, **kw)

    monkeypatch.setattr(splash, "make_splash_mha", interp_mha)
    b, n, h, hd = 2, 300, 3, 16
    q, k, v, ct = (jnp.asarray(x, jnp.bfloat16) for x in _inputs(b, n, h, hd, seed=7))

    def jax_fn(q, k, v):
        return JD._splash_attention(q, k, v, hd, block=FA.PLAIN_BLOCK, fused_bwd=True)

    _, vjp = jax.vjp(jax_fn, q, k, v)
    dq_j = np.asarray(vjp(ct)[0].astype(jnp.float32))
    qt, kt, vt, gt = (torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
                      .permute(0, 2, 1, 3) for x in (q, k, v, ct))
    scale = 1.0 / math.sqrt(hd)
    o, lse = FA.flash_fwd_plain(qt, kt, vt, scale)
    delta = FA.flash_delta_plain(o, gt)
    part, _, _ = FA.flash_bwd_fused_plain(qt, kt, vt, gt, lse, delta, scale)
    assert part.shape[0] == 3 and part.dtype == torch.bfloat16
    dq = FA.sum_dq_part(part).float().permute(0, 2, 1, 3).numpy()
    assert np.abs(dq - dq_j).max() <= 2.0**-7 * np.abs(dq_j).max()


def _backwards(b, h, n, hd, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn((b, h, n, hd), generator=gen).to(dtype) for _ in range(4))
    o, lse = FA.flash_fwd_plain(q, k, v, 0.25)
    delta = FA.flash_delta_plain(o, g)
    two = FA.flash_bwd_plain(q, k, v, g, lse, delta, 0.25)
    fused = FA.flash_bwd_fused_plain(q, k, v, g, lse, delta, 0.25)
    return two, fused


# N below, at and past one key block, three blocks with a ragged last one.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 127, FA.PLAIN_BLOCK, FA.PLAIN_BLOCK + 1, 300])
def test_fused_plain_matches_two_pass_plain(n, dtype):
    (dq, dk, dv), (part, dk_f, dv_f) = _backwards(2, 3, n, 16, dtype, seed=n)
    assert part.shape == (-(-n // FA.PLAIN_BLOCK), 2, 3, n, 16) and part.dtype == dtype
    dq_f = FA.sum_dq_part(part)
    assert dq_f.dtype == dtype and dq_f.shape == dq.shape
    # The same P, dV, dP, dS and dK as the two-pass backward.
    assert torch.equal(dk_f, dk) and torch.equal(dv_f, dv)
    tol = 1e-6 if dtype == torch.float32 else 2.0**-7
    assert float((dq_f.float() - dq.float()).abs().max()) <= tol * max(
        float(dq.float().abs().max()), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_partials_are_each_blocks_rounded_product(dtype):
    """Each partial is one 128-key block's dS K * scale rounded to the input
    type, bit for bit, in block order."""
    gen = torch.Generator().manual_seed(6)
    q, k, v, g = (torch.randn((2, 3, 300, 16), generator=gen).to(dtype) for _ in range(4))
    o, lse = FA.flash_fwd_plain(q, k, v, 0.25)
    delta = FA.flash_delta_plain(o, g)
    part, _, _ = FA.flash_bwd_fused_plain(q, k, v, g, lse, delta, 0.25)
    blocks = [(torch.matmul(ds, kb) * 0.25).to(dtype)
              for ds, kb, _, _ in FA._bwd_blocks(q, k, v, g, lse, delta, 0.25, FA.PLAIN_BLOCK)]
    assert part.shape[0] == 3 and torch.equal(part, torch.stack(blocks))


def test_fused_partials_are_the_key_blocks_products():
    """Partial j is dS K * scale over keys [128 j, 128 j + 128): in f64 the
    partials sum to the two-pass dq.  In bf16 they are bf16, and their sum
    is taken in f32 and rounded once."""
    (dq, _, _), (part, _, _) = _backwards(1, 2, 300, 8, torch.float64, seed=1)
    assert part.shape[0] == 3
    torch.testing.assert_close(part.sum(0), dq, rtol=0, atol=1e-12)
    _, (part, _, _) = _backwards(1, 2, 300, 8, torch.bfloat16, seed=2)
    assert part.dtype == torch.bfloat16
    assert torch.equal(FA.sum_dq_part(part), part.float().sum(0).bfloat16())


def test_fused_flag_dispatch_on_the_cpu(monkeypatch):
    """``fused_bwd`` selects the fused plain backward and no other; without
    it the two-pass plain backward runs.  No kernel wrapper is touched."""
    calls = []

    def spy(name):
        real = getattr(FA, name)

        def wrapped(*args):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(FA, name, wrapped)

    spy("flash_bwd_plain")
    spy("flash_bwd_fused_plain")
    before = (kernels.flash_bwd_fused.launches, kernels.flash_bwd_dq.launches)
    gen = torch.Generator().manual_seed(4)
    for fused in (True, False):
        q, k, v = (torch.randn((1, 2, 40, 8), generator=gen).requires_grad_(True)
                   for _ in range(3))
        FA.flash_attention(q, k, v, 0.3, fused_bwd=fused).sum().backward()
    assert calls == ["flash_bwd_fused_plain", "flash_bwd_plain"]
    assert (kernels.flash_bwd_fused.launches, kernels.flash_bwd_dq.launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fused_wrappers_refuse_cpu_tensors(dtype):
    """The kernel's wrappers take CUDA tensors only: on CPU tensors they
    raise before any launch (the plain version runs through
    ``ops/flash_attention.flash_bwd`` instead)."""
    x = torch.zeros((1, 2, 8, 64), dtype=dtype)
    s = torch.zeros((1, 2, 8))
    wrappers = (kernels.flash_bwd_fused, kernels.flash_bwd_fused_f32)
    before = [f.launches for f in wrappers]
    for fn in wrappers:
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, x, x, x, s, s, 0.125)
    assert [f.launches for f in wrappers] == before


def test_refine_poses_runs_through_the_fused_backward(monkeypatch):
    """``refine_poses`` (fine mode, 3 steps, f32 ViT of head dim 64) under
    ``DinoConfig(attn_impl="splash", splash_fused_bwd=True)`` runs the
    fused backward's plain version on the CPU and follows the two-pass
    ``"flash"`` trajectory within 1e-5 (the same products in f32)."""
    import sys
    from pathlib import Path

    from dynhor_tpu_torch.models import dino as TD
    from dynhor_tpu_torch.ops import rasterize as RZ
    from dynhor_tpu_torch.tracker import refine as TR
    from dynhor_tpu_torch.utils import geometry as TG

    sys.path.insert(0, str(Path(__file__).parent))
    from test_refine_jointopt import SIZE, _K, _mesh

    calls = []
    real = FA.flash_bwd_fused_plain

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(FA, "flash_bwd_fused_plain", spy)
    mesh = TR.MeshArrays(*(torch.tensor(np.array(x)) for x in _mesh()))
    K = torch.tensor(np.array(_K()))
    R = TG.rotations_from_uniforms(torch.tensor([[0.1, 0.7], [0.4, 0.2], [0.8, 0.5]]))
    t = torch.tensor([[0.0, 0.0, 2.0], [0.05, -0.03, 2.1]])
    vp = RZ.project_perspective(mesh.verts @ R + t[:, None], K)
    masks = (RZ.rasterize(vp, mesh.faces, (SIZE, SIZE), face_chunk=12).pix_to_face >= 0).float()
    tiny = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, pos_grid=4,
                smaller_edge_size=32)
    params = TD.init_params(TD.DinoConfig(**tiny), torch.Generator().manual_seed(3))
    params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    gt = torch.randn((2, 16, 128), generator=torch.Generator().manual_seed(4))
    targets = TR.FrameTargets(masks, gt, K.expand(2, 3, 3))
    cfg = TR.RefineConfig(num_iterations=3, crop_size=SIZE, mode="fine", dino_dtype="float32",
                          max_active_tiles=8, face_chunk=12)
    R0 = TG.rot6d_to_matrix(TG.matrix_to_rot6d(R) + 0.05 * torch.randn(
        (2, 3, 2), generator=torch.Generator().manual_seed(5)))
    runs = {}
    for name, dcfg in (("flash", TD.DinoConfig(attn_impl="flash", **tiny)),
                       ("fused", TD.DinoConfig(attn_impl="splash", splash_fused_bwd=True,
                                               **tiny))):
        runs[name] = TR.refine_poses(mesh, targets, R0, t + 0.03, params, dcfg, cfg,
                                     device="cpu")
    assert len(calls) == 3 * tiny["depth"]  # once a layer and step
    for a, b in zip(runs["fused"][:4], runs["flash"][:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert float((runs["fused"].rot6d - TG.matrix_to_rot6d(R0)).abs().max()) > 1e-3
