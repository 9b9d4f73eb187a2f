"""The ViT's recomputation policies (``models/dino._trunk``'s ``remat``, the
refine's ``RefineConfig.dino_remat``) against the JAX package's, on a tiny
ViT (depth 2, embed 64, 2 heads, 37 tokens) with frozen weights.

Every policy computes the same image gradient as keeping everything, and
the JAX package's under the same policy.  What each keeps between the
forward and the backward is counted by storage: every tensor the forward
makes is tracked (a dispatch mode, weak references to the storages), and
what is still alive once the forward's own references are gone is what the
backward keeps, whichever mechanism holds it (autograd's saved tensors, a
checkpoint's inputs, the selective checkpoint's cache).  The tensors that
autograd itself packs outside the recomputed segments are also seen through
``torch.autograd.graph.saved_tensors_hooks``.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch.models import dino as TD

TINY = dict(patch_size=8, embed_dim=64, depth=2, num_heads=2, smaller_edge_size=48, pos_grid=6)
B, CROP = 2, 32
N = (48 // 8) ** 2 + 1  # tokens, cls included
D = 64
POLICIES = [False, True, "frozen", "dots"]


@pytest.fixture(autouse=True)
def _one_thread():
    """Small ops on one torch thread: under the suite's workers torch's own
    threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vit():
    cfg_j = JD.DinoConfig(**TINY)
    params_j = JD.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params_j
    )
    rgb = rng.random((B, 3, CROP, CROP)).astype(np.float32)
    ct = rng.standard_normal((B, N - 1, D)).astype(np.float32)
    return cfg_j, params_j, TD.params_from_jax(jax.tree.map(np.asarray, params_j)), rgb, ct


@pytest.fixture(scope="module")
def jax_grads():
    return {}  # remat -> the JAX tokens and image gradient


def _grad(params, cfg, rgb, ct, remat):
    x = torch.tensor(rgb, requires_grad=True)
    tok = TD.forward_tokens_from_crop(params, x, cfg, remat=remat)
    (tok * torch.tensor(ct)).sum().backward()
    return tok.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("remat", POLICIES, ids=str)
def test_gradient_equals_no_recomputation_and_jax(vit, jax_grads, remat, attn_impl):
    cfg_j, params_j, params, rgb, ct = vit
    cfg = TD.DinoConfig(attn_impl=attn_impl, **TINY)
    tok0, g0 = _grad(params, cfg, rgb, ct, False)
    tok, g = _grad(params, cfg, rgb, ct, remat)
    np.testing.assert_array_equal(tok, tok0)
    np.testing.assert_allclose(g, g0, rtol=1e-6, atol=1e-6 * np.abs(g0).max())
    if remat not in jax_grads:  # the same for both attentions (JAX runs "xla" on the CPU)
        tok_j, vjp = jax.vjp(
            lambda x: JD.forward_tokens_from_crop(params_j, x, cfg_j, remat=remat),
            jnp.asarray(rgb),
        )
        jax_grads[remat] = np.asarray(tok_j), np.asarray(vjp(jnp.asarray(ct))[0])
    tok_j, g_j = jax_grads[remat]
    np.testing.assert_allclose(tok, tok_j, atol=1e-4)
    np.testing.assert_allclose(g, g_j, atol=1e-4)


class _Made(TorchDispatchMode):
    """Records a weak reference to the storage of every tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                self.made.append((StorageWeakRef(st), st.data_ptr(), st.nbytes(), tuple(t.shape)))
        return out

    def alive(self) -> dict:
        """{address: (bytes, shapes)} of the storages still alive (a freed
        storage's address may have been given to a later one)."""
        out = {}
        for ref, ptr, nbytes, shape in self.made:
            if not ref.expired():
                out.setdefault(ptr, (nbytes, []))[1].append(shape)
        return out


def _kept(params, cfg, rgb, remat, dtype=torch.float32):
    """{storage: (bytes, shapes it was seen with)} kept for the backward."""
    params = TD.map_params(params, lambda a: a.to(dtype))
    before = {a.untyped_storage().data_ptr() for a in tree_leaves(params)}
    x = torch.tensor(rgb, requires_grad=True)
    made = _Made()
    with made:
        loss = TD.forward_tokens_from_crop(params, x, cfg, remat=remat).float().square().sum()
    gc.collect()
    kept = {p: v for p, v in made.alive().items()
            if p not in before and p != loss.untyped_storage().data_ptr()}
    loss.backward()  # the graph the count saw is a working one
    assert torch.isfinite(x.grad).all()
    return kept


def _square(shapes) -> bool:
    return any(len(s) >= 2 and s[-1] == s[-2] == N for s in shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_what_each_policy_keeps(vit, attn_impl, dtype):
    _, _, params, rgb, _ = vit
    cfg = TD.DinoConfig(attn_impl=attn_impl, **TINY)
    kept = {r: _kept(params, cfg, rgb, r, dtype) for r in POLICIES}
    total = {r: sum(nb for nb, _ in k.values()) for r, k in kept.items()}
    size = torch.finfo(dtype).bits // 8
    per_block = lambda values: TINY["depth"] * B * N * values * size  # noqa: E731
    # True keeps the block inputs (and what lies outside the blocks, which
    # every policy keeps alike); "frozen" adds qkv, the mid residual and the
    # fc1 output: 3D + D + 4D, with the block input 9D a token a block.
    assert total["frozen"] - total[True] == per_block(3 * D + D + 4 * D)
    # "dots" adds every matmul output: qkv, the projection, fc1 and fc2
    # (3D + D + 4D + D) and, written out, the scores and P.V (H.N + D).  The
    # CPU's plain flash attention adds its own matmuls' outputs (in its f32
    # accumulators); on the card the flash kernel is no matmul, and runs
    # again in the backward.
    heads = TINY["num_heads"]
    if attn_impl == "xla":
        assert total["dots"] - total[True] == per_block(9 * D + heads * N + D)
        assert total["dots"] < total[False]
    else:
        assert total["dots"] - total[True] > per_block(9 * D)
        assert total["frozen"] < total[False]
    assert total[True] < total["frozen"] < total["dots"]
    assert not any(_square(s) for _, s in kept["frozen"].values())
    assert not any(_square(s) for _, s in kept[True].values())
    if attn_impl == "xla":
        # The scores are kept under "dots", the softmax (exp in f32, then
        # cast) is not: one N x N storage a block, in the compute dtype.
        squares = [nb for nb, s in kept["dots"].values() if _square(s)]
        assert squares == [B * heads * N * N * size] * TINY["depth"]
        # False keeps the softmax (the exp's output).
        assert sum(_square(s) for _, s in kept[False].values()) >= TINY["depth"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_frozen_keeps_the_same_under_the_fused_backward(vit, dtype):
    """``attn_impl="splash"`` with ``splash_fused_bwd`` under "frozen" keeps
    exactly what the two-pass flash attention keeps (the same storages by
    size, none of them N x N): the backward changes, not what it is given.
    In f32 the image gradient is the two-pass one's within 1e-6."""
    _, _, params, rgb, ct = vit
    flash = TD.DinoConfig(attn_impl="flash", **TINY)
    fused = TD.DinoConfig(attn_impl="splash", splash_fused_bwd=True, **TINY)

    def kept(cfg):
        storages = _kept(params, cfg, rgb, "frozen", dtype).values()
        assert not any(_square(shapes) for _, shapes in storages)
        return sorted(nb for nb, _ in storages)

    assert kept(fused) == kept(flash)
    if dtype == torch.float32:
        tok0, g0 = _grad(params, flash, rgb, ct, "frozen")
        tok, g = _grad(params, fused, rgb, ct, "frozen")
        np.testing.assert_array_equal(tok, tok0)
        np.testing.assert_allclose(g, g0, rtol=1e-6, atol=1e-6 * np.abs(g0).max())


def test_saved_tensor_hooks_see_block_inputs_and_frozen_saves(vit):
    """What autograd packs (checkpoint inputs included), weights aside: the
    patch embedding's and the final layer norm's tensors under every policy,
    and per block the block input under True; under "frozen" the block
    input, qkv, the mid residual and the fc1 output (the GELU's input), in
    the order the forward makes them.  (The selective checkpoint of "dots"
    keeps its matmul outputs in a cache these hooks do not see; the storage
    count above does.)"""
    _, _, params, rgb, _ = vit
    cfg = TD.DinoConfig(**TINY)
    weights = {a.untyped_storage().data_ptr() for a in tree_leaves(params)}

    def packed(remat):
        seen = []

        def pack(t):
            if t.untyped_storage().data_ptr() not in weights:
                seen.append(tuple(t.shape))
            return t

        x = torch.tensor(rgb, requires_grad=True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            tok = TD.forward_tokens_from_crop(params, x, cfg, remat=remat)
        tok.sum().backward()
        return seen

    depth = TINY["depth"]
    whole = packed(True)
    head, tail = whole[:3], whole[3 + depth:]  # the patch embedding; the final layer norm
    assert whole == head + [(B, N, D)] * depth + tail
    assert packed("frozen") == head + [(B, N, D), (B, N, 3 * D), (B, N, D), (B, N, 4 * D)] * depth + tail


@pytest.mark.parametrize("remat", ["frozen", "dots", True])
def test_weight_gradients_equal_no_recomputation(vit, remat):
    """With weights that take a gradient, every policy gives False's
    gradients to the image and to each weight."""
    _, _, params, rgb, ct = vit

    def grads(policy):
        p = TD.map_params(params, lambda a: a.clone().requires_grad_(True))
        x = torch.tensor(rgb, requires_grad=True)
        tok = TD.forward_tokens_from_crop(p, x, TD.DinoConfig(**TINY), remat=policy)
        (tok * torch.tensor(ct)).sum().backward()
        return [x.grad] + [a.grad for a in tree_leaves(p)]

    for got, want in zip(grads(remat), grads(False)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
