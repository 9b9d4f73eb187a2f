"""Port ViT vs the JAX package with the JAX parameters carried across by
``params_from_jax``, at a tiny config (patch 8, dim 32, depth 2), in f32:
tokens and d(tokens)/d(rgb) within 1e-4, for each ``attn_impl`` of the port
("flash" and "splash" run the flash attention's plain versions on the CPU;
the JAX side runs "xla" there whatever it is asked for)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch.models import dino as TD

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, smaller_edge_size=32)


def _params(pos_grid, attn_impl="xla"):
    cfg_j = JD.DinoConfig(pos_grid=pos_grid, **TINY)
    params_j = JD.init_params(jax.random.PRNGKey(0), cfg_j)
    # Non-trivial LayerNorm / LayerScale values, so every parameter matters.
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params_j
    )
    cfg_t = TD.DinoConfig(pos_grid=pos_grid, attn_impl=attn_impl, **TINY)
    return cfg_j, params_j, cfg_t, TD.params_from_jax(jax.tree.map(np.asarray, params_j))


# pos_grid 4 = the token grid (no interpolation); 3 interpolates the
# position embedding bicubically.
@pytest.mark.parametrize(
    "pos_grid,attn_impl",
    [(4, "xla"), (3, "xla"), (4, "flash"), (3, "flash"), (4, "splash"), (3, "splash")],
    ids=["4", "3", "4-flash", "3-flash", "4-splash", "3-splash"],
)
def test_tokens_from_crop_and_input_gradient(pos_grid, attn_impl):
    cfg_j, params_j, cfg_t, params_t = _params(pos_grid, attn_impl)
    rng = np.random.default_rng(1)
    rgb = rng.random((2, 3, 48, 48)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 32)).astype(np.float32)

    tok_j, vjp = jax.vjp(
        lambda x: JD.forward_tokens_from_crop(params_j, x, cfg_j, remat=False),
        jnp.asarray(rgb),
    )
    (g_j,) = vjp(jnp.asarray(ct))
    x = torch.tensor(rgb, requires_grad=True)
    tok_t = TD.forward_tokens_from_crop(params_t, x, cfg_t)
    (tok_t * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(tok_t.detach().numpy(), np.asarray(tok_j), atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_j), atol=1e-4)


def test_extract_features_matches():
    cfg_j, params_j, cfg_t, params_t = _params(4)
    img = np.random.default_rng(2).random((2, 3, 32, 32)).astype(np.float32)
    f_j = JD.extract_features(params_j, jnp.asarray(img), cfg_j, remat=False)
    f_t = TD.extract_features(params_t, torch.tensor(img), cfg_t)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-4)


def test_init_params_layout():
    cfg = TD.DinoConfig(pos_grid=4, **TINY)
    p_t = TD.init_params(cfg, torch.Generator().manual_seed(0))
    p_j = JD.init_params(jax.random.PRNGKey(0), JD.DinoConfig(pos_grid=4, **TINY))
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), p_t)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), p_j)
    assert shapes_t == shapes_j
    k = p_t["blocks"]["fc1_kernel"]
    assert float(k.abs().max()) <= 0.04 and 0.01 < float(k.std()) < 0.03
    assert not any(a.requires_grad for a in jax.tree.leaves(p_t))
