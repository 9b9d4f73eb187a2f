"""Port ViT vs the JAX package with the JAX parameters carried across by
``params_from_jax``, at a tiny config (patch 8, dim 32, depth 2), in f32:
tokens and d(tokens)/d(rgb) within 1e-4, for each ``attn_impl`` of the port
("flash" and "splash" run the flash attention's plain versions on the CPU,
"splash" with ``splash_fused_bwd`` the fused backward's; the JAX side runs
"xla" there whatever it is asked for)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch.models import dino as TD

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, smaller_edge_size=32)


def _params(pos_grid, attn_impl="xla", fused_bwd=False):
    cfg_j = JD.DinoConfig(pos_grid=pos_grid, **TINY)
    params_j = JD.init_params(jax.random.PRNGKey(0), cfg_j)
    # Non-trivial LayerNorm / LayerScale values, so every parameter matters.
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params_j
    )
    cfg_t = TD.DinoConfig(pos_grid=pos_grid, attn_impl=attn_impl, splash_fused_bwd=fused_bwd,
                          **TINY)
    return cfg_j, params_j, cfg_t, TD.params_from_jax(jax.tree.map(np.asarray, params_j))


# pos_grid 4 = the token grid (no interpolation); 3 interpolates the
# position embedding bicubically.
@pytest.mark.parametrize(
    "pos_grid,attn_impl,fused_bwd",
    [(4, "xla", False), (3, "xla", False), (4, "flash", False), (3, "flash", False),
     (4, "splash", False), (3, "splash", False), (4, "splash", True), (3, "splash", True)],
    ids=["4", "3", "4-flash", "3-flash", "4-splash", "3-splash", "4-splash-fused-bwd",
         "3-splash-fused-bwd"],
)
def test_tokens_from_crop_and_input_gradient(pos_grid, attn_impl, fused_bwd):
    cfg_j, params_j, cfg_t, params_t = _params(pos_grid, attn_impl, fused_bwd)
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


def test_config_takes_the_jax_packages_attention_knobs():
    """The port's DinoConfig has the JAX one's fields but the TPU tile sizes,
    and its defaults, ``splash_fused_bwd`` among them, but ``attn_impl``:
    "flash" (the hand-written kernel) in the port, "xla" in the JAX package.
    It builds from the same keywords, refuses the tile sizes rather than
    ignore them, and rejects what the JAX one rejects (an unknown
    ``attn_impl``)."""
    tiles = ("flash_block", "splash_block")
    fields = [f.name for f in dataclasses.fields(JD.DinoConfig) if f.name not in tiles]
    assert [f.name for f in dataclasses.fields(TD.DinoConfig)] == fields
    others = [n for n in fields if n != "attn_impl"]
    assert {n: getattr(TD.DinoConfig(), n) for n in others} == {
        n: getattr(JD.DinoConfig(), n) for n in others}
    assert (TD.DinoConfig().attn_impl, JD.DinoConfig().attn_impl) == ("flash", "xla")
    assert TD.DinoConfig().splash_fused_bwd is False
    for kw in (dict(attn_impl="splash", splash_fused_bwd=True),
               dict(attn_impl="flash", splash_fused_bwd=True)):
        cfg_j, cfg_t = JD.DinoConfig(**kw), TD.DinoConfig(**kw)
        assert {n: getattr(cfg_t, n) for n in fields} == {n: getattr(cfg_j, n) for n in fields}
    for kw in (dict(attn_impl="splash", splash_block=512, splash_fused_bwd=True),
               dict(attn_impl="flash", flash_block=256)):
        JD.DinoConfig(**kw)
        with pytest.raises(TypeError, match="_block"):
            TD.DinoConfig(**kw)
    for bad in ("pallas", "Splash", ""):
        with pytest.raises(ValueError, match="attn_impl"):
            JD.DinoConfig(attn_impl=bad)
        with pytest.raises(ValueError, match="attn_impl"):
            TD.DinoConfig(attn_impl=bad)


@pytest.mark.parametrize("attn_impl", ["flash", "splash"])
def test_fused_bwd_counts_under_splash_only(attn_impl, monkeypatch):
    """``splash_fused_bwd`` selects the fused backward under "splash" and is
    ignored under "flash", as the JAX package passes it to splash alone."""
    from dynhor_tpu_torch.ops import flash_attention as FA

    seen = []
    real = FA.flash_bwd

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(FA, "flash_bwd", spy)
    _, _, cfg_t, params_t = _params(4, attn_impl, fused_bwd=True)
    x = torch.rand((2, 3, 48, 48), generator=torch.Generator().manual_seed(0), requires_grad=True)
    TD.forward_tokens_from_crop(params_t, x, cfg_t).sum().backward()
    assert seen == [attn_impl == "splash"] * TINY["depth"]


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


def test_presets_and_loader_without_a_checkpoint():
    """MODEL_PRESETS and config_for_model equal the JAX package's; with no
    checkpoint, load_params draws init_params from the seed (the same seed,
    the same weights; the draw differs from JAX's, so parity tests carry
    weights across)."""
    assert TD.MODEL_PRESETS == JD.MODEL_PRESETS
    for name in TD.MODEL_PRESETS:
        got = TD.config_for_model(name, smaller_edge_size=56)
        want = JD.config_for_model(name, smaller_edge_size=56)
        assert (got.embed_dim, got.depth, got.num_heads, got.smaller_edge_size, got.feat_size) == (
            want.embed_dim, want.depth, want.num_heads, want.smaller_edge_size, want.feat_size)
    with pytest.raises(ValueError, match="unknown DINOv2 model"):
        TD.config_for_model("dinov2_vitg14")
    cfg = TD.DinoConfig(pos_grid=4, **TINY)
    p1, c1 = TD.load_params(None, cfg, seed=3)
    p2, _ = TD.load_params(None, cfg, seed=3)
    p3, _ = TD.load_params(None, cfg, seed=4)
    assert c1 == cfg
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)))
    assert not torch.equal(p1["pos_embed"], p3["pos_embed"])
    with pytest.raises(FileNotFoundError):
        TD.load_params("/nonexistent/dino.npz", cfg)


# The port's ViT against a randomly initialised transformers Dinov2Model
# (built from a config, nothing downloaded), through convert_torch_state_dict:
# the counterparts of tests/test_dino.py's, at their tolerances.
@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    Dinov2Config, Dinov2Model = transformers.Dinov2Config, transformers.Dinov2Model

    cfg = Dinov2Config(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
                       intermediate_size=256, patch_size=14, image_size=224, layerscale_value=0.7)
    torch.manual_seed(0)
    return Dinov2Model(cfg).eval()


@pytest.mark.parametrize("size,seed,atol", [(224, 0, 2e-4), (280, 1, 5e-3)],
                         ids=["native", "interpolated"])
def test_matches_transformers_dinov2(hf_model, size, seed, atol):
    """At 224 the position grid is the checkpoint's (16²); at 280 (20²) the
    bicubic position-embedding interpolation runs."""
    cfg = TD.DinoConfig(patch_size=14, embed_dim=64, depth=3, num_heads=4, pos_grid=16,
                        smaller_edge_size=224)
    params, cfg = TD.convert_torch_state_dict(hf_model.state_dict(), cfg)
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.pos_grid) == (64, 3, 4, 16)
    img = np.random.RandomState(seed).rand(2 if size == 224 else 1, 3, size, size)
    img = torch.from_numpy(img.astype(np.float32))
    with torch.no_grad():
        want = hf_model(img).last_hidden_state[:, 1:].numpy()
        got = TD.forward_tokens(params, img, cfg).numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def _official_from_hf(hf_sd, depth):
    """The official facebookresearch/dinov2 naming of a transformers
    state_dict (qkv concatenated), as tests/test_dino.py builds it."""
    official = {
        "cls_token": hf_sd["embeddings.cls_token"],
        "pos_embed": hf_sd["embeddings.position_embeddings"],
        "patch_embed.proj.weight": hf_sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.proj.bias": hf_sd["embeddings.patch_embeddings.projection.bias"],
        "norm.weight": hf_sd["layernorm.weight"],
        "norm.bias": hf_sd["layernorm.bias"],
    }
    names = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
             "attn.proj.weight": "attention.output.dense.weight",
             "attn.proj.bias": "attention.output.dense.bias",
             "ls1.gamma": "layer_scale1.lambda1", "norm2.weight": "norm2.weight",
             "norm2.bias": "norm2.bias", "mlp.fc1.weight": "mlp.fc1.weight",
             "mlp.fc1.bias": "mlp.fc1.bias", "mlp.fc2.weight": "mlp.fc2.weight",
             "mlp.fc2.bias": "mlp.fc2.bias", "ls2.gamma": "layer_scale2.lambda1"}
    for i in range(depth):
        pre = f"encoder.layer.{i}."
        for part in ("weight", "bias"):
            official[f"blocks.{i}.attn.qkv.{part}"] = torch.cat(
                [hf_sd[pre + f"attention.attention.{n}.{part}"] for n in ("query", "key", "value")])
        official.update({f"blocks.{i}.{k}": hf_sd[pre + v] for k, v in names.items()})
    return official


def test_official_naming_conversion_roundtrip(hf_model):
    """Both namings convert to the same parameters, equal to the JAX
    package's conversion of the same weights."""
    hf_sd = hf_model.state_dict()
    cfg = TD.DinoConfig(patch_size=14, embed_dim=64, depth=3, num_heads=4, pos_grid=16,
                        smaller_edge_size=224)
    p_hf, _ = TD.convert_torch_state_dict(hf_sd, cfg)
    p_of, c_of = TD.convert_torch_state_dict(_official_from_hf(hf_sd, 3), cfg)
    p_j, c_j = JD.convert_torch_state_dict(_official_from_hf(hf_sd, 3), JD.DinoConfig(
        patch_size=14, embed_dim=64, depth=3, num_heads=4, pos_grid=16, smaller_edge_size=224))
    assert (c_of.embed_dim, c_of.depth, c_of.num_heads, c_of.pos_grid) == (
        c_j.embed_dim, c_j.depth, c_j.num_heads, c_j.pos_grid)
    for path, a in jax.tree_util.tree_leaves_with_path(p_hf):
        keys = [k.key for k in path]
        b, want = p_of, p_j
        for k in keys:
            b, want = b[k], want[k]
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(keys))
        np.testing.assert_array_equal(a.numpy(), np.asarray(want), err_msg=str(keys))
