"""Temporal gating, and the prior-scoring slice as a whole, vs the JAX
package.

Gating: on the inputs of tests/test_selection.py and on tied scores,
``selected_idx`` exact and rotations within 1e-6.

The slice: ``frame_gt_features`` -> ``prior_scores_two_stage`` ->
``gate_all_frames`` -> the translation init by autodepth, through both
packages at the small config of tests/test_priors_window.py (tiny f32 ViT,
24 views, 2 frames, topk 4, prescreen edge 28, render 192, crop 64).  On the
CPU the JAX package renders with ``rasterize_tiled`` and the port with K3's
plain version; both are margin-0 hard rasters (test_torch_priors.py pins
that down).  Scores within 1e-5, the rescored union and the counted caps
identical, ``selected_idx`` exact, the translation init within 1e-4.  The
port's chain runs once more with ``attn_impl="flash"`` (plain versions on the
CPU; the prescreen's config must keep it) and is held to the same JAX chain.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu.tracker import priors as JP
from dynhor_tpu.tracker import selection as JS
from dynhor_tpu.utils import bbox as JB
from dynhor_tpu.utils import camera as JC
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils.objio import load_obj
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.tracker import selection as TS
from dynhor_tpu_torch.utils import bbox as TB
from dynhor_tpu_torch.utils import camera as TC


def _gating_case(case):
    if case == "random":  # test_gating_matches_reference_transcription
        priors = np.asarray(JG.random_rotations(jax.random.PRNGKey(1), 60), np.float32)
        return np.random.RandomState(0).rand(12, 60).astype(np.float32), priors
    if case == "one_view_many_ties":  # test_gating_smooth_trajectory_follows
        scores = np.full((5, 40), 0.1, np.float32)
        scores[:, 7] = 0.9
        return scores, np.asarray(JG.random_rotations(jax.random.PRNGKey(2), 40))
    if case == "rejection":  # test_gating_rejection_falls_back_to_previous

        def rotz(deg):
            c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
            return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

        priors = np.stack([rotz(a) for a in (0, 100, 120, 140, 160, 110, 130)])
        scores = np.array(
            [[1.0, 0.1, 0.2, 0.3, 0.15, 0.12, 0.18], [0.0, 0.9, 0.8, 0.85, 0.7, 0.75, 0.72]],
            np.float32,
        )
        return scores, priors
    # Scores on a coarse grid: the top-10 and the argmax break ties by index.
    rng = np.random.RandomState(3)
    scores = (np.round(rng.rand(10, 30) * 3) / 3).astype(np.float32)
    return scores, np.asarray(JG.random_rotations(jax.random.PRNGKey(4), 30))


@pytest.mark.parametrize("case", ["random", "one_view_many_ties", "rejection", "tied_scores"])
def test_gate_all_frames_matches(case):
    scores, priors = _gating_case(case)
    got_j = JS.gate_all_frames(jnp.asarray(scores), jnp.asarray(priors))
    got_t = TS.gate_all_frames(torch.as_tensor(scores), torch.as_tensor(priors))
    idx_j = np.asarray(got_j.selected_idx)
    np.testing.assert_array_equal(got_t.selected_idx.numpy(), idx_j)
    np.testing.assert_allclose(got_t.rotation_init.numpy(), np.asarray(got_j.rotation_init), atol=1e-6)
    if case == "rejection":
        assert idx_j.tolist() == [0, -1]
    if case == "tied_scores":
        assert (idx_j == -1).any() and (idx_j >= 0).sum() >= 3


def test_gate_frame_steps_match():
    """The sequential API: one step at a time, the caller feeding back a
    refined rotation."""
    priors = np.asarray(JG.random_rotations(jax.random.PRNGKey(3), 20))
    scores = np.random.RandomState(1).rand(20).astype(np.float32)
    refined = np.asarray(JG.random_rotations(jax.random.PRNGKey(4), 1)[0])
    st_j, res_j = JS.gate_frame(JS.initial_state(), jnp.asarray(scores), jnp.asarray(priors))
    st_t, res_t = TS.gate_frame(TS.initial_state(), torch.as_tensor(scores), torch.as_tensor(priors))
    assert int(res_t.selected_idx) == int(res_j.selected_idx) == int(np.argmax(scores))
    st_j = st_j._replace(prev_rotation=jnp.asarray(refined))
    st_t = st_t._replace(prev_rotation=torch.as_tensor(refined))
    _, res_j = JS.gate_frame(st_j, jnp.asarray(scores), jnp.asarray(priors))
    _, res_t = TS.gate_frame(st_t, torch.as_tensor(scores), torch.as_tensor(priors))
    assert int(res_t.selected_idx) == int(res_j.selected_idx)
    np.testing.assert_allclose(res_t.rotation_init.numpy(), np.asarray(res_j.rotation_init), atol=1e-6)


class _Recorder:
    """Wraps a module's prior_scores_batched and keeps the rotations each
    call scored (the rescored union is the second call's)."""

    def __init__(self, fn):
        self.fn, self.rotations = fn, []

    def __call__(self, *args, **kw):
        self.rotations.append(np.asarray(args[6]))
        return self.fn(*args, **kw)


def _run_chain(pkg, prior_mod, sel_mod, cam, bbox, to, params, dcfg, mesh, rots, crops, masks, **kw):
    """frame features -> two-stage scores -> gating -> autodepth through
    one package; returns its outputs and what it printed."""
    verts, faces, face_uvs, texture = (to(x) for x in mesh)
    cfg = prior_mod.PriorConfig(
        num_views=len(rots), view_chunk=8, crop_size=64, render_h=192, render_w=192,
        max_faces_per_tile=5000, dino_dtype="float32",
    )
    radius, _ = prior_mod.mesh_radius_center(verts)
    window = prior_mod.compute_window(
        cfg, float(prior_mod.mesh_norm_radius(verts)), float(cfg.distance_scale * radius)
    )
    rec = _Recorder(prior_mod.prior_scores_batched)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prior_mod.prior_scores_batched = rec
        try:
            gt, cm = prior_mod.frame_gt_features(params, dcfg, to(crops), to(masks), "float32", **kw)
            scores = prior_mod.prior_scores_two_stage(
                params, dcfg, verts, faces, face_uvs, texture, to(rots), to(crops), to(masks),
                gt, cm, cfg, window, prescreen_edge=28, prescreen_scale=2, topk=4, **kw,
            )
        finally:
            prior_mod.prior_scores_batched = rec.fn
    rots_row = to(np.ascontiguousarray(np.swapaxes(rots, -1, -2)))
    gate = sel_mod.gate_all_frames(scores, rots_row)
    K = cam.intrinsics_from_image(64, 64, **kw)
    if pkg == "torch":
        box = bbox.mask_tight_bbox_xyxy(to(masks) > 0, pad=5.0)  # batched
        pts, K_b = verts @ gate.rotation_init, K.expand(len(masks), 3, 3)
    else:
        box = jax.vmap(lambda m: bbox.mask_tight_bbox_xyxy(m, pad=5.0))(to(masks) > 0)
        pts = jnp.einsum("vj,bjk->bvk", verts, gate.rotation_init)
        K_b = jnp.broadcast_to(K, (len(masks), 3, 3))
    trans = cam.tco_init_from_boxes_autodepth(bbox.bbox_xy_to_wh(box), pts, K_b)
    return {
        "gt": np.asarray(gt), "cos_masks": np.asarray(cm), "scores": np.asarray(scores),
        "union": rec.rotations[1], "idx": np.asarray(gate.selected_idx),
        "rot": np.asarray(gate.rotation_init), "trans": np.asarray(trans),
        "printed": out.getvalue(),
    }


_VIT = dict(patch_size=14, embed_dim=32, depth=1, num_heads=2, pos_grid=4, smaller_edge_size=56)


@functools.lru_cache(maxsize=1)
def _chain_inputs():
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = np.asarray(JG.center_and_normalize_verts(jnp.asarray(m.verts)))
    mesh = (verts, np.asarray(m.faces), np.asarray(m.face_uvs), np.asarray(m.texture))
    params_j = JD.init_params(jax.random.PRNGKey(0), JD.DinoConfig(**_VIT))
    params_t = TD.params_from_jax(jax.tree.map(np.asarray, params_j))
    rots = np.asarray(JG.random_rotations(jax.random.PRNGKey(1), 24))
    crops = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (2, 3, 64, 64)))
    masks = np.zeros((2, 64, 64), np.float32)
    masks[0, 16:48, 16:48] = 1.0
    masks[1, 10:50, 20:44] = 1.0
    masks[1, 30:34, :] = -1.0  # an occluder row: excluded from the cosine mask
    return params_j, params_t, (mesh, rots, crops, masks)


def _torch_chain(attn_impl):
    _, params_t, args = _chain_inputs()
    return _run_chain(
        "torch", TP, TS, TC, TB, torch.as_tensor, params_t,
        TD.DinoConfig(attn_impl=attn_impl, **_VIT), *args, device="cpu",
    )


@pytest.fixture(scope="module")
def chains():
    params_j, _, args = _chain_inputs()
    jax_out = _run_chain(
        "jax", JP, JS, JC, JB, jnp.asarray, params_j, JD.DinoConfig(**_VIT), *args
    )
    return jax_out, _torch_chain("xla")


def test_slice_frame_features_and_counted_caps(chains):
    j, t = chains
    np.testing.assert_allclose(t["gt"], j["gt"], atol=1e-5)
    np.testing.assert_array_equal(t["cos_masks"], j["cos_masks"])
    caps = [ln for ln in j["printed"].splitlines() if "per-tile face cap" in ln]
    assert len(caps) == 2 and "overflow" not in j["printed"]
    assert t["printed"] == j["printed"]


def test_slice_scores_and_rescored_union(chains):
    j, t = chains
    np.testing.assert_array_equal(t["union"], j["union"])
    assert 4 <= len(j["union"]) < 24  # the prescreen pruned
    np.testing.assert_allclose(t["scores"], j["scores"], atol=1e-5)


def test_slice_gating_and_translation_init(chains):
    j, t = chains
    np.testing.assert_array_equal(t["idx"], j["idx"])
    assert (j["idx"] >= 0).all()
    np.testing.assert_allclose(t["rot"], j["rot"], atol=1e-6)
    np.testing.assert_allclose(t["trans"], j["trans"], atol=1e-4)
    assert np.isfinite(t["trans"]).all() and (t["trans"][:, 2] > 0).all()


def test_slice_with_flash_attention(chains, monkeypatch):
    """The port's chain with ``attn_impl="flash"`` against the JAX chain;
    every ViT call of it, the prescreen's included, goes through the flash
    attention."""
    from dynhor_tpu_torch.models import dino as dino_mod

    calls = []
    real = dino_mod.flash_attention

    def counting(q, k, v, sm_scale):
        calls.append(q.shape[2])
        return real(q, k, v, sm_scale)

    monkeypatch.setattr(dino_mod, "flash_attention", counting)
    j, _ = chains
    t = _torch_chain("flash")
    # Tokens: 4 x 4 + cls at the full edge 56, 2 x 2 + cls at the prescreen's 28.
    assert set(calls) == {17, 5}
    np.testing.assert_allclose(t["gt"], j["gt"], atol=1e-5)
    np.testing.assert_array_equal(t["union"], j["union"])
    np.testing.assert_allclose(t["scores"], j["scores"], atol=1e-5)
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_allclose(t["trans"], j["trans"], atol=1e-4)
