"""The port's NeuS renderer (``dynhor_tpu_torch/neus/rendering.py``) against
the JAX package's, on tests/test_neus.py's small field.

Held: ``rays_from_pose`` within 1e-6; ``sample_pdf`` with its uniforms
injected (the JAX draw at the same key) within 1e-5; the shade selection's
order on zero-weight ties equal to ``jax.lax.top_k``'s (the lower index
first, where ``torch.topk`` is not) and on weights under f32's smallest
normal number (XLA flushes them to 0); ``render_rays`` with the classic
sampler, dense (``n_shade`` 0) and compacted (``n_shade`` 8, most section
weights exactly 0), the stratified and importance draws injected: the
same selected sections as the JAX render's ``top_k`` (recorded), every
output within 1e-4, the parameter gradients of a sum over every output
within rtol 1e-4 and 1e-4 x the largest entry; the occupancy grid equal
to the JAX package's except cells whose |sdf| lies within 1e-6 of tau
(listed), and the occgrid render within 1e-4 with its draws injected.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.neus import fields as JF
from dynhor_tpu.neus import rendering as JR
from dynhor_tpu_torch.neus import draws as TDR
from dynhor_tpu_torch.neus import fields as TF
from dynhor_tpu_torch.neus import rendering as TR

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_neus_fields import _np, jax_draws, pair  # noqa: E402,F401

K = np.array([[100.0, 0, 50], [0, 100.0, 50], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(seed):
    q = np.random.RandomState(seed).randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _rays(n=24, seed=1):
    px = np.random.RandomState(seed).uniform(10, 90, (n, 2)).astype(np.float32)
    R, T = _rot(seed), np.array([0.1, -0.05, 2.0], np.float32)
    jr = JR.rays_from_pose(jnp.asarray(px), jnp.asarray(K), jnp.asarray(R), jnp.asarray(T), 1.0)
    tr = TR.rays_from_pose(torch.from_numpy(px), torch.from_numpy(K), torch.from_numpy(R),
                           torch.from_numpy(T), 1.0)
    return jr, tr


def _sharp_pair(inv_s=200.0):
    """The small PE field at inv_s 200: weights concentrate at the sphere,
    so most sections weigh exactly 0 (clipped alphas, and transmittance
    flushed behind the surface)."""
    jp, jc, field = pair("pe")
    jp = dict(jp)
    jp["variance"] = jnp.log(inv_s) / 10.0
    field.load_state_dict(TF.params_from_jax(jp))
    return jp, jc, field


def test_rays_from_pose_matches_jax():
    for seed in range(3):
        jr, tr = _rays(seed=seed)
        for name, a, b in zip(jr._fields, jr, tr):
            np.testing.assert_allclose(_np(b), _np(a), atol=1e-6, rtol=0, err_msg=name)
    # One pose per ray (the trainer's form) equals the shared-pose form.
    _, tr = _rays(seed=4)
    px = torch.from_numpy(np.random.RandomState(4).uniform(10, 90, (24, 2)).astype(np.float32))
    R = torch.from_numpy(_rot(4))
    T = torch.tensor([0.1, -0.05, 2.0])
    per = TR.rays_from_pose(px, torch.from_numpy(K), R.expand(24, 3, 3), T.expand(24, 3), 1.0)
    for a, b in zip(tr, per):
        assert torch.equal(a, b)


def test_sample_pdf_with_injected_uniforms(jax_draws):
    rng = np.random.RandomState(0)
    bins = np.sort(rng.uniform(0.5, 3.0, (6, 17)), axis=-1).astype(np.float32)
    w = rng.uniform(0, 1, (6, 16)).astype(np.float32)
    w[:, ::3] = 0.0
    for key in (None, TDR.Key(7).fold_in(2)):
        jkey = None if key is None else jax.random.fold_in(jax.random.PRNGKey(7), 2)
        a = JR.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 24, jkey)
        b = TR.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 24, key)
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-5, rtol=0)


def test_shade_selection_breaks_ties_as_jax_top_k():
    w = np.zeros((3, 64), np.float32)
    w[0, 5], w[0, 40] = 0.3, 0.1
    w[1, [3, 9, 20]] = 0.2  # equal non-zero weights
    w[2, 10], w[2, 11], w[2, 12] = 0.5, 1e-40, 1e-39  # under f32's smallest normal
    got = TR.shade_selection(torch.from_numpy(w), 8).numpy()
    np.testing.assert_array_equal(got[0], [5, 40, 0, 1, 2, 3, 4, 6])
    assert list(torch.topk(torch.from_numpy(w[0]), 8)[1].numpy()) != list(got[0])
    want = np.asarray(jax.lax.top_k(jnp.asarray(np.where(w < 1.1754944e-38, 0.0, w)), 8)[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], [10, 0, 1, 2, 3, 4, 5, 6])


def _loss_weights(n, seed=3):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in
            (("rgb", (n, 3)), ("depth", (n,)), ("acc", (n,)), ("normal", (n, 3)),
             ("points", (n, 3)))}


def _jax_total(out, c):
    return sum(jnp.sum(getattr(out, k) * c[k]) for k in c) + out.eikonal


def _torch_total(out, c):
    return sum(torch.sum(getattr(out, k) * torch.from_numpy(c[k])) for k in c) + out.eikonal


def _check_grads(field, jgrad_tree):
    want = TF.params_from_jax(jgrad_tree)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in field.named_parameters()}
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * max(scale, 1e-12), err_msg=name)


@pytest.mark.parametrize("n_shade,inv_s", [(0, 20.0), (8, 200.0)])
def test_render_rays_classic_matches_jax(n_shade, inv_s, jax_draws, monkeypatch):
    """The dense case runs at the init's inv_s (about 20).  At 200 the sdf
    bias's gradient adds 1,152 section terms of total size 128.8 up to
    0.1325, and f32 sums and sample positions an ulp apart leave each
    package more than 1e-4 of it from the port's f64 value 0.132456 (JAX
    0.132524, the port 0.132232)."""
    jp, jc, field = _sharp_pair(inv_s)
    jr, tr = _rays()
    jrc = JR.RenderConfig(n_coarse=32, n_importance=16, up_sample_steps=2, n_shade=n_shade)
    trc = TR.RenderConfig(**dataclasses.asdict(jrc))
    jkey, tkey = jax.random.fold_in(jax.random.PRNGKey(11), 3), TDR.Key(11).fold_in(3)

    recorded, picked = [], []
    top_k = jax.lax.top_k

    def recording_top_k(x, k):  # JAX's selection, read out of its jitted render
        out = top_k(x, k)
        jax.debug.callback(lambda idx: recorded.append(np.asarray(idx)), out[1])
        return out

    selection = TR.shade_selection

    def spy(w, k):
        picked.append((w.detach().clone(), selection(w, k)))
        return picked[-1][1]

    monkeypatch.setattr(jax.lax, "top_k", recording_top_k)
    monkeypatch.setattr(TR, "shade_selection", spy)
    c = _loss_weights(24)

    def total(p):
        out = JR.render_rays(p, jc, jrc, jr, jkey)
        return _jax_total(out, c), out

    (_, jo), jgrad = jax.jit(jax.value_and_grad(total, has_aux=True))(jp)
    to = TR.render_rays(field, trc, tr, tkey)
    for name, a, b in zip(jo._fields, jo, to):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-4, rtol=0, err_msg=name)
    if n_shade:
        assert len(recorded) >= 1 and len(picked) == 1
        w, sel = picked[0]
        np.testing.assert_array_equal(sel.numpy(), recorded[-1])
        zero_picks = int((torch.gather(w, -1, sel) == 0).sum())
        print(f"selected sections of weight 0 (decided by the tie rule): {zero_picks} of "
              f"{sel.numel()}")
        assert zero_picks > 0
    _torch_total(to, c).backward()
    _check_grads(field, jgrad)


def test_occupancy_grid_and_occgrid_render_match_jax(jax_draws):
    jp, jc, field = _sharp_pair()
    jrc = JR.RenderConfig(sampler="occgrid", occ_res=32, n_candidates=64, n_occ_samples=32,
                          n_shade=8)
    trc = TR.RenderConfig(**dataclasses.asdict(jrc))
    occ_j = np.asarray(jax.jit(lambda p: JR.occupancy_from_sdf(p, jc, jrc))(jp))
    occ_t = TR.occupancy_from_sdf(field, trc)
    differ = np.nonzero(occ_j != occ_t.numpy())[0]
    if len(differ):  # allowed only next to a cell whose |sdf| is within 1e-6 of tau
        r, b = jrc.occ_res, jrc.bound
        centers = (np.arange(r) + 0.5) / r * (2 * b) - b
        pts = np.stack(np.meshgrid(centers, centers, centers, indexing="ij"), -1).reshape(-1, 3)
        sdf = np.asarray(JF.sdf_forward(jp, jnp.asarray(pts, jnp.float32), jc)[0])
        tau = np.float32(2.0 * 2.0 * b / r) * np.float32(np.sqrt(3.0))
        near = np.argwhere((np.abs(np.abs(sdf) - tau) <= 1e-6).reshape(r, r, r))
        print(f"occupancy cells that differ: {differ.tolist()}; cells with |sdf| within 1e-6 "
              f"of tau: {near.tolist()}")
        for cell in np.argwhere((occ_j != occ_t.numpy()).reshape(r, r, r)):
            assert len(near) and np.abs(near - cell).max(axis=1).min() <= 1, cell
    assert occ_t.sum() > 0
    jr, tr = _rays(seed=2)
    jkey, tkey = jax.random.PRNGKey(5), TDR.Key(5)
    jo = jax.jit(lambda p, o: JR.render_rays(p, jc, jrc, jr, jkey, o))(jp, jnp.asarray(occ_j))
    to = TR.render_rays(field, trc, tr, tkey, torch.from_numpy(occ_j))
    for name, a, b in zip(jo._fields, jo, to):
        np.testing.assert_allclose(_np(b), _np(a), atol=1e-4, rtol=0, err_msg=name)
