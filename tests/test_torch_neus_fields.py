"""The port's NeuS fields (``dynhor_tpu_torch/neus/fields.py``) against the
JAX package's, at tests/test_neus.py's small widths (``_small_cfg``).

Held: with the JAX package's parameters carried across by
``params_from_jax``, the SDF, the feature and the colour within 1e-5
(PE and hash); the hash grid's table rows exactly equal, including points
on cell corners and at x01 = 0 and 1 (the JAX rows read by a recording
table passed to its own ``hash_encode``); ``sdf_grad`` within 1e-5 in
"analytic" and "forward", 1e-4 in "numerical" (a difference of two SDF
values over 2 eps = 4e-3: one ulp of the SDF is 3e-5 there); the init with
the JAX package's draws injected (the key tree rebuilt from each draw's
path) equal to ``init_field_params`` bit for bit; and the port's own init
(torch draws) passing ``test_geometric_init_approximates_sphere``'s checks
with the reference init's structure.

The helpers here (the small config, the JAX draw provider) serve the other
``test_torch_neus_*`` files too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.neus import fields as JF
from dynhor_tpu_torch.neus import draws as TDR
from dynhor_tpu_torch.neus import fields as TF

SMALL = dict(
    pe_freqs=4, hidden=64, depth=4, skip_layer=2, feat_dim=32, color_hidden=64, color_depth=3,
    hash_levels=4, hash_table_size=2**12, hash_base_res=4, hash_max_res=32,
    hash_hidden=32, hash_depth=2,
)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """Many small ops: under the suite's parallel workers torch's intra-op
    threads oversubscribe the cores, so torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfgs(encoder="pe", **kw):
    return (JF.SDFConfig(encoder=encoder, **SMALL, **kw),
            TF.SDFConfig(encoder=encoder, **SMALL, **kw))


def jax_key(seed, path):
    """The JAX key at a port ``Key``'s path."""
    k = jax.random.PRNGKey(seed)
    for step in path:
        k = jax.random.split(k, step[1])[step[2]] if step[0] == "split" else (
            jax.random.fold_in(k, step[1]))
    return k


def jax_draw(key, kind, shape, low=0.0, high=1.0):
    """``draws.draw`` with the JAX package's values: the draw ``jax.random``
    makes at the key the path names."""
    k, shape = jax_key(key.seed, key.path), tuple(int(s) for s in shape)
    if kind == "uniform":
        v = jax.random.uniform(k, shape, minval=low, maxval=high)
    elif kind == "normal":
        v = jax.random.normal(k, shape)
    else:
        v = jax.random.randint(k, shape, int(low), int(high))
        return torch.from_numpy(np.asarray(v)).long().to(key.device)
    return torch.from_numpy(np.array(v)).to(key.device)


@pytest.fixture()
def jax_draws(monkeypatch):
    monkeypatch.setattr(TDR, "draw", jax_draw)


def pair(encoder="pe", seed=0, **kw):
    """(JAX params, JAX cfg, port field with those parameters)."""
    jc, tc = small_cfgs(encoder, **kw)
    jp = JF.init_field_params(jax.random.PRNGKey(seed), jc)
    field = TF.NeuSField(tc)
    field.load_state_dict(TF.params_from_jax(jp))
    return jp, jc, field


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _points(n=64, seed=0):
    return np.random.RandomState(seed).uniform(-0.95, 0.95, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("encoder", ["pe", "hash"])
def test_sdf_feat_colour_match_jax(encoder):
    jp, jc, field = pair(encoder)
    x = _points()
    js, jf = jax.jit(lambda p, x: JF.sdf_forward(p, x, jc))(jp, jnp.asarray(x))
    ts, tf = TF.sdf_forward(field, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(tf), _np(jf), atol=1e-5, rtol=0)
    rng = np.random.RandomState(1)
    d = rng.randn(64, 3).astype(np.float32)
    nrm = rng.randn(64, 3).astype(np.float32)
    jcol = jax.jit(lambda p, *a: JF.color_forward(p, *a, jc))(
        jp["color"], jnp.asarray(x), jnp.asarray(d), jnp.asarray(nrm), jf)
    tcol = field.color(torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(nrm),
                       torch.from_numpy(np.asarray(jf)))
    np.testing.assert_allclose(_np(tcol), _np(jcol), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(TF.inv_std(field.variance)),
                               float(JF.inv_std(jp["variance"])), rtol=1e-6)


class _RecordingTable:
    """Passed to the JAX ``hash_encode`` as its table: records the rows it
    gathers (``flat_table[idx]``) and returns zeros."""

    def __init__(self, n_features):
        self.rows, self.f = [], n_features

    def reshape(self, *shape):
        return self

    def __getitem__(self, idx):
        self.rows.append(np.asarray(idx))
        return jnp.zeros(idx.shape + (self.f,))


def test_hash_indices_exactly_jax():
    jc, tc = small_cfgs("hash")
    res = JF.hash_level_resolutions(jc)
    rng = np.random.RandomState(0)
    pts = [rng.uniform(0, 1, (40, 3)), np.zeros((1, 3)), np.ones((1, 3)),
           np.array([[0.0, 1.0, 0.5], [1.0, 0.0, 1.0]])]
    for r in res:  # points on cell corners and faces of every level
        k = rng.randint(0, r + 1, (6, 3))
        pts.append(k / r)
        pts.append(np.concatenate([k[:, :1] / r, rng.uniform(0, 1, (6, 2))], axis=1))
    x01 = np.concatenate(pts).astype(np.float32)
    rec = _RecordingTable(jc.hash_features)
    JF.hash_encode(rec, jnp.asarray(x01), jc)
    rows, weights = TF.hash_indices(torch.from_numpy(x01), tc)
    assert len(rec.rows) == len(rows) == 8
    for ci, (a, b) in enumerate(zip(rows, rec.rows)):
        np.testing.assert_array_equal(a.numpy(), b.astype(np.int64), err_msg=f"corner {ci}")
    # And the encoding itself through a real table.
    table = jax.random.uniform(jax.random.PRNGKey(3), (jc.hash_levels, jc.hash_table_size, 2))
    je = JF.hash_encode(table, jnp.asarray(x01), jc)
    te = TF.hash_encode(torch.from_numpy(np.asarray(table)), torch.from_numpy(x01), tc)
    np.testing.assert_allclose(_np(te), _np(je), atol=1e-6, rtol=0)


@pytest.mark.parametrize("encoder", ["pe", "hash"])
@pytest.mark.parametrize("mode,tol", [("analytic", 1e-5), ("forward", 1e-5), ("numerical", 1e-4)])
def test_sdf_grad_modes_match_jax(encoder, mode, tol):
    jp, jc, field = pair(encoder, grad_mode=mode)
    x = _points(48, seed=2)
    jg = jax.jit(lambda p, x: JF.sdf_grad(p, x, jc))(jp, jnp.asarray(x))
    tg = TF.sdf_grad(field, torch.from_numpy(x))
    np.testing.assert_allclose(_np(tg), _np(jg), atol=tol, rtol=0)


@pytest.mark.parametrize("encoder", ["pe", "hash"])
def test_sdf_grad_keeps_the_graph_for_the_eikonal(encoder):
    """The analytic gradient is differentiated again (Eikonal): its
    parameter gradient matches jax.grad of the same Eikonal sum.  The hash
    field's init is nearly the sphere |x| - r (a 1e-4 table under a x0.01
    layer), where |grad| - 1 is rounding noise; its table and last layer
    are scaled up so that the MLP's part of the gradient carries weight."""
    jp, jc, field = pair(encoder)
    if encoder == "hash":
        jp["sdf"]["table"] = jax.random.uniform(jax.random.PRNGKey(5), jp["sdf"]["table"].shape,
                                                minval=-0.5, maxval=0.5)
        jp["sdf"]["mlp"][-1]["w"] = 100.0 * jp["sdf"]["mlp"][-1]["w"]
        field.load_state_dict(TF.params_from_jax(jp))
    x = _points(32, seed=3)

    def jeik(p):
        g = JF.sdf_grad(p, jnp.asarray(x), jc)
        return jnp.sum((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2)

    jgrad = TF.params_from_jax(jax.jit(jax.grad(jeik))(jp))
    g = TF.sdf_grad(field, torch.from_numpy(x))
    torch.sum((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).backward()
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in field.named_parameters()}  # None: off the gradient's path
    nonzero = 0
    for name, want in jgrad.items():
        if name.startswith("color") or name == "variance":
            continue  # not on the SDF's path
        scale = float(want.abs().max())
        nonzero += scale > 0
        np.testing.assert_allclose(got[name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-6), err_msg=name)
    assert nonzero >= 3


@pytest.mark.parametrize("encoder", ["pe", "hash"])
def test_injected_init_is_jax_init(encoder, jax_draws):
    jc, tc = small_cfgs(encoder)
    want = TF.params_from_jax(JF.init_field_params(jax.random.PRNGKey(0), jc))
    got = TF.NeuSField(tc, TDR.Key(0)).state_dict()
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_own_init_approximates_sphere_with_the_reference_structure():
    """tests/test_neus.py::test_geometric_init_approximates_sphere's checks
    on the port's own init (torch draws), then its structure."""
    _, tc = small_cfgs("pe")
    field = TF.NeuSField(tc, TDR.Key(0))
    with torch.no_grad():
        s, _ = TF.sdf_forward(field, torch.tensor([[0.0, 0, 0], [0.9, 0, 0], [0, 0.9, 0]]))
        assert float(s[0]) < 0.0 and float(s[1]) > 0.0 and float(s[2]) > 0.0
        xs = torch.linspace(0, 1, 101)
        line = torch.stack([xs, torch.zeros_like(xs), torch.zeros_like(xs)], dim=-1)
        sl, _ = TF.sdf_forward(field, line)
        assert 0.25 < float(xs[torch.argmin(sl.abs())]) < 0.75
    in_dim = 3 + 3 * 2 * tc.pe_freqs
    assert bool((field.sdf.layers[0].weight[:, 3:] == 0).all())
    assert bool((field.sdf.layers[0].weight[:, :3] != 0).all())
    skip = field.sdf.layers[tc.skip_layer].weight
    assert skip.shape[1] == tc.hidden + in_dim
    assert bool((skip[:, tc.hidden + 3:] == 0).all())
    assert bool((field.sdf.out.weight[0] > 0).all())  # |N| column
    assert float(field.sdf.out.bias[0]) == -tc.geometric_init_radius
    assert bool((field.sdf.out.bias[1:] == 0).all())
    assert float(field.variance) == pytest.approx(0.3)
    _, th = small_cfgs("hash")
    hfield = TF.NeuSField(th, TDR.Key(0))
    assert float(hfield.sdf.table.abs().max()) <= 1e-4
    assert float(hfield.sdf.table.abs().max()) > 5e-5
    last, first = hfield.sdf.mlp[-1].weight, hfield.sdf.mlp[0].weight
    assert float(last.std()) < 0.05 * float(first.std())  # the x0.01 final layer
    with torch.no_grad():
        sh, _ = TF.sdf_forward(hfield, line)
    np.testing.assert_allclose(_np(sh), _np(line[:, 0] - 0.5), atol=0.05)


def test_params_from_jax_round_trips_every_leaf():
    for encoder in ("pe", "hash"):
        jp, jc, field = pair(encoder)
        n_leaves = len(jax.tree_util.tree_leaves(jp))
        assert len(field.state_dict()) == n_leaves
        cfg = dataclasses.replace(jc)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(field.cfg)
