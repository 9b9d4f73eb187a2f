"""K6's plain versions (``ops/gather.py``) on the probe's forms
(``dynhor_tpu_torch/tools/probe_gather.make_forms``) vs the jnp expression
that each form's Pallas kernel body computes in tools/probe_pallas_gather.py
(``jnp.take``, ``jnp.take_along_axis``, ``.at[].add``), outside Pallas: the
probe's ``pallas_call``s have no interpret switch and run only on a TPU.
Gathers exactly; the scatter-add of form H (a few terms per cell) within
rtol 1e-6 and atol 1e-6, at the hash backward's shape (about 32 terms per
cell) within 1e-5: f32 sums in another order.  Indices are in range, as the
kernels require.

The ``cuda`` cases hold the kernels against the plain versions on the CPU
at the edges of their forms (skipped without a card): a width not a
multiple of 4 or 2, a strided source (``tab[:, :2]``), zero-stride indices
(one index per row, one lane row for all rows), no rows, every index on
one row (the worst contention), on both axes; and the scatter-add on each
of its two paths.  Gathers exactly; the scatter-add's "columns" path
exactly (it sums in row order, as the CPU does), its "atomic" path, which
sums in an order that changes from run to run, within
1e-5 + 1e-6 x the sum of the entry's |terms| (an f32 sum of many terms
moves by a few units of 2^-24 x that sum when its order changes: 1.1e-3
on an entry of 40,000 terms on an H100).

JAX is imported inside the cases that use it, so that the ``cuda`` cases
run on a machine with no JAX (``pytest --noconftest -m cuda``).
"""
import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import gather as OG
from dynhor_tpu_torch.tools import probe_gather as PG

FORMS = {f["key"]: f for f in PG.make_forms("cpu")}


def _reference(form):
    """The jnp expression of the form's kernel body (kern_a ... kern_h)."""
    import jax
    import jax.numpy as jnp

    idx = jnp.asarray(form["idx"])
    key = form["key"]
    if key == "A":
        return jnp.take(jnp.asarray(form["src"]), idx, axis=0)
    if key == "B":
        return jnp.take(jnp.asarray(form["src"]).reshape(-1), idx.reshape(-1), axis=0).reshape(1, -1)
    if key == "D":  # o[j, :] = t[i[0, j], :] for j < 8
        return jnp.stack([jnp.asarray(form["src"])[idx[j], :] for j in range(8)])
    if key in ("C", "G"):
        return jnp.take_along_axis(jnp.asarray(form["src"]), idx, axis=1)
    if key == "H":
        z = jnp.zeros((form["rows"], 128), jnp.float32)
        lanes = jax.lax.broadcasted_iota(jnp.int32, idx.shape, 1)
        return z.at[idx, lanes].add(jnp.asarray(form["g"]))
    return jnp.take_along_axis(jnp.asarray(form["src"]), idx, axis=0)  # E, F


@pytest.mark.parametrize("key", list(FORMS))
def test_form_matches_the_kernel_body(key):
    form = FORMS[key]
    got = PG.apply(form).numpy()
    want = np.asarray(_reference(form))
    assert got.shape == want.shape
    if form["op"] == "take":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_timed_shapes_match_the_jax_baselines():
    """The timed per-lane gather, the row-gather baseline and the
    scatter-add baseline of the JAX tool, at its shapes."""
    import jax.numpy as jnp

    tab, idx, flat, g = PG._timed_inputs("cpu")
    tab_j, flat_j = jnp.asarray(tab.numpy()), jnp.asarray(flat.numpy())
    np.testing.assert_array_equal(
        OG.take_along_axis(tab, idx, 0).numpy(),
        np.asarray(jnp.take_along_axis(tab_j, jnp.asarray(idx.numpy()), axis=0)),
    )
    flat2 = flat[:, None].expand(-1, 2)
    np.testing.assert_array_equal(
        OG.take_along_axis(tab[:, :2], flat2, 0).numpy(),
        np.asarray(jnp.take(tab_j[:, :2], flat_j, axis=0)),
    )
    want = np.asarray(jnp.zeros((PG.T, 2), jnp.float32).at[flat_j].add(jnp.asarray(g.numpy())))
    np.testing.assert_allclose(OG.scatter_add_axis0(g, flat2, PG.T).numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    src = torch.zeros((4, 4))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.take_along_axis(src, idx, 0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scatter_add_axis0(src, idx, 4)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _edge_take(case):
    """(src, idx, axis) on the CPU for a gather edge case."""
    rng = np.random.default_rng(11)
    tab = torch.as_tensor(rng.standard_normal((300, 128)).astype(np.float32))

    def ints(hi, shape):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32))

    if case == "width7":
        return tab[:, :7], ints(300, (41, 7)), 0
    if case == "width6-axis1":
        return tab[:41], ints(128, (41, 6)), 1
    if case == "strided-src":
        return tab[:, :2], ints(300, (77, 2)), 0
    if case == "strided-src-rows":
        return tab[:, 1:9], ints(300, (77,))[:, None].expand(77, 8), 0
    if case == "zero-stride-rows":
        return tab, ints(300, (65,))[:, None].expand(65, 128), 0
    if case == "zero-stride-lanes":
        return tab, ints(300, (1, 128)).expand(33, 128), 0
    if case == "axis1-rows":
        return tab[:50], ints(128, (50,))[:, None].expand(50, 12), 1
    if case == "no-rows":
        return tab, ints(300, (0, 128)), 0
    if case == "one-row":
        return tab, torch.full((513, 128), 299, dtype=torch.int32), 0
    raise ValueError(case)


TAKE_EDGES = ["width7", "width6-axis1", "strided-src", "strided-src-rows", "zero-stride-rows",
              "zero-stride-lanes", "axis1-rows", "no-rows", "one-row"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TAKE_EDGES)
def test_gather_edges_on_the_card(cuda, case):
    src, idx, axis = _edge_take(case)
    want = OG.take_along_axis_plain(src, idx, axis)
    before = kernels.take_along_axis.launches
    got = kernels.take_along_axis(src.to(cuda), idx.to(cuda), axis)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got.cpu(), want)
    assert kernels.take_along_axis.launches == before + (1 if idx.numel() else 0)


def _edge_scatter(case):
    """(g, idx, n_rows, path) on the CPU for a scatter-add edge case."""
    rng = np.random.default_rng(12)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    def ints(hi, shape):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32))

    if case == "columns-width5":
        return normal(300, 5), ints(40, (300, 5)), 40, 0
    if case == "columns-one-row":
        return normal(2048, 128), torch.full((2048, 128), 7, dtype=torch.int32), 512, 0
    if case == "columns-zero-stride":
        return normal(100, 3), ints(9, (100,))[:, None].expand(100, 3), 9, 0
    if case == "atomic-hash":
        return normal(5000, 2), ints(8192, (5000,))[:, None].expand(5000, 2), 8192, 1
    if case == "atomic-one-row":
        return normal(40000, 2), torch.zeros((40000, 2), dtype=torch.int32), 8192, 1
    if case == "atomic":
        return normal(3000, 16), ints(5000, (3000, 16)), 5000, 1
    if case == "no-rows":
        return normal(0, 4), ints(1, (0, 4)), 6, 0
    raise ValueError(case)


SCATTER_EDGES = ["columns-width5", "columns-one-row", "columns-zero-stride", "atomic-hash",
                 "atomic-one-row", "atomic", "no-rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCATTER_EDGES)
def test_scatter_edges_on_the_card(cuda, case):
    g, idx, rows, path = _edge_scatter(case)
    assert kernels.scatter_plan(g.shape[0], rows) == path
    want = OG.scatter_add_axis0_plain(g, idx, rows)
    got = kernels.scatter_add_axis0(g.to(cuda), idx.to(cuda), rows)
    again = kernels.scatter_add_axis0(g.to(cuda), idx.to(cuda), rows)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    if path == 0:
        assert torch.equal(got.cpu(), want) and torch.equal(again, got)
    else:
        mag = OG.scatter_add_axis0_plain(g.abs(), idx, rows)
        assert bool(((got.cpu() - want).abs() <= 1e-5 + 1e-6 * mag).all())


def test_scatter_plan_paths():
    """The wrapper's choice of path, from the shapes alone (no card)."""
    assert kernels.scatter_plan(256, 512) == 0  # form H
    assert kernels.scatter_plan(2048, 4096) == 0
    assert kernels.scatter_plan(262144, 8192) == 1  # the hash backward
    assert kernels.scatter_plan(2049, 512) == 1
    assert kernels.scatter_plan(2048, 4097) == 1
    assert kernels.scatter_plan(3000, 5000) == 1
