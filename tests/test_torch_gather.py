"""K6's plain versions (``ops/gather.py``) on the probe's forms
(``dynhor_tpu_torch/tools/probe_gather.make_forms``) vs the jnp expression
that each form's Pallas kernel body computes in tools/probe_pallas_gather.py
(``jnp.take``, ``jnp.take_along_axis``, ``.at[].add``), outside Pallas: the
probe's ``pallas_call``s have no interpret switch and run only on a TPU.
Gathers exactly; the scatter-add of form H (a few terms per cell) within
rtol 1e-6 and atol 1e-6, at the hash backward's shape (about 32 terms per
cell) within 1e-5: f32 sums in another order.  Indices are in range, as the
kernels require.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import gather as OG
from dynhor_tpu_torch.tools import probe_gather as PG

FORMS = {f["key"]: f for f in PG.make_forms("cpu")}


def _reference(form):
    """The jnp expression of the form's kernel body (kern_a ... kern_h)."""
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
