"""The port's plain soft silhouettes and tiled rasterizers vs the JAX
package, on the shoes mesh at 64² (two frames) and the box mesh of
tests/test_refine_jointopt.py:

  * ``soft_silhouette`` (dense) and ``silhouette_straight_through``
    against ``dynhor_tpu.ops.silhouette``;
  * ``soft_silhouette_tiled`` and ``rasterize_tiled`` against
    ``dynhor_tpu.ops.rasterize_tiled``;
  * ``resize_bicubic_align_corners``.

``soft_silhouette_kernel`` (K4a/K4b) is held against the JAX package in
tests/test_torch_silhouette_kernel.py.

Tolerances, those tests/test_torch_raster.py uses for the fused raster:
silhouettes, depths and barycentrics within 1e-5; d(verts) within rtol 1e-4
and atol 1e-5 x max|d(verts)| (f32 sums in another order); pix_to_face
exact.  The resize within 1e-5 (the same matrices, sums in another order).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.ops import rasterize as JZ
from dynhor_tpu.ops import rasterize_tiled as JT
from dynhor_tpu.ops import resize as JRS
from dynhor_tpu.ops import silhouette as JS
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils.objio import load_obj
from dynhor_tpu_torch.ops import rasterize_tiled as TT
from dynhor_tpu_torch.ops import resize as TRS
from dynhor_tpu_torch.ops import silhouette as TS

sys.path.insert(0, str(Path(__file__).parent))
from test_refine_jointopt import _K, _mesh  # noqa: E402

S = 64
MARGIN = 6.0 * 0.25 + 1.0


@pytest.fixture(scope="module")
def shoes():
    """Two views of the shoes mesh filling most of a 64² crop, every third
    face of it (1,667 of 5,000, so that the counted cap spans a few
    128-face chunks and the JAX side compiles in seconds), the cap counted
    at the silhouette margin (not a multiple of 128)."""
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = JG.center_and_normalize_verts(jnp.asarray(m.verts))
    K = jnp.array([[S * 1.2, 0, S / 2], [0, S * 1.2, S / 2], [0, 0, 1.0]])
    vps = []
    for seed in (0, 1):
        R = JG.random_rotations(jax.random.PRNGKey(seed), 1)[0]
        vps.append(np.asarray(JZ.project_perspective(verts @ R + jnp.array([0.0, 0.0, 2.0]), K)))
    faces = np.asarray(m.faces)[::3]
    cap = max(int(JT.max_tile_load(jnp.asarray(v), faces, (S, S), margin=MARGIN)) for v in vps)
    assert cap % 128
    return np.stack(vps), faces, cap


def _weight(size):
    return np.cos(np.arange(size * size, dtype=np.float32).reshape(size, size) * 0.01)


def _pair(fn_j, fn_t, vps, faces, size):
    """Values and d(sum(out * weight))/d(verts) of both packages, the JAX
    side per frame, the port's batched."""
    w = _weight(size)
    outs_j, grads_j = [], []
    fj = jnp.asarray(faces)
    for vp in vps:
        x = jnp.asarray(vp)
        outs_j.append(np.asarray(fn_j(x, fj)))
        grads_j.append(np.asarray(jax.grad(lambda v: (fn_j(v, fj) * w).sum())(x)))
    v = torch.tensor(vps).requires_grad_(True)
    out_t = fn_t(v, torch.tensor(faces))
    (out_t * torch.tensor(w)).sum().backward()
    return np.stack(outs_j), np.stack(grads_j), out_t.detach().numpy(), v.grad.numpy()


def _assert_close(out_j, g_j, out_t, g_t):
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    assert np.abs(g_j).sum() > 1.0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-5 * np.abs(g_j).max())


def test_dense_soft_silhouette_matches(shoes):
    vps, faces, _ = shoes
    _assert_close(*_pair(
        lambda v, f: JS.soft_silhouette(v, f, (S, S), face_chunk=512),
        lambda v, f: TS.soft_silhouette(v, f, (S, S), face_chunk=700),
        vps, faces, S,
    ))


def test_straight_through_matches():
    mesh = _mesh()
    vps = np.stack([
        np.asarray(JZ.project_perspective(mesh.verts @ JG.random_rotations(jax.random.PRNGKey(k), 1)[0]
                                          + jnp.array([0.0, 0.0, 2.0]), _K()))
        for k in (0, 1)
    ])
    out_j, g_j, out_t, g_t = _pair(
        lambda v, f: JS.silhouette_straight_through(v, f, (S, S), face_chunk=12),
        lambda v, f: TS.silhouette_straight_through(v, f, (S, S), face_chunk=12),
        vps, np.asarray(mesh.faces), S,
    )
    np.testing.assert_array_equal(out_t, out_j)  # the hard mask
    assert set(np.unique(out_t)) == {0.0, 1.0}
    np.testing.assert_allclose(g_t, g_j, rtol=1e-4, atol=1e-5 * np.abs(g_j).max())


def test_tiled_soft_silhouette_matches(shoes):
    vps, faces, cap = shoes
    _assert_close(*_pair(
        lambda v, f: JT.soft_silhouette_tiled(v, f, (S, S), max_faces=cap),
        lambda v, f: TT.soft_silhouette_tiled(v, f, (S, S), max_faces=cap, tile_chunk=5),
        vps, faces, S,
    ))


@pytest.mark.parametrize("size", [(S, S), (40, 56)])
def test_rasterize_tiled_matches(shoes, size):
    vps, faces, cap = shoes  # the margin-0 loads are at most the margin's
    frags_j = [JT.rasterize_tiled(jnp.asarray(v), jnp.asarray(faces), size, max_faces=cap) for v in vps]
    v = torch.tensor(vps).requires_grad_(True)
    frag_t = TT.rasterize_tiled(v, torch.tensor(faces), size, max_faces=cap, tile_chunk=3)
    p2f = np.stack([np.asarray(f.pix_to_face) for f in frags_j])
    np.testing.assert_array_equal(frag_t.pix_to_face.numpy(), p2f)
    assert (p2f >= 0).any() and (p2f < 0).any()
    np.testing.assert_allclose(frag_t.zbuf.detach().numpy(), np.stack([np.asarray(f.zbuf) for f in frags_j]), atol=1e-5)
    np.testing.assert_allclose(frag_t.bary.detach().numpy(), np.stack([np.asarray(f.bary) for f in frags_j]), atol=1e-5)
    if size != (S, S):
        return
    # d(zbuf + bary) / d(verts): the selected depth's gradient.
    w = _weight(S)
    (frag_t.zbuf * torch.tensor(w)).sum().backward(retain_graph=True)
    frag_t.bary.sum().backward()
    for b, vp in enumerate(vps):
        g = jax.grad(lambda x: ((lambda f: (f.zbuf * w).sum() + f.bary.sum())(
            JT.rasterize_tiled(x, jnp.asarray(faces), size, max_faces=cap))))(jnp.asarray(vp))
        g = np.asarray(g)
        np.testing.assert_allclose(v.grad[b].numpy(), g, rtol=1e-4, atol=1e-5 * np.abs(g).max())


def test_resize_bicubic_align_corners_matches():
    x = np.random.default_rng(3).random((2, 3, 64, 48), dtype=np.float32)
    for out in ((518, 518), (32, 100)):
        got = TRS.resize_bicubic_align_corners(torch.tensor(x), *out).numpy()
        want = np.asarray(JRS.resize_bicubic_align_corners(jnp.asarray(x), *out))
        np.testing.assert_allclose(got, want, atol=1e-5)
