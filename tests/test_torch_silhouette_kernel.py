"""``soft_silhouette_kernel`` (the port of ``soft_silhouette_pallas``; on
the CPU K4a's and K4b's plain versions) vs the JAX package's
``soft_silhouette_pallas`` in interpret mode, as
tests/test_rasterize_tiled.py runs it: the shoes mesh at 64² (two frames,
a counted cap that is not a multiple of 128), a crowded tile (600 faces in
one tile) and an empty view.  Tolerances, those tests/test_torch_raster.py
uses for the fused raster: silhouettes within 1e-5, d(verts) within rtol
1e-4 and atol 1e-5 x max|d(verts)| (f32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import torch

from dynhor_tpu.ops.silhouette_pallas import soft_silhouette_pallas
from dynhor_tpu_torch.ops import silhouette_kernel as TK
from test_torch_silhouette import S, _assert_close, _pair, shoes  # noqa: F401


def test_kernel_silhouette_matches_pallas(shoes):
    vps, faces, cap = shoes
    _assert_close(*_pair(
        lambda v, f: soft_silhouette_pallas(v, f, (S, S), max_faces=cap),
        lambda v, f: TK.soft_silhouette_kernel(v, f, (S, S), max_faces=cap),
        vps, faces, S,
    ))


def test_kernel_silhouette_crowded_tile():
    # 600 tiny triangles binned into ONE tile (the count, 600, is not a
    # multiple of 128), as tests/test_torch_raster.py::crowded.
    rng = np.random.default_rng(1)
    n = 600
    c = rng.uniform(4.0, 12.0, (n, 2)).astype(np.float32)
    pts = c[:, None, :] + np.array([[0.0, 0.0], [0.6, 0.0], [0.0, 0.6]], np.float32)
    z = np.broadcast_to(2.0 + 0.001 * np.arange(n, dtype=np.float32)[:, None, None], (n, 3, 1))
    vp = np.concatenate([pts, z], -1).reshape(-1, 3).astype(np.float32)
    faces = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    _assert_close(*_pair(
        lambda v, f: soft_silhouette_pallas(v, f, (32, 32), max_faces=640),
        lambda v, f: TK.soft_silhouette_kernel(v, f, (32, 32), max_faces=640),
        vp[None], faces, 32,
    ))


def test_kernel_silhouette_empty_view():
    # Mesh fully behind the camera: zero silhouette, zero gradient, on both.
    vp = np.array([[10.0, 10.0, -2.0], [30.0, 12.0, -2.0], [20.0, 30.0, -2.0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    sil_j = np.asarray(soft_silhouette_pallas(jnp.asarray(vp), jnp.asarray(faces), (32, 32)))
    v = torch.tensor(vp)[None].requires_grad_(True)
    sil = TK.soft_silhouette_kernel(v, torch.tensor(faces), (32, 32))
    sil.sum().backward()
    assert float(np.abs(sil_j).max()) == 0.0 and float(sil.detach().abs().max()) == 0.0
    assert float(v.grad.abs().max()) == 0.0
