"""Port rasterizers vs the JAX package (its Pallas kernels in interpret
mode, as its own tests run them): tile binning exactly, the dense raster,
and the fused raster + soft silhouette forward and d(verts) on the scenes
of tests/test_raster_pallas.py.

Tolerances: pix_to_face exact except at depth ties (both winning depths
within 1e-6); silhouette, zbuf and barycentrics within 1e-5; d(verts)
within rtol 1e-4 and atol 1e-5 x max|d(verts)| (f32 sums in another
order).  On the CPU the port runs its kernels' plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.ops import raster_pallas as JP
from dynhor_tpu.ops import rasterize as JZ
from dynhor_tpu.ops import rasterize_tiled as JT
from dynhor_tpu.ops.silhouette_pallas import _pixel_coords, _tile_mass_grad_analytic
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils.objio import load_obj
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
from dynhor_tpu_torch.ops import rasterize_tiled as TT

S = 64
MARGIN = 6.0 * 0.25 + 1.0


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def shoes():
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = JG.center_and_normalize_verts(jnp.asarray(m.verts))
    R = JG.random_rotations(jax.random.PRNGKey(0), 1)[0]
    vc = verts @ R + jnp.array([0.0, 0.0, 2.0])
    K = jnp.array([[S * 0.6, 0, S / 2], [0, S * 0.6, S / 2], [0, 0, 1.0]])
    vp = np.asarray(JZ.project_perspective(vc, K))
    faces = np.asarray(m.faces)
    cap = -(-int(JT.max_tile_load(jnp.asarray(vp), faces, (S, S), margin=MARGIN)) // 128) * 128
    n_act = int(JT.max_active_tiles_load(jnp.asarray(vp), faces, (S, S), margin=MARGIN))
    return vp, faces, cap, n_act


@pytest.fixture(scope="module")
def crowded():
    # 600 tiny triangles binned into ONE tile: its count (600) is not a
    # multiple of 128 or 512.
    rng = np.random.default_rng(1)
    n = 600
    c = rng.uniform(4.0, 12.0, (n, 2)).astype(np.float32)
    pts = c[:, None, :] + np.array([[0.0, 0.0], [0.6, 0.0], [0.0, 0.6]], np.float32)
    z = np.broadcast_to(2.0 + 0.001 * np.arange(n, dtype=np.float32)[:, None, None], (n, 3, 1))
    vp = np.concatenate([pts, z], -1).reshape(-1, 3).astype(np.float32)
    return vp, np.arange(n * 3, dtype=np.int32).reshape(n, 3)


@pytest.mark.parametrize("cap,margin", [(640, MARGIN), (64, MARGIN), (5000, 0.0)])
def test_binning_matches_exactly(shoes, cap, margin):
    vp, faces, _, _ = shoes
    jv, tv, tf = jnp.asarray(vp), _t(vp)[None], _t(faces)
    bj = JT.bin_faces(jv, faces, (S, S), 16, cap, margin=margin)
    bt = TT.bin_faces(tv, tf, (S, S), 16, cap, margin=margin)
    np.testing.assert_array_equal(bt.indices[0].numpy(), np.asarray(bj.indices))
    np.testing.assert_array_equal(bt.valid[0].numpy(), np.asarray(bj.valid))
    assert int(bt.overflow[0]) == int(bj.overflow)
    for k_max in (32, 2):
        ij = JT.face_tile_inverse(jv, faces, (S, S), 16, cap, margin, k_max=k_max)
        it = TT.face_tile_inverse(tv, tf, (S, S), 16, cap, margin, k_max=k_max)
        np.testing.assert_array_equal(it[0][0].numpy(), np.asarray(ij[0]))
        np.testing.assert_array_equal(it[1][0].numpy(), np.asarray(ij[1]))
        assert int(it[2][0]) == int(ij[2])
        both = TT.bin_faces_and_inverse(tv, tf, (S, S), 16, cap, margin, k_max)
        assert all(torch.equal(x, y) for x, y in zip(both[0], bt))
        assert all(torch.equal(x, y) for x, y in zip(both[1], it))
    assert int(TT.max_tile_load(tv, tf, (S, S), margin=margin)[0]) == int(
        JT.max_tile_load(jv, faces, (S, S), margin=margin)
    )
    assert int(TT.max_active_tiles_load(tv, tf, (S, S), margin=margin)[0]) == int(
        JT.max_active_tiles_load(jv, faces, (S, S), margin=margin)
    )


def test_dense_rasterize_matches(shoes):
    vp, faces, _, _ = shoes
    fj = JZ.rasterize(jnp.asarray(vp), faces, (S, S), face_chunk=512)
    ft = TZ.rasterize(_t(vp)[None], _t(faces), (S, S), face_chunk=512)
    np.testing.assert_array_equal(ft.pix_to_face[0].numpy(), np.asarray(fj.pix_to_face))
    np.testing.assert_allclose(ft.zbuf[0].numpy(), np.asarray(fj.zbuf), atol=1e-5)
    np.testing.assert_allclose(ft.bary[0].numpy(), np.asarray(fj.bary), atol=1e-5)


def _assert_fragments_close(fj, ft):
    pj, pt = np.asarray(fj.pix_to_face), ft.pix_to_face[0].numpy()
    zj, zt = np.asarray(fj.zbuf), ft.zbuf[0].numpy()
    diff = pj != pt
    # A differing face id is allowed only at a depth tie.
    assert (diff <= ((pj >= 0) & (pt >= 0) & (np.abs(zj - zt) <= 1e-6))).all()
    np.testing.assert_allclose(zt, zj, atol=1e-5)
    np.testing.assert_allclose(ft.bary[0].detach().numpy(), np.asarray(fj.bary), atol=1e-5)


def _fused_pair(vp, faces, size, weight, **kw):
    """Forward outputs and d(sum(sil * weight))/d(verts) of both packages."""

    def loss_j(v):
        out = JP.rasterize_silhouette_pallas(v, faces, size, **kw)
        return (out[1] * weight).sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(jnp.asarray(vp))
    v = _t(vp)[None].requires_grad_(True)
    out_t = TF.rasterize_silhouette(v, _t(faces), size, **kw)
    (out_t[1][0] * _t(weight)).sum().backward()
    return out_j, np.asarray(g_j), out_t, v.grad[0].numpy()


def _assert_grad_close(gt, gj):
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("case", ["dense", "compact_return", "overflow"])
def test_fused_raster_matches(shoes, case):
    vp, faces, cap, n_act = shoes
    # The overflow case drops face-tile pairs at a per-tile cap of 64.
    kw = {"max_faces": 64 if case == "overflow" else cap}
    if case != "dense":
        kw["max_active_tiles"] = n_act + 4
    if case == "compact_return":
        kw["return_compact"] = True
    weight = np.cos(np.arange(S * S, dtype=np.float32).reshape(S, S) * 0.01)
    out_j, gj, out_t, gt = _fused_pair(vp, faces, (S, S), weight, **kw)
    assert out_t[2].tolist() == [int(out_j[2])]
    assert (int(out_j[2]) > 0) == (case == "overflow")
    _assert_fragments_close(out_j[0], out_t[0])
    np.testing.assert_allclose(out_t[1][0].detach().numpy(), np.asarray(out_j[1]), atol=1e-5)
    assert np.abs(gj).sum() > 1.0
    _assert_grad_close(gt, gj)
    if case == "compact_return":
        cj, ct = out_j[3], out_t[3]
        np.testing.assert_array_equal(ct.act_ids[0].numpy(), np.asarray(cj.act_ids))
        np.testing.assert_array_equal(ct.fid[0].numpy(), np.asarray(cj.fid))
        np.testing.assert_allclose(ct.bary[0].detach().numpy(), np.asarray(cj.bary), atol=1e-5)


def test_fused_raster_crowded_tile(crowded):
    vp, faces = crowded
    weight = np.sin(np.arange(64 * 64, dtype=np.float32).reshape(64, 64) * 0.03)
    out_j, gj, out_t, gt = _fused_pair(vp, faces, (64, 64), weight, max_faces=640)
    assert int(out_j[2]) == 0 and out_t[2].tolist() == [0]
    _assert_fragments_close(out_j[0], out_t[0])
    np.testing.assert_allclose(out_t[1][0].detach().numpy(), np.asarray(out_j[1]), atol=1e-5)
    _assert_grad_close(gt, gj)


def test_fused_raster_empty_view():
    # Mesh fully behind the camera: no hits, zero silhouette, zero gradient.
    verts = np.array([[-0.1, -0.1, -2.0], [0.1, -0.1, -2.0], [0.0, 0.1, -2.0]], np.float32)
    K = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1.0]], np.float32)
    vp = TZ.project_perspective(_t(verts)[None], _t(K)).requires_grad_(True)
    frag, sil, ov = TF.rasterize_silhouette(vp, torch.tensor([[0, 1, 2]]), (64, 64))
    assert int((frag.pix_to_face >= 0).sum()) == 0
    assert float(sil.detach().max()) == 0.0 and ov.tolist() == [0]
    sil.sum().backward()
    assert float(vp.grad.abs().max()) == 0.0


def test_active_tile_overflow_matches():
    # Two triangles covering the whole 64² view: 16 active tiles, 8 kept.
    vp = np.array(
        [[-4.3, -3.7, 2.0], [70.2, -4.1, 2.0], [69.7, 70.4, 2.0], [-3.9, 70.1, 2.1]],
        np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    weight = np.ones((64, 64), np.float32)
    out_j, gj, out_t, gt = _fused_pair(vp, faces, (64, 64), weight, max_active_tiles=8)
    assert int(out_j[2]) == 8 and out_t[2].tolist() == [8]
    _assert_fragments_close(out_j[0], out_t[0])
    np.testing.assert_allclose(out_t[1][0].detach().numpy(), np.asarray(out_j[1]), atol=1e-5)
    _assert_grad_close(gt, gj)


@pytest.mark.parametrize("tile_row", [0, 5])
def test_plain_kernels_match_the_pallas_tile_math(tile_row):
    """The plain K1/K2 against the JAX package's per-tile functions on
    random slot records, in tile row 0 and in row 5 of a grid 4 tiles wide
    (pixel origin (16, 16))."""
    rng = np.random.default_rng(5)
    m, tile, tiles_w = 128, 16, 4
    ox, oy = (tile_row % tiles_w) * tile, (tile_row // tiles_w) * tile
    rec = rng.uniform(-8.0, 24.0, (m, 16)).astype(np.float32)
    rec[:, 6] = (rng.random(m) > 0.2).astype(np.float32)
    rec[:, 7] = 0.0
    rec[:, 8:11] = rng.uniform(0.5, 3.0, (m, 3))
    rec[:5, 2:4] = rec[:5, 0:2]  # degenerate faces
    rec[:, 0:6:2] += ox
    rec[:, 1:6:2] += oy
    g = rng.standard_normal((tile * tile,)).astype(np.float32)
    px, py = _pixel_coords(tile)
    px, py = px + ox, py + oy
    count = 100
    keep = (jnp.arange(m) < count)[None, :]
    rows_j = jnp.asarray(rec.T).at[6].multiply(keep[0].astype(jnp.float32))
    mass_j, zmin_j, jbest_j = jax.jit(
        lambda r: JP._tile_mass_and_depth_chunk(r, px, py, 0.25, "linear", 1e-2, keep)
    )(rows_j)
    grad_j = jax.jit(
        lambda r, gg: _tile_mass_grad_analytic(r, px, py, gg, 0.25, "linear")
    )(rows_j[:8], jnp.asarray(g)[:, None])

    rec_t = rec.copy()
    rec_t[count:, 6] = 0.0
    rows = torch.zeros((1, tile_row + 1, m, 16))
    rows[0, tile_row] = _t(rec_t)
    counts = torch.zeros((1, tile_row + 1), dtype=torch.int32)
    counts[0, tile_row] = count
    mass, zmin, jbest = TF.tile_mass_depth_plain(rows, counts, tile, tiles_w, 0.25, 1e-2)
    np.testing.assert_allclose(mass[0, tile_row].numpy(), np.asarray(mass_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zmin[0, tile_row].numpy(), np.asarray(zmin_j), rtol=1e-6)
    np.testing.assert_array_equal(jbest[0, tile_row].numpy(), np.asarray(jbest_j))
    gt = torch.zeros((1, tile_row + 1, tile * tile))
    gt[0, tile_row] = _t(g)
    dxy = TF.tile_mass_grad_plain(rows, counts, gt, tile, tiles_w, 0.25)
    gj = np.asarray(grad_j)[:6].T
    np.testing.assert_allclose(
        dxy[0, tile_row].numpy(), gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max()
    )
    assert float(dxy[0, tile_row, count:].abs().max()) == 0.0
