"""The port's prior-view path vs the JAX package, piece by piece: the
depth-only raster (``rasterize_depth`` against ``rasterize_pallas``, whose
K3 runs in interpret mode here), the prior render and its crop, the box,
ROI-crop and camera helpers, the counted cap, and the ViT at the
prescreen's downscale, and the prior views of both modes (grid rotations
within 1e-6).  The slice as a whole is in test_torch_selection.py.

Tolerances: pix_to_face, hit masks, crop masks, boxes and overflow counts
exact; depths, barycentrics, images and crops within 1e-5; the camera
helpers within 1e-5 (relative for the translation init); ViT tokens within
1e-4 (f32).  On the CPU the port runs K3's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu.ops import rasterize as JZ
from dynhor_tpu.ops import rasterize_tiled as JT
from dynhor_tpu.ops import roi_align as JR
from dynhor_tpu.ops.raster_pallas import rasterize_pallas
from dynhor_tpu.tracker import priors as JP
from dynhor_tpu.utils import bbox as JB
from dynhor_tpu.utils import camera as JC
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils.objio import load_obj
from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import roi_align as TR
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.utils import bbox as TB
from dynhor_tpu_torch.utils import camera as TC
from dynhor_tpu_torch.utils import geometry as TG

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def shoes():
    m = load_obj(SHOES)
    verts = np.asarray(JG.center_and_normalize_verts(jnp.asarray(m.verts)))
    return verts, np.asarray(m.faces), np.asarray(m.face_uvs), np.asarray(m.texture)


def _shoes_view(shoes, s):
    """The scene of tests/test_raster_pallas.py at an s x s image."""
    verts, faces = shoes[:2]
    R = JG.random_rotations(jax.random.PRNGKey(0), 1)[0]
    vc = jnp.asarray(verts) @ R + jnp.array([0.0, 0.0, 2.0])
    K = jnp.array([[s * 1.2, 0, s / 2], [0, s * 1.2, s / 2], [0, 0, 1.0]])
    return np.asarray(JZ.project_perspective(vc, K)), faces


def _crowded():
    # 600 tiny triangles binned into ONE tile (tests/test_raster_pallas.py).
    c = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (600, 2), minval=4.0, maxval=12.0))
    pts = c[:, None, :] + np.array([[0.0, 0.0], [0.6, 0.0], [0.0, 0.6]], np.float32)
    z = np.broadcast_to(2.0 + 0.001 * np.arange(600, dtype=np.float32)[:, None, None], (600, 3, 1))
    vp = np.concatenate([pts, z], -1).reshape(-1, 3).astype(np.float32)
    return vp, np.arange(1800, dtype=np.int32).reshape(600, 3)


@pytest.mark.parametrize(
    "case", ["shoes_128", "shoes_72_partial_tiles", "crowded_tile", "empty_view", "overflow"]
)
def test_rasterize_depth_matches_rasterize_pallas(shoes, case):
    if case == "crowded_tile":
        (vp, faces), size, cap = _crowded(), 64, 640
    elif case == "empty_view":
        # Fully behind the camera: no bins, no hits.
        vp = np.array([[10.0, 10.0, -2.0], [30.0, 10.0, -2.0], [20.0, 30.0, -2.0]], np.float32)
        faces, size, cap = np.array([[0, 1, 2]], np.int32), 64, 640
    else:
        size = 72 if case == "shoes_72_partial_tiles" else 128
        vp, faces = _shoes_view(shoes, size)
        load = int(JT.max_tile_load(jnp.asarray(vp), faces, (size, size), margin=0.0))
        cap = 64 if case == "overflow" else -(-load // 128) * 128
    frag_j, ov_j = rasterize_pallas(jnp.asarray(vp), jnp.asarray(faces), (size, size), max_faces=cap)
    frag_t, ov_t = TF.rasterize_depth(_t(vp)[None], _t(faces), (size, size), max_faces=cap)
    pj = np.asarray(frag_j.pix_to_face)
    np.testing.assert_array_equal(frag_t.pix_to_face[0].numpy(), pj)
    np.testing.assert_allclose(frag_t.zbuf[0].numpy(), np.asarray(frag_j.zbuf), atol=1e-5)
    np.testing.assert_allclose(frag_t.bary[0].numpy(), np.asarray(frag_j.bary), atol=1e-5)
    assert ov_t.tolist() == [int(ov_j)]
    assert (int(ov_j) > 0) == (case == "overflow")
    assert (pj >= 0).any() == (case != "empty_view")


def _packed(rows_all, indices, counts):
    """K1's packed tile rows of the same slots (ops/raster_fused.
    _pack_tile_rows): each slot's record, vis zeroed at and past the count."""
    b, t, m = indices.shape
    rows = torch.gather(rows_all, 1, indices.long().reshape(b, -1, 1).expand(-1, -1, 16))
    rows = rows.reshape(b, t, m, 16).clone()
    rows[..., 6] *= (torch.arange(m) < counts[..., None]).float()
    return rows


def test_tile_depth_plain_is_k1_without_the_mass():
    """K3's plain version, reading records through the bins, makes K1's hard
    decisions on the same slots packed into tile rows."""
    rng = np.random.default_rng(5)
    rows_all = torch.as_tensor(rng.uniform(-8.0, 40.0, (2, 300, 16)).astype(np.float32))
    rows_all[..., 6] = torch.as_tensor((rng.random((2, 300)) > 0.2).astype(np.float32))
    rows_all[..., 8:11] = torch.as_tensor(rng.uniform(-0.5, 3.0, (2, 300, 3)).astype(np.float32))
    rows_all[:, :5, 2:4] = rows_all[:, :5, 0:2]  # degenerate faces
    indices = torch.as_tensor(rng.integers(0, 300, (2, 6, 200)).astype(np.int32))
    counts = torch.tensor([[200, 150, 0, 7, 129, 128], [1, 0, 200, 64, 3, 199]], dtype=torch.int32)
    _, zmin_1, jbest_1 = TF.tile_mass_depth_plain(
        _packed(rows_all, indices, counts), counts, 16, 3, 0.25, 1e-2
    )
    zmin, jbest = TF.tile_depth_plain(rows_all, indices, counts, 16, 3, 1e-2)
    assert torch.equal(zmin, zmin_1) and torch.equal(jbest, jbest_1)
    assert bool((zmin < 1e38).any()) and bool((zmin > 1e38).any())
    before = kernels.depth_fwd.launches
    assert torch.equal(TF.tile_depth(rows_all, indices, counts, 16, 3, 1e-2)[0], zmin)
    assert kernels.depth_fwd.launches == before  # CPU tensors take the plain version


def _old_tile_depth_plain(rows, counts, tile, tiles_w, znear):
    """K3's plain version as it was on packed (B, T, M, 16) rows, 128 slots
    a step: the arithmetic the record-reading version must keep."""
    b, t_rows, m, _ = rows.shape
    px, py = TF._tile_pixels(t_rows, tile, tiles_w, rows.device)
    zmin = rows.new_full((b, t_rows, tile * tile), TF._BIG_Z)
    jbest = torch.zeros((b, t_rows, tile * tile), dtype=torch.int64)
    slot = torch.arange(m)
    for s in range(0, int(counts.max()), 128):
        r = rows[:, :, None, s : s + 128]
        keep = (slot[s : s + 128] < counts[..., None])[:, :, None, :]
        (w0, w1, w2), inside, _ = TF._barycentric(r, px, py)
        z = w0 * r[..., 8] + w1 * r[..., 9] + w2 * r[..., 10]
        live = inside & (z > znear) & (r[..., 6] > 0.5) & keep
        zc, jc = torch.where(live, z, TF._BIG_Z).min(dim=-1)
        better = zc < zmin
        zmin = torch.where(better, zc, zmin)
        jbest = torch.where(better, jc + s, jbest)
    return zmin, jbest.to(torch.int32)


@pytest.mark.parametrize("chunk", [1, 64, 128])
def test_tile_depth_plain_on_records_matches_packed_rows_and_pallas(shoes, chunk):
    """On the shoes view at 128 px: the bins' valid slots are a prefix of
    each row (so the count alone masks the padding); K3's plain version
    reading records through the bins, at any chunk, equals the packed-rows
    arithmetic it replaced, and its pix_to_face equals rasterize_pallas's
    (interpret mode)."""
    size = 128
    vp, faces = _shoes_view(shoes, size)
    load = int(JT.max_tile_load(jnp.asarray(vp), faces, (size, size), margin=0.0))
    cap = -(-load // 128) * 128
    rows_all, indices, counts, tw, bins = TF.depth_inputs(
        _t(vp)[None], _t(faces), (size, size), max_faces=cap
    )
    m = indices.shape[2]
    assert torch.equal(bins.valid, torch.arange(m) < counts[..., None])  # a prefix of each row
    assert indices.dtype == torch.int32 and int(counts.max()) > 128
    zmin, jbest = TF.tile_depth_plain(rows_all, indices, counts, 16, tw, 1e-2, chunk=chunk)
    packed = TF._pack_tile_rows(rows_all, bins.indices, bins.valid, None, 16, tw)[0]
    zmin_o, jbest_o = _old_tile_depth_plain(packed, counts, 16, tw, 1e-2)
    assert torch.equal(zmin, zmin_o) and torch.equal(jbest, jbest_o)
    hit = zmin < 1e38
    fid = torch.where(hit, torch.gather(bins.indices, 2, jbest.long()), -1)
    th = -(-size // 16)
    p2f = fid.reshape(th, tw, 16, 16).permute(0, 2, 1, 3).reshape(th * 16, tw * 16)
    frag_j, _ = rasterize_pallas(jnp.asarray(vp), jnp.asarray(faces), (size, size), max_faces=cap)
    np.testing.assert_array_equal(p2f[:size, :size].numpy(), np.asarray(frag_j.pix_to_face))


def test_prior_render_and_crop_match(shoes):
    """_render_views (one K3 chunk) and the batched _crop_view against the
    JAX package's per-view functions, at a window of 72 (partial tiles)."""
    verts, faces, face_uvs, texture = shoes
    cfg = JP.PriorConfig(render_h=96, render_w=96, crop_size=32)
    radius, center = JP.mesh_radius_center(jnp.asarray(verts))
    distance = cfg.distance_scale * radius
    window = JP.compute_window(cfg, float(JP.mesh_norm_radius(jnp.asarray(verts))), float(distance))
    assert window == 72
    K_full = JP.prior_camera(cfg)
    K_win = K_full - jnp.array([[0.0, 0, (96 - window) / 2], [0, 0, (96 - window) / 2], [0, 0, 0]])
    rots = np.asarray(JG.random_rotations(jax.random.PRNGKey(3), 3))
    ts = np.stack([np.asarray(jnp.array([0.0, 0.0, distance]) - r @ center) for r in rots])
    out_j = [
        JP._render_one_view(
            jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(face_uvs), jnp.asarray(texture),
            jnp.asarray(r), jnp.asarray(t), K_win, window, 512, 5000,
        )
        for r, t in zip(rots, ts)
    ]
    rgba_j = np.stack([np.asarray(o[0]) for o in out_j])
    cfg_t = TP.PriorConfig(render_h=96, render_w=96, crop_size=32)
    verts_t = _t(verts)
    rt, ct = TP.mesh_radius_center(verts_t)
    K_win_t = TP._window_camera(cfg_t, window, "cpu")
    np.testing.assert_allclose(K_win_t.numpy(), np.asarray(K_win), atol=0)
    t_t = TP._view_translations(_t(rots), cfg_t.distance_scale * rt, ct)
    np.testing.assert_allclose(t_t.numpy(), ts, atol=1e-6)
    rgba_t, zbuf_t, ov_t = TP._render_views(
        verts_t, _t(faces), _t(face_uvs), _t(texture), _t(rots), _t(ts), K_win_t, window, 5000
    )
    assert ov_t.tolist() == [0, 0, 0]
    np.testing.assert_array_equal(rgba_t[..., 3].numpy(), rgba_j[..., 3])
    np.testing.assert_allclose(rgba_t.numpy(), rgba_j, atol=1e-5)
    np.testing.assert_allclose(zbuf_t.numpy(), np.stack([np.asarray(o[1]) for o in out_j]), atol=1e-5)

    crops_t, masks_t, boxes_t = TP._crop_view(_t(rgba_j), 32, cfg.bbox_expansion)
    for i in range(3):
        img_j, mask_j, box_j = JP._crop_view(jnp.asarray(rgba_j[i]), 32, cfg.bbox_expansion)
        np.testing.assert_array_equal(boxes_t[i].numpy(), np.asarray(box_j))
        np.testing.assert_array_equal(masks_t[i].numpy(), np.asarray(mask_j))
        np.testing.assert_allclose(crops_t[i].numpy(), np.asarray(img_j), atol=1e-5)


def test_boxes_and_roi_crops_match():
    rng = np.random.default_rng(0)
    n, h, w = 12, 60, 72
    masks = np.zeros((n, h, w), np.float32)
    for i in range(n - 1):
        y0, x0 = rng.integers(-10, 40, 2)
        masks[i, max(y0, 0) : y0 + rng.integers(8, 40), max(x0, 0) : x0 + rng.integers(8, 50)] = 1
        masks[i] *= rng.random((h, w)) > 0.15
    # The last mask is empty: the reference's sentinel box, clamped.
    box_j = np.asarray(jax.vmap(lambda m: JB.mask_tight_bbox_xyxy(m, 5.0))(jnp.asarray(masks)))
    box_t = TB.mask_tight_bbox_xyxy(_t(masks), 5.0)
    np.testing.assert_array_equal(box_t.numpy(), box_j)
    wh_t = TB.bbox_xy_to_wh(box_t)
    np.testing.assert_array_equal(wh_t.numpy(), np.asarray(JB.bbox_xy_to_wh(jnp.asarray(box_j))))
    sq_j = np.asarray(JB.bbox_wh_to_xy(JB.make_bbox_square(JB.bbox_xy_to_wh(jnp.asarray(box_j)), 0.3)))
    sq_t = TB.bbox_wh_to_xy(TB.make_bbox_square(wh_t, 0.3))
    np.testing.assert_allclose(sq_t.numpy(), sq_j, rtol=1e-6, atol=1e-5)
    sq = sq_j[:-1]
    img = rng.random((n - 1, 3, h, w)).astype(np.float32)
    for s in (32, 37):
        # Crop masks: a bilinear average of {0, 1} thresholded at 0.5.
        m_j = np.asarray(JR.crop_and_resize(jnp.asarray(masks[:-1, None]), jnp.asarray(sq), s))
        m_t = TR.crop_and_resize(_t(masks[:-1, None]), _t(sq), s).numpy()
        np.testing.assert_array_equal(m_t >= 0.5, m_j >= 0.5)
        np.testing.assert_allclose(m_t, m_j, atol=1e-5)
        c_j = np.asarray(JR.crop_and_resize(jnp.asarray(img), jnp.asarray(sq), s))
        np.testing.assert_allclose(TR.crop_and_resize(_t(img), _t(sq), s).numpy(), c_j, atol=1e-5)
    one = TR.roi_align(_t(img[2]), _t(sq[2]), 24).numpy()
    np.testing.assert_allclose(one, np.asarray(JR.roi_align(jnp.asarray(img[2]), jnp.asarray(sq[2]), 24)), atol=1e-5)


def test_crop_intrinsics_and_translation_init_match():
    rng = np.random.default_rng(1)
    b = 6
    K = np.tile(np.asarray(JC.intrinsics_from_image(480, 640)), (b, 1, 1))
    np.testing.assert_array_equal(TC.intrinsics_from_image(480, 640, device="cpu").numpy(), K[0])
    xy = rng.uniform(50, 300, (b, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(40, 200, (b, 2))], 1).astype(np.float32)
    Kc_j = np.asarray(JC.get_K_crop_resize(jnp.asarray(K), jnp.asarray(boxes), 256))
    Kc_t = TC.get_K_crop_resize(_t(K), _t(boxes), 256).numpy()
    np.testing.assert_allclose(Kc_t, Kc_j, rtol=1e-6, atol=1e-5)
    pts = (rng.standard_normal((b, 300, 3)) * 0.2).astype(np.float32)
    rot = np.asarray(JG.random_rotations(jax.random.PRNGKey(2), b))
    pts_rot = np.einsum("bvj,bjk->bvk", pts, rot).astype(np.float32)
    box_wh = np.asarray(JB.bbox_xy_to_wh(jnp.asarray(boxes)))
    T_j = np.asarray(JC.tco_init_from_boxes_autodepth(jnp.asarray(box_wh), jnp.asarray(pts_rot), jnp.asarray(K)))
    T_t = TC.tco_init_from_boxes_autodepth(_t(box_wh), _t(pts_rot), _t(K)).numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TC.batch_proj2d(_t(pts_rot) + _t(T_t)[:, None], _t(K)).numpy(),
        np.asarray(JC.batch_proj2d(jnp.asarray(pts_rot) + jnp.asarray(T_t)[:, None], jnp.asarray(K))),
        rtol=1e-6, atol=1e-4,
    )
    R1 = np.asarray(JG.random_rotations(jax.random.PRNGKey(4), 5))
    np.testing.assert_allclose(
        TG.rotation_angle_difference(_t(R1)[:, None], _t(rot)[None]).numpy(),
        np.asarray(JG.rotation_angle_difference(jnp.asarray(R1)[:, None], jnp.asarray(rot)[None])),
        atol=1e-4,
    )
    # The clip before arccos: identical rotations give 0, not NaN.
    assert float(TG.rotation_angle_difference(_t(rot), _t(rot)).abs().max()) < 0.1


def test_counted_prior_cap_matches(shoes):
    """required_prior_cap on the views and config of
    tests/test_priors_window.py::test_prior_batched_counts_safe_cap."""
    verts, faces = shoes[:2]
    cfg = JP.PriorConfig(num_views=8, view_chunk=8, crop_size=64, max_faces_per_tile=256)
    radius, center = JP.mesh_radius_center(jnp.asarray(verts))
    window = JP.compute_window(cfg, float(JP.mesh_norm_radius(jnp.asarray(verts))), float(cfg.distance_scale * radius))
    rots = JP.prior_view_rotations(jax.random.PRNGKey(1), cfg)
    cap_j = JP.required_prior_cap(
        jnp.asarray(verts), jnp.asarray(faces), rots, cfg, window,
        float(cfg.distance_scale * radius), center,
    )
    cfg_t = TP.PriorConfig(num_views=8, view_chunk=8, crop_size=64, max_faces_per_tile=256)
    rt, ct = TP.mesh_radius_center(_t(verts))
    window_t = TP.compute_window(cfg_t, float(TP.mesh_norm_radius(_t(verts))), float(cfg_t.distance_scale * rt))
    assert window_t == window
    cap_t = TP.required_prior_cap(
        _t(verts), _t(faces), _t(rots), cfg_t, window, float(cfg_t.distance_scale * rt), ct, chunk=3
    )
    assert cap_t == cap_j and cap_t > 256


def test_vit_tokens_at_the_prescreen_downscale():
    """forward_tokens_from_crop from a 32² crop down to an edge of 28 (the
    prescreen shrinks its 128² crops to 112), tiny config, f32."""
    kw = dict(patch_size=14, embed_dim=32, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=28)
    cfg_j = JD.DinoConfig(**kw)
    params_j = JD.init_params(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(0)
    params_j = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params_j)
    params_t = TD.params_from_jax(jax.tree.map(np.asarray, params_j))
    rgb = rng.random((3, 3, 32, 32)).astype(np.float32)
    tok_j = np.asarray(JD.forward_tokens_from_crop(params_j, jnp.asarray(rgb), cfg_j, remat=False))
    with torch.inference_mode():
        tok_t = TD.forward_tokens_from_crop(params_t, _t(rgb), TD.DinoConfig(**kw)).numpy()
    assert tok_t.shape == (3, 4, 32)
    np.testing.assert_allclose(tok_t, tok_j, atol=1e-4)


@pytest.mark.parametrize("grid", [None, (30, 10, 13), (6, 3, 1)])
def test_prior_view_rotations_modes(grid):
    """Grid mode (``random_render: false``): the JAX package's views within
    1e-6, drawing nothing; random mode: uniform draws from the generator
    (the same seed, the same views).  The port's config fields are the JAX
    package's, less the two that the JAX package carries and never reads
    (``face_chunk``, ``window``)."""
    kw = dict(num_views=24, grid=grid)
    cfg_t, cfg_j = TP.PriorConfig(**kw), JP.PriorConfig(**kw)
    unread = {"face_chunk", "window"}
    assert {f.name for f in dataclasses.fields(cfg_t)} == {f.name for f in dataclasses.fields(cfg_j)} - unread
    got = TP.prior_view_rotations(cfg_t, torch.Generator().manual_seed(0))
    if grid is None:
        assert got.shape == (24, 3, 3)
        again = TP.prior_view_rotations(cfg_t, torch.Generator().manual_seed(0))
        assert torch.equal(got, again)
    else:
        na, ne, nr = grid
        assert got.shape == ((na * ne + 2) * nr, 3, 3)
        want = JP.prior_view_rotations(jax.random.PRNGKey(0), cfg_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(1, 2), torch.eye(3).expand_as(got), atol=1e-5)
