"""The CUDA kernels against their plain PyTorch versions, on the card.

Run where a card is present: ``python -m pytest -m cuda tests/test_torch_*.py``.
Without one every test here skips (the card is looked for in a fixture, so
every pytest worker collects the same tests).

Tolerances: K1's silhouette and depths within 1e-5 and its hard outputs
(hit mask, winning slot) equal — the kernel rounds like the plain version
(no FMA contraction beyond the explicit ones); K2's d(xy) within rtol 1e-4
and atol 1e-5 x max (f32 sums in another order).  The same on rows made
with adversarial counts (one row at the cap, counts at the work list's
chunk edges, none, equal depths in two chunks, a wide batch), where two
runs must also give the same bits.  K3's depths within
1e-5 and its hit mask and winning slot equal, as K1's, and on the adversarial
counts its zbuf and slots exactly the plain versions'; the prior scores of
the card and the CPU within 1e-5 (f32 ViT, TF32 off).  K5 in bf16: o, dq, dk
and dv within 2^-7 of the largest value (one bf16 step where the kernel and
the plain version land on either side of a rounding boundary), its f32
log-sum-exp and delta within 1e-5 of theirs; K5 in f32: everything within
1e-5 of the largest value (f32 sums in another order).  K4a as K1 and K4b as K2
(K4b is K2's kernel on K4a's rows), the whole soft_silhouette_kernel card
vs CPU the same.  K6's gathers exactly, its scatter-adds within rtol 1e-5
and atol 1e-5 (atomic f32 sums in another order).
"""
import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import flash_attention as FA
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
from dynhor_tpu_torch.ops import silhouette_kernel as TK
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.tracker import refine as TR
from dynhor_tpu_torch.utils import geometry as TG
from dynhor_tpu_torch.utils.objio import load_obj

pytestmark = pytest.mark.cuda

S = 128


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shoes(cuda):
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = TG.center_and_normalize_verts(torch.as_tensor(m.verts))
    x = torch.as_tensor(np.random.default_rng(0).random((3, 3), dtype=np.float32))
    R = TG.rotations_from_uniforms(x)
    K = torch.tensor([[S * 1.2, 0, S / 2], [0, S * 1.2, S / 2], [0, 0, 1.0]])
    vp = TZ.project_perspective(verts @ R + torch.tensor([0.0, 0.0, 2.0]), K)
    return vp.to(cuda), torch.as_tensor(m.faces).long().to(cuda)


@pytest.mark.parametrize("compact", [False, True])
def test_kernels_match_plain_versions(shoes, compact):
    vp, faces = shoes
    rows, counts, tw = TF.kernel_inputs(
        vp, faces, (S, S), max_faces=faces.shape[0], max_active_tiles=40 if compact else None
    )
    assert int(counts.sum()) > 0
    args = (16, tw, 0.25)
    mass, zmin, jbest = kernels.fused_fwd(rows, counts, *args, 1e-2)
    mass_p, zmin_p, jbest_p = TF.tile_mass_depth_plain(rows, counts, *args, 1e-2)
    torch.testing.assert_close(torch.exp(-mass), torch.exp(-mass_p), rtol=0, atol=1e-5)
    hit = zmin_p < 1.5e38
    assert torch.equal(hit, zmin < 1.5e38)
    torch.testing.assert_close(zmin[hit], zmin_p[hit], rtol=0, atol=1e-5)
    assert torch.equal(jbest[hit], jbest_p[hit])

    g = torch.randn(mass.shape, generator=torch.Generator().manual_seed(1)).to(vp.device)
    dxy = kernels.sil_bwd(rows, counts, g, *args)
    dxy_p = TF.tile_mass_grad_plain(rows, counts, g, *args)
    torch.testing.assert_close(
        dxy, dxy_p, rtol=1e-4, atol=1e-5 * float(dxy_p.abs().max())
    )


def _crafted_rows(cuda, b, t, m, counts, seed, tie=None):
    """Tile rows of random faces around each row's tile (16 px, a grid 16
    tiles wide), as _pack_tile_rows lays them out: vis 1 for most faces
    below the count, 0 past it.  ``tie`` = (row, slots): the first slot's
    face, large and in front of every other, is copied to the other slots,
    so their depths tie exactly and the first slot must win."""
    rng = np.random.default_rng(seed)
    rec = np.zeros((b, t, m, 16), np.float32)
    rid = np.arange(t)
    origin = np.stack([(rid % 16) * 16, (rid // 16) * 16], -1)[None, :, None, None, :]
    corner = rng.uniform(-4.0, 20.0, (b, t, m, 1, 2))
    tri = (corner + rng.uniform(-7.0, 7.0, (b, t, m, 3, 2)) + origin).astype(np.float32)
    rec[..., 0:6] = tri.reshape(b, t, m, 6)
    rec[..., 6] = rng.random((b, t, m)) > 0.1
    rec[..., 8:11] = rng.uniform(0.5, 3.0, (b, t, m, 3))
    counts = np.asarray(counts, np.int32)
    rec[np.arange(m)[None, None, :] >= counts[..., None], 6] = 0.0
    if tie is not None:
        (fb, ft), slots = tie
        ox, oy = origin[0, ft, 0, 0]
        rec[fb, ft, slots[0], 0:6] = [ox - 20, oy - 20, ox + 60, oy - 20, ox - 20, oy + 60]
        rec[fb, ft, slots[0], 6] = 1.0
        rec[fb, ft, slots[0], 8:11] = 0.1
        rec[fb, ft, slots[1:]] = rec[fb, ft, slots[0]]
    return torch.as_tensor(rec).to(cuda), torch.as_tensor(counts).to(cuda)


def _adversarial(case):
    """(frames, rows, cap, counts, tie) of each adversarial case."""
    rng = np.random.default_rng(17)
    if case == "one-full-row":  # one row at the cap, every other row empty
        counts = np.zeros((8, 80), np.int32)
        counts[3, 17] = 1408
        return 8, 80, 1408, counts, ((3, 17), [5, 5 + kernels.MASS_CHUNK, 700, 1407])
    if case == "chunk-edges":  # counts at and around both chunk sizes, and the cap
        counts = rng.integers(0, 200, (8, 80)).astype(np.int32)
        edges = [c + d for c in (kernels.GRAD_CHUNK, kernels.MASS_CHUNK, 128) for d in (-1, 0, 1)]
        counts.reshape(-1)[: len(edges) + 1] = edges + [640]
        counts[0, 20] = 199
        return 8, 80, 640, counts, ((0, 20), [3, kernels.MASS_CHUNK + 3, 131])
    if case == "all-zero":
        return 8, 80, 256, np.zeros((8, 80), np.int32), None
    # wide: 64 frames x 80 rows, heavy-tailed counts
    counts = np.minimum(rng.pareto(1.5, (64, 80)) * 40, 256).astype(np.int32)
    return 64, 80, 256, counts, None


@pytest.mark.parametrize("case", ["one-full-row", "chunk-edges", "all-zero", "wide"])
def test_k1_k2_on_adversarial_counts(cuda, case):
    """K1 and K2 (and K4a and K4b, the same code) on rows whose counts the
    work list finds hardest: hard outputs exactly the plain version's, two
    runs bit-identical."""
    b, t, m, counts, tie = _adversarial(case)
    rows, counts = _crafted_rows(cuda, b, t, m, counts, 23, tie)
    args = (16, 16, 0.25)
    g = torch.randn((b, t, 256), generator=torch.Generator().manual_seed(2)).to(cuda)
    chunk = 32 if case == "wide" else 128  # the plain version's memory knob
    mass_p, zmin_p, jbest_p = TF.tile_mass_depth_plain(rows, counts, *args, 1e-2, chunk=chunk)
    dxy_p = TF.tile_mass_grad_plain(rows, counts, g, *args, chunk=chunk)
    def run():
        return (*kernels.fused_fwd(rows, counts, *args, 1e-2), kernels.sil_bwd(rows, counts, g, *args),
                kernels.sil_mass_fwd(rows, counts, *args), kernels.sil_mass_bwd(rows, counts, g, *args))

    first, again = run(), run()
    for a, e in zip(first, again):
        assert torch.equal(a, e)
    mass, zmin, jbest, dxy, mass4, dxy4 = first
    assert torch.equal(zmin, zmin_p) and torch.equal(jbest, jbest_p)
    for x in (mass, mass4):
        assert float(((x - mass_p).abs() / mass_p.abs().clamp_min(1.0)).max()) <= 1e-4
    for x in (dxy, dxy4):
        torch.testing.assert_close(x, dxy_p, rtol=1e-4, atol=1e-5 * float(dxy_p.abs().max()))
    if tie is not None:
        (fb, ft), slots = tie
        assert int((jbest[fb, ft] == slots[0]).sum()) > 0
        assert not bool(torch.isin(jbest[fb, ft], torch.tensor(slots[1:], device=cuda)).any())
    if case == "all-zero":
        assert float(mass.abs().max()) == 0.0 and float(dxy.abs().max()) == 0.0
        assert bool((zmin == 3.0e38).all()) and int(jbest.abs().max()) == 0


def _as_records(rows, seed):
    """K3's inputs holding the same slots as packed tile rows (b, t, m, 16):
    every slot's record at a shuffled place of a (b, t * m, 16) face pool and
    indices (b, t, m) int32 pointing at it."""
    b, t, m, _ = rows.shape
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(t * m)).to(rows.device)
    rows_all = torch.empty((b, t * m, 16), dtype=rows.dtype, device=rows.device)
    rows_all[:, perm] = rows.reshape(b, t * m, 16)
    return rows_all, perm.to(torch.int32).reshape(1, t, m).expand(b, t, m).contiguous()


@pytest.mark.parametrize("case", ["one-full-row", "chunk-edges", "all-zero", "wide"])
def test_k3_on_adversarial_counts(cuda, case):
    """K3 on the same adversarial counts, its records read through shuffled
    face ids: zbuf and winning slot exactly K3's and K1's plain versions',
    the first slot winning equal depths across chunks, two runs
    bit-identical."""
    b, t, m, counts, tie = _adversarial(case)
    rows, counts = _crafted_rows(cuda, b, t, m, counts, 29, tie)
    rows_all, indices = _as_records(rows, 3)
    chunk = 32 if case == "wide" else 128  # the plain versions' memory knob
    zmin_p, jbest_p = TF.tile_depth_plain(rows_all, indices, counts, 16, 16, 1e-2, chunk=chunk)
    _, zmin_1, jbest_1 = TF.tile_mass_depth_plain(rows, counts, 16, 16, 0.25, 1e-2, chunk=chunk)
    assert torch.equal(zmin_p, zmin_1) and torch.equal(jbest_p, jbest_1)
    before = kernels.depth_fwd.launches
    first = kernels.depth_fwd(rows_all, indices, counts, 16, 16, 1e-2)
    again = kernels.depth_fwd(rows_all, indices, counts, 16, 16, 1e-2)
    assert kernels.depth_fwd.launches - before == 2
    assert all(torch.equal(a, e) for a, e in zip(first, again))
    zmin, jbest = first
    assert torch.equal(zmin, zmin_p) and torch.equal(jbest, jbest_p)
    if tie is not None:
        (fb, ft), slots = tie
        assert int((jbest[fb, ft] == slots[0]).sum()) > 0
        assert not bool(torch.isin(jbest[fb, ft], torch.tensor(slots[1:], device=cuda)).any())
    if case == "all-zero":
        assert bool((zmin == 3.0e38).all()) and int(jbest.abs().max()) == 0


def test_refine_runs_through_both_kernels(cuda):
    gen = torch.Generator().manual_seed(2)
    mesh = TR.MeshArrays(
        torch.rand((8, 3), generator=gen) - 0.5,
        torch.tensor([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1]]),
        torch.full((6, 3, 2), 0.5), torch.ones((2, 2, 3)),
    )
    masks = torch.zeros((2, 64, 64))
    masks[:, 20:44, 20:44] = 1.0
    K = torch.tensor([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1.0]])
    targets = TR.FrameTargets(masks, torch.zeros((2, 4, 8)), K.expand(2, 3, 3))
    trans = torch.tensor([[0.0, 0.0, 2.0], [0.1, 0.0, 2.0]])
    k1, k2 = kernels.fused_fwd.launches, kernels.sil_bwd.launches
    res = TR.refine_poses(
        mesh, targets, torch.eye(3).expand(2, 3, 3), trans, None, None,
        TR.RefineConfig(num_iterations=4, crop_size=64, mode="coarse"), device=cuda,
    )
    assert kernels.fused_fwd.launches - k1 == 4 and kernels.sil_bwd.launches - k2 == 4
    assert bool(torch.isfinite(res.final_loss).all()) and res.final_loss.is_cuda


def _prior_chunk(cuda, n_views, render):
    """One chunk of prior views of the shoes mesh, projected as
    tracker/priors.py projects them: (vp, faces, window, counted cap)."""
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = TG.center_and_normalize_verts(torch.as_tensor(m.verts)).to(cuda)
    faces = torch.as_tensor(m.faces).long().to(cuda)
    cfg = TP.PriorConfig(render_h=render, render_w=render)
    radius, center = TP.mesh_radius_center(verts)
    window = TP.compute_window(
        cfg, float(TP.mesh_norm_radius(verts)), float(cfg.distance_scale * radius)
    )
    x = torch.as_tensor(np.random.default_rng(3).random((3, n_views), dtype=np.float32))
    R = TG.rotations_from_uniforms(x).to(cuda)
    t = TP._view_translations(R, cfg.distance_scale * radius, center)
    vp = TZ.project_perspective(verts @ R.transpose(1, 2) + t[:, None], TP._window_camera(cfg, window, cuda))
    cap = TP.required_prior_cap(
        verts, faces, R, cfg, window, float(cfg.distance_scale * radius), center
    )
    return vp, faces, window, cap


@pytest.mark.parametrize("render", [384, 192, 96])
def test_depth_kernel_matches_plain_version(cuda, render):
    vp, faces, window, cap = _prior_chunk(cuda, 6, render)
    rows_all, indices, counts, tw, _ = TF.depth_inputs(vp, faces, (window, window), max_faces=cap)
    zmin, jbest = kernels.depth_fwd(rows_all, indices, counts, 16, tw, 1e-2)
    zmin_p, jbest_p = TF.tile_depth_plain(rows_all, indices, counts, 16, tw, 1e-2)
    hit = zmin_p < 1.5e38
    assert bool(hit.any()) and torch.equal(hit, zmin < 1.5e38)
    torch.testing.assert_close(zmin[hit], zmin_p[hit], rtol=0, atol=1e-5)
    assert torch.equal(jbest[hit], jbest_p[hit])
    before = kernels.depth_fwd.launches
    frag, ov = TF.rasterize_depth(vp, faces, (window, window), max_faces=cap)
    frag_c, ov_c = TF.rasterize_depth(vp.cpu(), faces.cpu(), (window, window), max_faces=cap)
    assert kernels.depth_fwd.launches == before + 1
    assert int(ov.max()) == 0 and int(ov_c.max()) == 0
    assert torch.equal(frag.pix_to_face.cpu(), frag_c.pix_to_face)


def test_prior_scores_launch_k3_once_per_chunk(cuda):
    from dynhor_tpu_torch.models import dino as TD

    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = TG.center_and_normalize_verts(torch.as_tensor(m.verts))
    # Head dim 16, which K5 does not take: the attention written out.
    dcfg = TD.DinoConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                         smaller_edge_size=32, attn_impl="xla")
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    gt = torch.nn.functional.normalize(torch.randn((2, 16, 32), generator=gen), dim=-1)
    cos = (torch.rand((2, 16), generator=gen) > 0.3).float()
    rots = TG.random_rotations(11, gen)
    cfg = TP.PriorConfig(num_views=11, view_chunk=4, crop_size=64, render_h=192,
                         render_w=192, dino_dtype="float32")
    radius, _ = TP.mesh_radius_center(verts)
    window = TP.compute_window(cfg, float(TP.mesh_norm_radius(verts)),
                               float(cfg.distance_scale * radius))
    args = (params, dcfg, verts, torch.as_tensor(m.faces), torch.as_tensor(m.face_uvs),
            torch.as_tensor(m.texture), rots, gt, cos, cfg, window)
    before = kernels.depth_fwd.launches
    s_card = TP.prior_scores_batched(*args, host_batch=8, device=cuda)
    assert kernels.depth_fwd.launches - before == 3  # chunks of 4, 4 | 3 views
    s_cpu = TP.prior_scores_batched(*args, host_batch=8, device="cpu")
    torch.testing.assert_close(s_card.cpu(), s_cpu, rtol=0, atol=1e-5)


def _block_views(cuda, b, h, n, seed, dtype=torch.bfloat16):
    """q, k, v and a cotangent as the ViT block makes them: strided views of
    one (B, N, 3, H, 64) projection and of a (B, N, H * 64) gradient."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, 64), generator=gen).to(cuda, dtype)
    g = torch.randn((b, n, h * 64), generator=gen).to(cuda, dtype)
    return (*qkv.permute(2, 0, 3, 1, 4), g.reshape(b, n, h, 64).transpose(1, 2))


def _close(a, ref, tol):
    a, ref = a.float(), ref.float()
    assert bool(torch.isfinite(a).all())
    assert float((a - ref).abs().max()) <= tol * float(ref.abs().max())


DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# o, dq, dk, dv: one bf16 step; f32 sums in another order.
TOLERANCE = {"bf16": 2.0**-7, "f32": 1e-5}
K5_WRAPPERS = (kernels.flash_fwd, kernels.flash_bwd_delta, kernels.flash_bwd_dkv,
               kernels.flash_bwd_dq)
K5_F32_WRAPPERS = (kernels.flash_fwd_f32, kernels.flash_bwd_delta_f32, kernels.flash_bwd_dkv_f32,
                   kernels.flash_bwd_dq_f32)


def _k5_launches():
    return [f.launches for f in K5_WRAPPERS], [f.launches for f in K5_F32_WRAPPERS]


def _k5_ran(before):
    """Launches of the bf16 and of the f32 K5 kernels since ``before``."""
    return tuple([a - b for a, b in zip(x, y)] for x, y in zip(_k5_launches(), before))


# Token counts: one token, short tiles, the edges of the 64-row and 128-row
# tiles (63, 64, 65 is also the prescreen's; 127, 128, 129), several tiles
# with a ragged last one, and the fine step's 1370.
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 127, 128, 129, 200, 333, 1370])
def test_flash_kernels_match_plain_versions(cuda, n, dtype):
    q, k, v, g = _block_views(cuda, 3, 2, n, n, DTYPES[dtype])
    tol = TOLERANCE[dtype]
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, 0.125)
    delta_p = FA.flash_delta_plain(o_p, g)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, 0.125)
    before = _k5_launches()
    o, lse = kernels.flash_fwd(q, k, v, 0.125)
    assert o.transpose(1, 2).is_contiguous() and o.dtype == q.dtype  # written as (B, N, H, 64)
    _close(o, o_p, tol)
    _close(lse, lse_p, 1e-5)
    _close(kernels.flash_bwd_delta(o_p, g), delta_p, 1e-5)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, 0.125)
    dq = kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, 0.125)
    # Each dtype's own kernels and no others.
    one, none = [1] * 4, [0] * 4
    assert _k5_ran(before) == ((one, none) if dtype == "bf16" else (none, one))
    _close(dv, dv_p, tol)
    if n == 1:
        # One key: P = 1, so dS = dP - delta and with it dq and dk are 0 in
        # exact arithmetic; both sides return only the f32 rounding of that
        # difference (a few 1e-7), which no tolerance relative to it can
        # compare.  Both are held to 1e-5 of zero instead.
        for a in (dk, dk_p, dq, dq_p):
            assert float(a.float().abs().max()) <= 1e-5
    else:
        _close(dk, dk_p, tol)
        _close(dq, dq_p, tol)


@pytest.mark.parametrize("n", [31, 32, 33, 95, 96, 97])
def test_f32_flash_kernels_at_their_step_edges(cuda, n):
    """The f32 kernels' own edges (32-token steps of the backward, 64-key
    steps of the forward, 128-row blocks), within 1e-5 of the plain
    versions."""
    q, k, v, g = _block_views(cuda, 2, 3, n, 300 + n, torch.float32)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, 0.125)
    delta_p = FA.flash_delta_plain(o_p, g)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, 0.125)
    o, lse = kernels.flash_fwd_f32(q, k, v, 0.125)
    dk, dv = kernels.flash_bwd_dkv_f32(q, k, v, g, lse_p, delta_p, 0.125)
    dq = kernels.flash_bwd_dq_f32(q, k, v, g, lse_p, delta_p, 0.125)
    for a, ref in ((o, o_p), (lse, lse_p), (dq, dq_p), (dk, dk_p), (dv, dv_p)):
        _close(a, ref, 1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_backward_kernels_are_deterministic(cuda, dtype):
    """Two backward passes without atomics: the same inputs give the same
    bits, run after run."""
    q, k, v, g = _block_views(cuda, 2, 3, 1370, 11, DTYPES[dtype])
    o, lse = kernels.flash_fwd(q, k, v, 0.125)
    delta = kernels.flash_bwd_delta(o, g)
    first = [*kernels.flash_bwd_dkv(q, k, v, g, lse, delta, 0.125),
             kernels.flash_bwd_dq(q, k, v, g, lse, delta, 0.125)]
    for _ in range(2):
        again = [*kernels.flash_bwd_dkv(q, k, v, g, lse, delta, 0.125),
                 kernels.flash_bwd_dq(q, k, v, g, lse, delta, 0.125)]
        for a, b in zip(first, again):
            assert torch.equal(a, b)


FUSED_WRAPPERS = {"bf16": kernels.flash_bwd_fused, "f32": kernels.flash_bwd_fused_f32}


# The fused backward (K5c) at the tile edges of its dK/dV loop (64- and
# 32-query steps, 128-key blocks) and at the fine step's N.
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 31, 33, 63, 64, 65, 127, 128, 129, 333, 1370])
def test_fused_kernel_matches_plain_version(cuda, n, dtype):
    """The partials, their sum, dk and dv within the two-pass kernels'
    tolerances of ``flash_bwd_fused_plain``; a second run gives the same
    bits; the dtype's own fused kernel launches, no other."""
    q, k, v, g = _block_views(cuda, 2, 3, n, 500 + n, DTYPES[dtype])
    tol = TOLERANCE[dtype]
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, 0.125)
    delta_p = FA.flash_delta_plain(o_p, g)
    part_p, dk_p, dv_p = FA.flash_bwd_fused_plain(q, k, v, g, lse_p, delta_p, 0.125)
    before = {name: fn.launches for name, fn in FUSED_WRAPPERS.items()}
    part, dk, dv = kernels.flash_bwd_fused(q, k, v, g, lse_p, delta_p, 0.125)
    again = kernels.flash_bwd_fused(q, k, v, g, lse_p, delta_p, 0.125)
    assert {name: fn.launches - before[name] for name, fn in FUSED_WRAPPERS.items()} == {
        name: 2 if name == dtype else 0 for name in FUSED_WRAPPERS}
    assert part.shape == part_p.shape and part.dtype == q.dtype
    for a, b in zip((part, dk, dv), again):
        assert torch.equal(a, b)
    _close(dv, dv_p, tol)
    if n == 1:  # dS is 0 in exact arithmetic (see above)
        for a in (part, part_p, dk, dk_p):
            assert float(a.float().abs().max()) <= 1e-5
    else:
        _close(part, part_p, tol)
        _close(FA.sum_dq_part(part), FA.sum_dq_part(part_p), tol)
        _close(dk, dk_p, tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_flash_attention_autograd_on_the_card(cuda, dtype):
    """``flash_attention(..., fused_bwd=True)``: the forward, delta and the
    fused kernel once each, no dK/dV or dQ kernel; the same bits from run to
    run; within the dtype's tolerance of the CPU's plain fused backward."""
    q, k, v, g = _block_views(cuda, 2, 2, 300, 8, DTYPES[dtype])
    before = _k5_launches()
    fused_before = FUSED_WRAPPERS[dtype].launches

    def run(q, k, v, g):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = FA.flash_attention(*xs, 0.125, fused_bwd=True)
        o.backward(g)
        return [o.detach()] + [x.grad for x in xs]

    first = run(q, k, v, g)
    ran = [1, 1, 0, 0]
    assert _k5_ran(before) == ((ran, [0] * 4) if dtype == "bf16" else ([0] * 4, ran))
    assert FUSED_WRAPPERS[dtype].launches - fused_before == 1
    for a, b in zip(first, run(q, k, v, g)):
        assert torch.equal(a, b)
    for a, e in zip(first, run(q.cpu(), k.cpu(), v.cpu(), g.cpu())):
        _close(a.cpu(), e, TOLERANCE[dtype])


def test_flash_wrappers_refuse_layouts_tma_cannot_read(cuda):
    """A view whose rows are not 16-byte aligned raises in each wrapper
    before any launch; the launch counts stay as they were."""
    x = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    padded = torch.zeros((1, 2, 8, 68), device=cuda, dtype=torch.bfloat16)[..., :64]
    s = torch.zeros((1, 2, 8), device=cuda)
    wrappers = (kernels.flash_fwd, kernels.flash_bwd_delta, kernels.flash_bwd_dkv,
                kernels.flash_bwd_dq, kernels.flash_bwd_fused)
    before = [f.launches for f in wrappers]
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.flash_fwd(x, padded, x, 0.125)
    with pytest.raises(ValueError, match="16 bytes"):
        kernels.flash_bwd_delta(x, padded)
    for fn in (kernels.flash_bwd_dkv, kernels.flash_bwd_dq, kernels.flash_bwd_fused):
        with pytest.raises(ValueError, match="16 bytes"):
            fn(x, x, x, padded, s, s, 0.125)
    assert [f.launches for f in wrappers] == before


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_autograd_on_the_card(cuda, dtype):
    """The autograd function launches each kernel of its dtype once, is the
    same from run to run, and agrees with the CPU's plain versions; a
    cotangent that autograd expanded (a plain sum's) is taken too."""
    q, k, v, g = _block_views(cuda, 2, 2, 150, 7, DTYPES[dtype])
    before = _k5_launches()

    def run(q, k, v, g):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = FA.flash_attention(*xs, 0.125)
        if g is None:
            o.float().sum().backward()
        else:
            o.backward(g)
        return [o.detach()] + [x.grad for x in xs]

    first, again = run(q, k, v, g), run(q, k, v, g)
    two, none = [2] * 4, [0] * 4
    assert _k5_ran(before) == ((two, none) if dtype == "bf16" else (none, two))
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for a, e in zip(first, run(q.cpu(), k.cpu(), v.cpu(), g.cpu())):
        _close(a.cpu(), e, TOLERANCE[dtype])
    for a, e in zip(run(q, k, v, None), run(q.cpu(), k.cpu(), v.cpu(), None)):
        _close(a.cpu(), e, TOLERANCE[dtype])


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    """f16 and f64 raise in the wrappers and in the autograd function (no
    cast, no plain version on the card), as do mixed dtypes, another head
    dim and a non-contiguous one; no kernel launches."""
    x = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    before = _k5_launches()
    for bad in (torch.float16, torch.float64):
        y = x.to(bad)
        with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
            kernels.flash_fwd(y, y, y, 0.125)
        with pytest.raises(ValueError, match="bfloat16 or torch.float32"):
            FA.flash_attention(y, y, y, 0.125)
    with pytest.raises(ValueError, match="float32"):  # one dtype for q, k and v
        kernels.flash_fwd(x.float(), x, x, 0.125)
    with pytest.raises(ValueError, match="shape"):
        kernels.flash_fwd(x[..., :16], x[..., :16], x[..., :16], 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 64, 8), device=cuda, dtype=torch.bfloat16).transpose(2, 3)
        kernels.flash_fwd(t, t, t, 0.125)
    assert _k5_launches() == before


def test_vit_runs_through_flash_attention(cuda):
    """forward_tokens_from_crop with attn_impl="flash" and "splash": K5's
    forward once per layer, under inference mode too; tokens within bf16's
    reach of the written-out attention."""
    from dynhor_tpu_torch.models import dino as TD

    kw = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=32)
    params = TD.map_params(
        TD.init_params(TD.DinoConfig(**kw), torch.Generator().manual_seed(0)),
        lambda a: a.to(cuda, torch.bfloat16),
    )
    params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    rgb = torch.rand((3, 3, 48, 48), generator=torch.Generator().manual_seed(1)).to(cuda)
    ref = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(attn_impl="xla", **kw)).float()
    for impl in ("flash", "splash"):
        before = kernels.flash_fwd.launches
        with torch.inference_mode():
            tok = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(attn_impl=impl, **kw))
        assert kernels.flash_fwd.launches - before == 2
        assert float((tok.float() - ref).abs().max()) <= 2.0**-5 * float(ref.abs().max())


def test_f32_vit_runs_through_the_f32_kernels(cuda):
    """forward_tokens_from_crop in f32 with attn_impl="flash": the f32 K5
    forward once per layer and no bf16 launch; tokens within 1e-5 of the
    written-out attention's relative to their largest value (TF32 off)."""
    from dynhor_tpu_torch.models import dino as TD

    kw = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=32)
    params = TD.map_params(
        TD.init_params(TD.DinoConfig(**kw), torch.Generator().manual_seed(0)),
        lambda a: a.to(cuda, torch.float32),
    )
    params["blocks"]["ls1"] = torch.ones_like(params["blocks"]["ls1"])
    rgb = torch.rand((3, 3, 48, 48), generator=torch.Generator().manual_seed(1)).to(cuda)
    ref = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(attn_impl="xla", **kw))
    before = _k5_launches()
    with torch.inference_mode():
        tok = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(attn_impl="flash", **kw))
    assert _k5_ran(before) == ([0] * 4, [2, 0, 0, 0])
    assert tok.dtype == torch.float32
    assert float((tok - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_default_refine_step_runs_through_k5(cuda):
    """One fine refine step at the defaults (ViT-B/14 at 518 in bf16, "flash",
    "frozen"): K5's forward once a layer and once more in the recomputed
    backward, its delta, dK/dV and dQ kernels once a layer, nothing of K5c or
    the f32 kernels; the step's losses those of the same step with the
    attention written out, within the refine cell's ``loss_gap`` limit."""
    from dynhor_tpu_torch.models import dino as TD

    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    mesh = TR.MeshArrays(TG.center_and_normalize_verts(torch.as_tensor(m.verts)),
                         torch.as_tensor(m.faces).long(), torch.as_tensor(m.face_uvs),
                         torch.as_tensor(m.texture))
    dcfg = TD.DinoConfig()
    params = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    for k in ("ls1", "ls2"):  # so that the blocks reach the tokens
        params["blocks"][k] = torch.full_like(params["blocks"][k], 0.1)
    gen = torch.Generator().manual_seed(4)
    masks = torch.zeros((2, S, S))
    masks[:, 30:100, 40:90] = 1.0
    gt = torch.randn((2, dcfg.feat_size ** 2, dcfg.embed_dim), generator=gen)
    K = torch.tensor([[S * 1.2, 0, S / 2], [0, S * 1.2, S / 2], [0, 0, 1.0]])
    targets = TR.FrameTargets(masks, gt, K.expand(2, 3, 3).clone())
    rot = TG.rotations_from_uniforms(torch.rand((3, 2), generator=gen)).transpose(1, 2)
    trans = torch.tensor([[0.0, 0.0, 2.5], [0.05, -0.02, 2.6]])
    cfg = TR.RefineConfig(num_iterations=1, crop_size=S, max_faces_per_tile=len(m.faces))

    def step(dino_cfg):
        return TR.refine_poses(mesh, targets, rot, trans, params, dino_cfg, cfg,
                               device=cuda).final_loss.double().cpu()

    fused = (kernels.flash_bwd_fused.launches, kernels.flash_bwd_fused_f32.launches)
    before = _k5_launches()
    loss = step(dcfg)
    assert _k5_ran(before) == ([2 * dcfg.depth] + [dcfg.depth] * 3, [0] * 4)
    assert (kernels.flash_bwd_fused.launches, kernels.flash_bwd_fused_f32.launches) == fused
    before = _k5_launches()
    ref = step(TD.DinoConfig(attn_impl="xla"))
    assert _k5_ran(before) == ([0] * 4, [0] * 4)
    assert bool(torch.isfinite(loss).all())
    scale = torch.maximum(ref.abs(), ref.abs().median())
    assert float(((loss - ref).abs() / scale).max()) <= 3.5e-3


def test_silhouette_kernels_match_plain_versions(shoes):
    vp, faces = shoes
    rows, counts, tw = TK.kernel_inputs(vp, faces, (S, S), max_faces=faces.shape[0])
    assert int(counts.sum()) > 0
    mass = kernels.sil_mass_fwd(rows, counts, 16, tw, 0.25)
    mass_p = TK.tile_mass_plain(rows, counts, 16, tw, 0.25)
    torch.testing.assert_close(torch.exp(-mass), torch.exp(-mass_p), rtol=0, atol=1e-5)
    g = torch.randn(mass.shape, generator=torch.Generator().manual_seed(3)).to(vp.device)
    k2 = kernels.sil_bwd.launches
    dxy = kernels.sil_mass_bwd(rows, counts, g, 16, tw, 0.25)
    assert kernels.sil_bwd.launches == k2  # K4b keeps a count of its own
    dxy_p = TF.tile_mass_grad_plain(rows, counts, g, 16, tw, 0.25)
    torch.testing.assert_close(dxy, dxy_p, rtol=1e-4, atol=1e-5 * float(dxy_p.abs().max()))


def test_soft_silhouette_kernel_autograd_on_the_card(shoes):
    vp, faces = shoes
    w = torch.randn((1, S, S), generator=torch.Generator().manual_seed(4))
    before = (kernels.sil_mass_fwd.launches, kernels.sil_mass_bwd.launches)

    from dynhor_tpu_torch.ops.rasterize_tiled import max_tile_load

    cap = int(max_tile_load(vp, faces, (S, S), margin=6.0 * 0.25 + 1.0).max())

    def run(v, f):
        v = v.detach().clone().requires_grad_(True)
        sil = TK.soft_silhouette_kernel(v, f, (S, S), max_faces=cap)
        (sil * w.to(v.device)).sum().backward()
        return sil.detach().cpu(), v.grad.cpu()

    sil, grad = run(vp, faces)
    assert (kernels.sil_mass_fwd.launches - before[0], kernels.sil_mass_bwd.launches - before[1]) == (1, 1)
    sil_c, grad_c = run(vp.cpu(), faces.cpu())
    torch.testing.assert_close(sil, sil_c, rtol=0, atol=1e-5)
    torch.testing.assert_close(grad, grad_c, rtol=1e-4, atol=1e-5 * float(grad_c.abs().max()))


def test_joint_optimize_launches_k1_k2_once_per_step(cuda):
    from dynhor_tpu_torch.tracker import jointopt as TJ

    gen = torch.Generator().manual_seed(5)
    verts = torch.rand((8, 3), generator=gen) - 0.5
    faces = torch.tensor([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6], [0, 4, 5], [0, 5, 1]])
    masks = torch.zeros((3, 64, 64))
    masks[:, 20:44, 20:44] = 1.0
    K = torch.tensor([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1.0]]).expand(3, 3, 3)
    trans = torch.tensor([[0.0, 0.0, 2.0], [0.05, 0.0, 2.0], [0.1, 0.0, 2.0]])
    k1, k2 = kernels.fused_fwd.launches, kernels.sil_bwd.launches
    res = TJ.joint_optimize(
        verts, faces, torch.eye(3).expand(3, 3, 3), trans, K, masks,
        TJ.JointConfig(num_iterations=5, lr=1e-3, crop_size=64), iters_per_launch=2, device=cuda,
    )
    assert kernels.fused_fwd.launches - k1 == 5 and kernels.sil_bwd.launches - k2 == 5
    assert res.rot6d.is_cuda and all(len(v) == 5 for v in res.history.values())
    assert bool(torch.isfinite(res.history["loss"]).all())


@pytest.mark.parametrize("key", ["A", "B", "C", "D", "E512", "E8192", "F", "G", "H"])
def test_gather_forms_match_plain_versions(cuda, key):
    from dynhor_tpu_torch.tools import probe_gather as PG

    form = {f["key"]: f for f in PG.make_forms(cuda)}[key]
    counter = kernels.take_along_axis if form["op"] == "take" else kernels.scatter_add_axis0
    before = counter.launches
    got = PG.apply(form)
    assert counter.launches == before + 1 and got.is_cuda
    assert PG.agrees(form, got, PG.apply(form, plain=True))
