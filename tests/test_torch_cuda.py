"""The CUDA kernels against their plain PyTorch versions, on the card.

Run where a card is present: ``python -m pytest -m cuda tests/test_torch_*.py``.
Without one every test here skips (the card is looked for in a fixture, so
every pytest worker collects the same tests).

Tolerances: K1's silhouette and depths within 1e-5 and its hard outputs
(hit mask, winning slot) equal — the kernel rounds like the plain version
(no FMA contraction beyond the explicit ones); K2's d(xy) within rtol 1e-4
and atol 1e-5 x max (f32 sums in another order).  K3's depths within
1e-5 and its hit mask and winning slot equal, as K1's; the prior scores of
the card and the CPU within 1e-5 (f32 ViT, TF32 off).  K5's o, dq, dk and dv
within 2^-7 of the largest value (one bf16 step where the kernel and the
plain version land on either side of a rounding boundary), its f32
log-sum-exp and delta within 1e-5 of theirs.
"""
import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import flash_attention as FA
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
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
    rows, counts, tw, _, _ = TF.depth_inputs(vp, faces, (window, window), max_faces=cap)
    zmin, jbest = kernels.depth_fwd(rows, counts, 16, tw, 1e-2)
    zmin_p, jbest_p = TF.tile_depth_plain(rows, counts, 16, tw, 1e-2)
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
    dcfg = TD.DinoConfig(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4,
                         smaller_edge_size=32)
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


def _block_views(cuda, b, h, n, seed):
    """q, k, v and a cotangent as the ViT block makes them: strided views of
    one (B, N, 3, H, 64) projection and of a (B, N, H * 64) gradient, bf16."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, 64), generator=gen).to(cuda, torch.bfloat16)
    g = torch.randn((b, n, h * 64), generator=gen).to(cuda, torch.bfloat16)
    return (*qkv.permute(2, 0, 3, 1, 4), g.reshape(b, n, h, 64).transpose(1, 2))


def _close(a, ref, tol):
    a, ref = a.float(), ref.float()
    assert bool(torch.isfinite(a).all())
    assert float((a - ref).abs().max()) <= tol * float(ref.abs().max())


# Token counts: one short tile, a full tile, one more than a tile, the
# prescreen's 65, and several tiles with a ragged last one.
@pytest.mark.parametrize("n", [5, 64, 65, 200, 333])
def test_flash_kernels_match_plain_versions(cuda, n):
    q, k, v, g = _block_views(cuda, 3, 2, n, n)
    o_p, lse_p = FA.flash_fwd_plain(q, k, v, 0.125)
    delta_p = FA.flash_delta_plain(o_p, g)
    dq_p, dk_p, dv_p = FA.flash_bwd_plain(q, k, v, g, lse_p, delta_p, 0.125)
    o, lse = kernels.flash_fwd(q, k, v, 0.125)
    assert o.transpose(1, 2).is_contiguous()  # written as (B, N, H, 64)
    _close(o, o_p, 2.0**-7)
    _close(lse, lse_p, 1e-5)
    _close(kernels.flash_bwd_delta(o_p, g), delta_p, 1e-5)
    dk, dv = kernels.flash_bwd_dkv(q, k, v, g, lse_p, delta_p, 0.125)
    _close(dk, dk_p, 2.0**-7)
    _close(dv, dv_p, 2.0**-7)
    _close(kernels.flash_bwd_dq(q, k, v, g, lse_p, delta_p, 0.125), dq_p, 2.0**-7)


def test_flash_attention_autograd_on_the_card(cuda):
    """The autograd function launches each kernel once, is the same from run
    to run, and agrees with the CPU's plain versions; a cotangent that
    autograd expanded (a plain sum's) is taken too."""
    q, k, v, g = _block_views(cuda, 2, 2, 150, 7)
    before = [f.launches for f in (kernels.flash_fwd, kernels.flash_bwd_delta,
                                   kernels.flash_bwd_dkv, kernels.flash_bwd_dq)]

    def run(q, k, v, g):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        o = FA.flash_attention(*xs, 0.125)
        if g is None:
            o.float().sum().backward()
        else:
            o.backward(g)
        return [o.detach()] + [x.grad for x in xs]

    first, again = run(q, k, v, g), run(q, k, v, g)
    after = [f.launches for f in (kernels.flash_fwd, kernels.flash_bwd_delta,
                                  kernels.flash_bwd_dkv, kernels.flash_bwd_dq)]
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 2]
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    for a, e in zip(first, run(q.cpu(), k.cpu(), v.cpu(), g.cpu())):
        _close(a.cpu(), e, 2.0**-7)
    for a, e in zip(run(q, k, v, None), run(q.cpu(), k.cpu(), v.cpu(), None)):
        _close(a.cpu(), e, 2.0**-7)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    before = kernels.flash_fwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        kernels.flash_fwd(x.float(), x.float(), x.float(), 0.125)
    with pytest.raises(ValueError, match="shape"):
        kernels.flash_fwd(x[..., :16], x[..., :16], x[..., :16], 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 2, 64, 8), device=cuda, dtype=torch.bfloat16).transpose(2, 3)
        kernels.flash_fwd(t, t, t, 0.125)
    with pytest.raises(ValueError, match="bfloat16"):  # no quiet cast, no plain version
        FA.flash_attention(x.float(), x.float(), x.float(), 0.125)
    assert kernels.flash_fwd.launches == before


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
    ref = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(**kw)).float()
    for impl in ("flash", "splash"):
        before = kernels.flash_fwd.launches
        with torch.inference_mode():
            tok = TD.forward_tokens_from_crop(params, rgb, TD.DinoConfig(attn_impl=impl, **kw))
        assert kernels.flash_fwd.launches - before == 2
        assert float((tok.float() - ref).abs().max()) <= 2.0**-5 * float(ref.abs().max())
