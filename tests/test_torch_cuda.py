"""The CUDA kernels against their plain PyTorch versions, on the card.

Run where a card is present: ``python -m pytest -m cuda tests/test_torch_*.py``.
Without one every test here skips (the card is looked for in a fixture, so
every pytest worker collects the same tests).

Tolerances: K1's silhouette and depths within 1e-5 and its hard outputs
(hit mask, winning slot) equal — the kernel rounds like the plain version
(no FMA contraction beyond the explicit ones); K2's d(xy) within rtol 1e-4
and atol 1e-5 x max (f32 sums in another order).
"""
import numpy as np
import pytest
import torch

from dynhor_tpu_torch import kernels
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
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
