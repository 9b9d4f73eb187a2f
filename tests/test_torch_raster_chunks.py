"""The merge rule of K1's and K2's work list, on the CPU: the plain
versions of ops/raster_fused take their slots ``chunk`` at a time and merge
the chunks as the kernels merge their work items (masses summed in chunk
order, a chunk's depth and slot taken only where strictly smaller), so
zbuf and pix_to_face do not depend on the chunk size, and the mass and the
xy gradients move only by the rounding of another summation order.

Cases: the fused raster's rows of a tenth of the shoes mesh's faces at
64², and a crafted row whose equal depths lie in two chunks (the first
slot must win).
Tolerances: zbuf and pix_to_face exactly; d(xy) within 1e-6 x max (each
slot's sums do not change with the chunk); mass within 1e-6 relative, or
within n x 2^-24 where the chunks are so small that a pixel's mass is a
sum of n = ceil(count / chunk) chunk sums taken one after another, the
first-order bound of that sequential f32 sum of positive terms (chunk 1:
n is the largest count).
"""
import numpy as np
import pytest
import torch

from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
from dynhor_tpu_torch.ops.rasterize_tiled import max_tile_load
from dynhor_tpu_torch.utils import geometry as TG
from dynhor_tpu_torch.utils.objio import load_obj

S = 64


def _shoes_rows():
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = TG.center_and_normalize_verts(torch.as_tensor(m.verts))
    x = torch.as_tensor(np.random.default_rng(0).random((3, 2), dtype=np.float32))
    K = torch.tensor([[S * 1.2, 0, S / 2], [0, S * 1.2, S / 2], [0, 0, 1.0]])
    R = TG.rotations_from_uniforms(x)
    vp = TZ.project_perspective(verts @ R + torch.tensor([0.0, 0.0, 2.0]), K)
    faces = torch.as_tensor(m.faces).long()[::10]  # a tenth of the faces keeps chunk 1 cheap
    cap = int(max_tile_load(vp, faces, (S, S), margin=6.0 * 0.25 + 1.0).max())
    rows, counts, tw = TF.kernel_inputs(vp, faces, (S, S), max_faces=cap)
    return rows, counts, tw


def _tie_row():
    """One tile row of 160 random faces; slot 20's face covers the tile in
    front of every other and is copied to slots 40, 140 and 159, so at
    every chunk size but 160 two equal depths meet across a chunk edge."""
    rng = np.random.default_rng(4)
    m = 160
    rec = np.zeros((1, 1, m, 16), np.float32)
    tri = rng.uniform(-4.0, 20.0, (m, 1, 2)) + rng.uniform(-7.0, 7.0, (m, 3, 2))
    rec[0, 0, :, 0:6] = tri.reshape(m, 6)
    rec[0, 0, :, 6] = rng.random(m) > 0.1
    rec[0, 0, :, 8:11] = rng.uniform(0.5, 3.0, (m, 3))
    rec[0, 0, 20, 0:11] = [-20, -20, 60, -20, -20, 60, 1, 0, 0.1, 0.1, 0.1]
    rec[0, 0, [40, 140, 159]] = rec[0, 0, 20]
    return torch.as_tensor(rec), torch.tensor([[m]], dtype=torch.int32), 1


@pytest.fixture(scope="module", params=["shoes", "tie"])
def scene(request):
    rows, counts, tw = _shoes_rows() if request.param == "shoes" else _tie_row()
    g = torch.randn(rows.shape[:2] + (256,), generator=torch.Generator().manual_seed(1))
    m = rows.shape[2]
    ref = (
        TF.tile_mass_depth_plain(rows, counts, 16, tw, 0.25, 1e-2, chunk=m),
        TF.tile_mass_grad_plain(rows, counts, g, 16, tw, 0.25, chunk=m),
    )
    return request.param, rows, counts, tw, g, ref


@pytest.mark.parametrize("chunk", [1, 32, 128, "m"])
def test_plain_merge_rule_does_not_depend_on_the_chunk(scene, chunk):
    name, rows, counts, tw, g, ((mass_r, zmin_r, jbest_r), dxy_r) = scene
    chunk = rows.shape[2] if chunk == "m" else chunk
    mass, zmin, jbest = TF.tile_mass_depth_plain(rows, counts, 16, tw, 0.25, 1e-2, chunk=chunk)
    dxy = TF.tile_mass_grad_plain(rows, counts, g, 16, tw, 0.25, chunk=chunk)
    assert bool((zmin_r < 1e38).any())
    assert torch.equal(zmin, zmin_r) and torch.equal(jbest, jbest_r)
    n = -(-int(counts.max()) // chunk)  # chunk sums added one after another
    mass_tol = max(1e-6, n * 2.0**-24)
    assert float(((mass - mass_r).abs() / mass_r.abs().clamp_min(1.0)).max()) <= mass_tol
    assert float((dxy - dxy_r).abs().max()) <= 1e-6 * float(dxy_r.abs().max())
    if name == "tie":
        assert bool((jbest == 20).all())  # the face covers the tile; its first slot wins
