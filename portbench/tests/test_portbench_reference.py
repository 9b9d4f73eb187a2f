"""Each plain reference against the program's own plain CPU path at a
tiny size: the rasters, the shading, the ViT, and whole runs of each cell,
whose checks then read near zero."""
import pytest
import torch

from portbench import scene as SC
from portbench.reference import raster as RR
from portbench.reference import shading as RS
from portbench.reference import vit as RV
from portbench.tests import tiny


@pytest.fixture(scope="module")
def scene():
    dev = torch.device("cpu")
    mesh = SC.load_mesh(tiny.cell("track.refine16").config, dev)
    gen = SC.generator(2**40 + 3, "scene", dev)
    tex = SC.texture(gen, dev)
    frames = SC.tracker_frames(mesh, tex, 2, 64, 0.3, gen, dev)
    vp = RS.project(mesh.verts @ frames.R_row + frames.t[:, None], frames.K_rois)
    return mesh, tex, frames, vp


def test_hard_raster_matches_the_dense_raster(scene):
    from dynhor_tpu_torch.ops import rasterize as rz

    mesh, _, _, vp = scene
    p2f, zbuf = RR.hard_raster(vp, mesh.faces, (64, 64))
    frag = rz.rasterize(vp, mesh.faces, (64, 64))
    assert torch.equal(p2f.reshape(2, 64, 64), frag.pix_to_face.long())
    hit = p2f >= 0
    assert torch.equal(zbuf[hit], frag.zbuf.reshape(2, -1)[hit])


def test_soft_mass_and_its_gradient_match_the_fused_raster(scene):
    from dynhor_tpu_torch.ops.raster_fused import rasterize_silhouette

    mesh, _, _, vp = scene
    w = torch.rand((2, 64 * 64), generator=torch.Generator().manual_seed(0))
    a = vp.clone().requires_grad_(True)
    sil = 1 - torch.exp(-RR.soft_mass(a, mesh.faces, (64, 64), 0.25))
    (sil * w).sum().backward()
    b = vp.clone().requires_grad_(True)
    _, sil_p, ov = rasterize_silhouette(b, mesh.faces, (64, 64), sigma=0.25, max_faces=5000)
    (sil_p.reshape(2, -1) * w).sum().backward()
    assert int(ov.max()) == 0
    assert (sil - sil_p.reshape(2, -1)).abs().max() < 1e-5
    assert (a.grad - b.grad).abs().max() < 1e-4 * b.grad.abs().max()


def test_tile_loads_match_the_binning(scene):
    from dynhor_tpu_torch.ops.rasterize_tiled import max_tile_load

    mesh, _, _, vp = scene
    loads = RR.tile_loads(vp, mesh.faces, (64, 64), 2.5)
    assert torch.equal(loads.amax(-1), max_tile_load(vp, mesh.faces, (64, 64), 16, margin=2.5).long())


def test_shading_matches_phong_shade(scene):
    from dynhor_tpu_torch.ops import rasterize as rz
    from dynhor_tpu_torch.ops.shading import fine_lights, phong_shade

    mesh, tex, frames, vp = scene
    vc = mesh.verts @ frames.R_row + frames.t[:, None]
    p2f, _ = RR.hard_raster(vp, mesh.faces, (64, 64))
    ref = RS.shade(p2f, vp, vc, mesh.faces, mesh.face_uvs, tex, RS.FINE_LIGHTS, (64, 64))
    frag = rz.rasterize(vp, mesh.faces, (64, 64))
    gx, gy = rz.pixel_centers(64, 64, "cpu")
    bary = rz.barycentrics_at(vp, mesh.faces, frag.pix_to_face.reshape(2, -1), gx, gy)
    frag = frag._replace(bary=(bary * (frag.pix_to_face.reshape(2, -1, 1) >= 0)).reshape(2, 64, 64, 3))
    prog = phong_shade(frag, mesh.faces, vc, rz.compute_vertex_normals(vc, mesh.faces),
                       mesh.face_uvs, tex, fine_lights("cpu"))
    assert (ref - prog).abs().max() < 1e-5


@pytest.mark.parametrize("edge", [32, 16])
def test_vit_matches_the_port(edge):
    from dynhor_tpu_torch.models import dino as D

    cfg = tiny.config("tiny_shoes")
    vit = cfg["vit"]
    params = SC.vit_weights(vit, SC.generator(5, "vit", "cpu"), "cpu", torch.float32)
    dcfg = D.DinoConfig(patch_size=8, embed_dim=64, depth=2, num_heads=1, pos_grid=4,
                        smaller_edge_size=edge)
    rgb = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(1))
    prog = D.forward_tokens_from_crop(params, rgb, dcfg)
    ref = RV.tokens_from_crop(params, rgb, vit, edge)
    assert (prog - ref).abs().max() < 1e-4


@pytest.mark.parametrize("workload", list(tiny.CUTS))
def test_cell_agrees_with_its_reference(workload):
    result = tiny.run(workload)
    assert result["correct"] and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= 0.05 * c["limit"], (name, c)
