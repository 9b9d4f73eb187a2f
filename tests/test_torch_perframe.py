"""A mesh per frame through the port's ops (the pooled multi-sequence
batch): faces (B, F, 3), UVs (B, F, 3, 2) and textures (B, Ht, Wt, 3) or a
``TextureSet`` beside the shared (F, 3) form.

Held: (1) every frame given the same mesh gives exactly the shared form's
outputs (the same arithmetic in the same order), and d(verts) within 1e-6
x max (torch's CPU index backward adds a vertex's face terms in another
order for the (B, F, 3) index than for the (F, 3) one: 1.2e-7 apart on the
plain tiled silhouette, the others equal); (2) two
meshes padded as ``parallel.multiseq.pad_mesh`` pads them (shoes and kettle
subsets, the kettle's padding faces (0, 0, 0) at vertex 0) match the JAX
package's per-frame functions under ``jax.vmap`` (its fused raster in
interpret mode): hard outputs as tests/test_torch_raster.py holds them
(face ids equal except at depth ties, depths and barycentrics within
1e-5), silhouettes within 1e-5, normals within 1e-5 (the normal sums run in
another order than XLA's scatter-add), colours within 1e-5, d(verts)
within rtol 1e-4 and atol 1e-5 x max (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.ops import raster_pallas as JP
from dynhor_tpu.ops import rasterize as JZ
from dynhor_tpu.ops import rasterize_tiled as JT
from dynhor_tpu.ops import shading as JS
from dynhor_tpu.ops import silhouette as JSil
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import rasterize as TZ
from dynhor_tpu_torch.ops import rasterize_tiled as TT
from dynhor_tpu_torch.ops import shading as TS
from dynhor_tpu_torch.ops import silhouette as TSil
from dynhor_tpu_torch.parallel.multiseq import pad_mesh
from dynhor_tpu_torch.utils import geometry as TG
from dynhor_tpu_torch.utils.objio import load_obj

S = 64
SIGMA = 0.25
MARGIN = 6.0 * SIGMA + 1.0


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """Under the suite's parallel workers torch's intra-op threads
    oversubscribe the cores, so this module runs torch on one thread (as
    tests/test_torch_pipeline.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x))


def _subset(mesh, step):
    """Every step-th face of a mesh, its vertices as they are."""
    import dataclasses

    return dataclasses.replace(mesh, faces=mesh.faces[::step], face_uvs=mesh.face_uvs[::step])


@pytest.fixture(scope="module")
def pair():
    """Frame 0: a third of the shoes' faces (textured); frame 1: half the
    kettle's (untextured), padded to the shoes' vertex and face counts."""
    shoes = _subset(load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"), 3)
    kettle = _subset(load_obj("assets/kettle/kettle.obj"), 2)
    meshes = []
    for m in (shoes, kettle):
        v = TG.center_and_normalize_verts(torch.as_tensor(m.verts)).numpy()
        meshes.append(pad_mesh(
            type(m)(verts=v, faces=m.faces, face_uvs=m.face_uvs, texture=m.texture,
                    has_texture=m.has_texture),
            max(shoes.verts.shape[0], kettle.verts.shape[0]),
            max(shoes.faces.shape[0], kettle.faces.shape[0]),
        ))
    rng = np.random.default_rng(3)
    R = TG.rotations_from_uniforms(torch.as_tensor(rng.random((3, 2), dtype=np.float32)))
    K = torch.tensor([[S * 1.1, 0, S / 2], [0, S * 1.1, S / 2], [0, 0, 1.0]])
    verts = torch.stack([torch.as_tensor(m.verts) for m in meshes])
    vc = verts @ R + torch.tensor([0.0, 0.0, 2.0])
    vp = TZ.project_perspective(vc, K)
    faces = torch.stack([torch.as_tensor(m.faces) for m in meshes]).long()
    uvs = torch.stack([torch.as_tensor(m.face_uvs) for m in meshes])
    ht = max(m.texture.shape[0] for m in meshes)
    wt = max(m.texture.shape[1] for m in meshes)
    tex = np.ones((2, ht, wt, 3), np.float32)
    for i, m in enumerate(meshes):
        tex[i, : m.texture.shape[0], : m.texture.shape[1]] = m.texture
    cap = -(-int(TT.max_tile_load(vp, faces, (S, S), margin=MARGIN).max()) // 128) * 128
    assert int((faces[1] == 0).all(-1).sum()) > 0  # the kettle has padding faces
    return dict(vc=vc, vp=vp, faces=faces, uvs=uvs, tex=torch.as_tensor(tex), cap=cap)


def _grad(fn, v):
    v = v.detach().clone().requires_grad_(True)
    out = fn(v)
    w = torch.cos(torch.arange(out.numel(), dtype=torch.float32) * 0.01).reshape(out.shape)
    (out * w).sum().backward()
    return out.detach(), v.grad


def _rasters(cap):
    """(name, fn(vp, faces) -> a float map) of each rasterizer."""

    def fused(vp, faces):
        frag, sil, ov = TF.rasterize_silhouette(vp, faces, (S, S), sigma=SIGMA, max_faces=cap)
        assert int(ov.max()) == 0
        return torch.cat([sil, frag.bary.sum(-1), frag.zbuf, frag.pix_to_face.float()], -1)

    def fused_compact(vp, faces):
        out = TF.rasterize_silhouette(vp, faces, (S, S), sigma=SIGMA, max_faces=cap,
                                      max_active_tiles=8, return_compact=True)
        return torch.cat([out[1], out[3].bary.sum(-1).reshape(vp.shape[0], S, -1)], -1)

    def dense(vp, faces):
        frag = TZ.rasterize(vp, faces, (S, S), face_chunk=512)
        sil = TSil.soft_silhouette(vp, faces, (S, S), sigma=SIGMA, face_chunk=512)
        return torch.cat([sil, frag.bary.sum(-1), frag.zbuf, frag.pix_to_face.float()], -1)

    def tiled(vp, faces):
        frag = TT.rasterize_tiled(vp, faces, (S, S), max_faces=cap)
        sil = TT.soft_silhouette_tiled(vp, faces, (S, S), sigma=SIGMA, max_faces=cap)
        return torch.cat([sil, frag.bary.sum(-1), frag.zbuf, frag.pix_to_face.float()], -1)

    return {"fused": fused, "fused_compact": fused_compact, "dense": dense, "tiled": tiled}


@pytest.mark.parametrize("name", ["fused", "fused_compact", "dense", "tiled", "normals",
                                  "shading", "shading_tiles", "bins"])
def test_same_mesh_per_frame_equals_shared(pair, name):
    """Each frame given frame 0's mesh: the per-frame form's outputs are the
    shared form's, bit for bit, and its d(verts) within 1e-6 x max."""
    vp = pair["vp"][:1].expand(2, -1, -1) * torch.tensor([[[1.0, 1.0, 1.0]], [[1.01, 0.99, 1.0]]])
    shared, per = pair["faces"][0], pair["faces"][:1].expand(2, -1, -1)
    if name == "bins":
        a = TT.bin_faces_and_inverse(vp, shared, (S, S), 16, pair["cap"], MARGIN, 32)
        b = TT.bin_faces_and_inverse(vp, per, (S, S), 16, pair["cap"], MARGIN, 32)
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            assert torch.equal(x, y)
        for fn in (TT.max_tile_load, TT.max_active_tiles_load):
            assert torch.equal(fn(vp, shared, (S, S), margin=MARGIN), fn(vp, per, (S, S), margin=MARGIN))
        return
    if name == "normals":
        fns = {"s": lambda v: TZ.compute_vertex_normals(v, shared),
               "p": lambda v: TZ.compute_vertex_normals(v, per)}
        v0 = pair["vc"][:1].expand(2, -1, -1) * 1.0
    elif name in ("shading", "shading_tiles"):
        frag = TZ.rasterize(vp, shared, (S, S), face_chunk=512)
        compact = TF.rasterize_silhouette(vp, shared, (S, S), sigma=SIGMA, max_faces=pair["cap"],
                                          max_active_tiles=8, return_compact=True)[3]
        uvs, tex = pair["uvs"][0], pair["tex"][0]
        set_ = TS.TextureSet(pair["tex"][:1], torch.zeros(2, dtype=torch.int64))

        def shade(v, faces, u, t):
            vn = TZ.compute_vertex_normals(v, faces)
            if name == "shading_tiles":
                return TS.phong_shade_tiles(compact._replace(bary=compact.bary.detach()), (S, S),
                                            16, faces, v, vn, u, t, TS.fine_lights("cpu"))
            return TS.phong_shade(frag, faces, v, vn, u, t, TS.fine_lights("cpu"))

        fns = {"s": lambda v: shade(v, shared, uvs, tex),
               "p": lambda v: shade(v, per, uvs[None].expand(2, -1, -1, -1), set_),
               "p4": lambda v: shade(v, per, uvs[None].expand(2, -1, -1, -1),
                                     tex[None].expand(2, -1, -1, -1))}
        v0 = pair["vc"][:1].expand(2, -1, -1) * 1.0
    else:
        fn = _rasters(pair["cap"])[name]
        fns = {"s": lambda v: fn(v, shared), "p": lambda v: fn(v, per)}
        v0 = vp
    want, g_want = _grad(fns.pop("s"), v0)
    assert float(g_want.abs().sum()) > 0.0
    for got, g_got in (_grad(f, v0) for f in fns.values()):
        assert torch.equal(got, want)
        np.testing.assert_allclose(g_got.numpy(), g_want.numpy(), rtol=0,
                                   atol=1e-6 * float(g_want.abs().max()))


def _frags_close(pj, zj, bj, ft):
    pt, zt = ft.pix_to_face.numpy(), ft.zbuf.detach().numpy()
    diff = pj != pt
    assert (diff <= ((pj >= 0) & (pt >= 0) & (np.abs(zj - zt) <= 1e-6))).all()
    np.testing.assert_allclose(zt, zj, atol=1e-5)
    np.testing.assert_allclose(ft.bary.detach().numpy(), bj, atol=1e-5)


def _grad_close(gt, gj):
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())


@pytest.mark.parametrize("name", ["fused", "dense", "tiled"])
def test_two_padded_meshes_match_jax_vmap(pair, name):
    vp, faces, cap = pair["vp"].numpy(), pair["faces"].numpy().astype(np.int32), pair["cap"]
    weight = np.cos(np.arange(2 * S * S, dtype=np.float32).reshape(2, S, S) * 0.01)

    def one(v, f):
        if name == "fused":
            frag, sil, ov = JP.rasterize_silhouette_pallas(v, f, (S, S), sigma=SIGMA, max_faces=cap)
            return frag, sil, ov
        if name == "dense":
            frag = JZ.rasterize(v, f, (S, S), face_chunk=512)
            return frag, JSil.soft_silhouette(v, f, (S, S), sigma=SIGMA, face_chunk=512), 0
        frag = JT.rasterize_tiled(v, f, (S, S), max_faces=cap)
        return frag, JT.soft_silhouette_tiled(v, f, (S, S), sigma=SIGMA, max_faces=cap), 0

    def loss_j(v):
        frag, sil, ov = jax.vmap(one)(v, jnp.asarray(faces))
        return (sil * weight).sum(), (frag, sil, ov)

    (_, (frag_j, sil_j, ov_j)), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jnp.asarray(vp))
    assert int(np.max(ov_j)) == 0

    v = _t(vp).requires_grad_(True)
    ft = _t(faces).long()
    if name == "fused":
        frag_t, sil_t, ov_t = TF.rasterize_silhouette(v, ft, (S, S), sigma=SIGMA, max_faces=cap)
        assert int(ov_t.max()) == 0
    elif name == "dense":
        frag_t = TZ.rasterize(v, ft, (S, S), face_chunk=512)
        sil_t = TSil.soft_silhouette(v, ft, (S, S), sigma=SIGMA, face_chunk=512)
    else:
        frag_t = TT.rasterize_tiled(v, ft, (S, S), max_faces=cap)
        sil_t = TT.soft_silhouette_tiled(v, ft, (S, S), sigma=SIGMA, max_faces=cap)
    (sil_t * _t(weight)).sum().backward()
    assert int((frag_t.pix_to_face >= 0).sum(dim=(1, 2)).min()) > 100  # both frames drawn
    _frags_close(np.asarray(frag_j.pix_to_face), np.asarray(frag_j.zbuf), np.asarray(frag_j.bary),
                 frag_t)
    np.testing.assert_allclose(sil_t.detach().numpy(), np.asarray(sil_j), atol=1e-5)
    _grad_close(v.grad.numpy(), np.asarray(g_j))


def test_bins_and_loads_match_jax_vmap(pair):
    vp, faces, cap = pair["vp"], pair["faces"], pair["cap"]
    jv, jf = jnp.asarray(vp.numpy()), jnp.asarray(faces.numpy().astype(np.int32))
    bins_j = jax.vmap(lambda v, f: JT.bin_faces(v, f, (S, S), 16, cap, margin=MARGIN))(jv, jf)
    bins_t = TT.bin_faces(vp, faces, (S, S), 16, cap, margin=MARGIN)
    np.testing.assert_array_equal(bins_t.indices.numpy(), np.asarray(bins_j.indices))
    np.testing.assert_array_equal(bins_t.valid.numpy(), np.asarray(bins_j.valid))
    np.testing.assert_array_equal(bins_t.overflow.numpy(), np.asarray(bins_j.overflow))
    for fn_t, fn_j in ((TT.max_tile_load, JT.max_tile_load),
                       (TT.max_active_tiles_load, JT.max_active_tiles_load)):
        want = jax.vmap(lambda v, f: fn_j(v, f, (S, S), margin=MARGIN))(jv, jf)
        np.testing.assert_array_equal(fn_t(vp, faces, (S, S), margin=MARGIN).numpy(),
                                      np.asarray(want))


def test_normals_and_shading_match_jax_vmap(pair):
    """compute_vertex_normals and phong_shade (through a TextureSet) of the
    two padded meshes against the JAX functions under vmap, with d(verts)."""
    vc, faces, uvs, tex = pair["vc"], pair["faces"], pair["uvs"], pair["tex"]
    frag = TZ.rasterize(pair["vp"], faces, (S, S), face_chunk=512)
    weight = np.sin(np.arange(2 * S * S * 4, dtype=np.float32) * 0.01).reshape(2, S, S, 4)
    jf, ju, jt = (jnp.asarray(x.numpy()) for x in (faces.int(), uvs, tex))
    frag_j = JZ.Fragments(*(jnp.asarray(x.numpy()) for x in frag))

    def one(v, f, u, t, fr):
        vn = JZ.compute_vertex_normals(v, f)
        return vn, JS.phong_shade(fr, f, v, vn, u, t, JS.fine_lights())

    def loss_j(v):
        vn, rgba = jax.vmap(one)(v, jf, ju, jt, frag_j)
        return (rgba * weight).sum(), (vn, rgba)

    (_, (vn_j, rgba_j)), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        jnp.asarray(vc.numpy()))
    v = vc.clone().requires_grad_(True)
    vn = TZ.compute_vertex_normals(v, faces)
    rgba = TS.phong_shade(frag, faces, v, vn, uvs, TS.TextureSet(tex, torch.arange(2)),
                          TS.fine_lights("cpu"))
    (rgba * _t(weight)).sum().backward()
    assert float(rgba[..., 3].detach().sum()) > 200.0
    np.testing.assert_allclose(vn.detach().numpy(), np.asarray(vn_j), atol=1e-5)
    np.testing.assert_allclose(rgba.detach().numpy(), np.asarray(rgba_j), atol=1e-5)
    _grad_close(v.grad.numpy(), np.asarray(g_j))
