"""Port Phong shading vs the JAX package on the same fragments: the dense
``phong_shade`` and the active-tile ``phong_shade_tiles``, forward within
1e-5 and d(loss)/d(camera-space verts, barycentrics) within rtol 1e-4 and
atol 1e-5 x max (f32 sums in another order).  The textured shoes mesh
exercises the UV sampling."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.ops import raster_pallas as JP
from dynhor_tpu.ops import rasterize as JZ
from dynhor_tpu.ops import rasterize_tiled as JT
from dynhor_tpu.ops import shading as JS
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils.objio import load_obj
from dynhor_tpu_torch.ops import rasterize as TZ
from dynhor_tpu_torch.ops import raster_fused as TF
from dynhor_tpu_torch.ops import shading as TS

S = 64


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def scene():
    m = load_obj("assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj")
    verts = JG.center_and_normalize_verts(jnp.asarray(m.verts))
    R = JG.random_rotations(jax.random.PRNGKey(1), 1)[0]
    vc = verts @ R + jnp.array([0.0, 0.0, 2.0])
    K = jnp.array([[S * 1.2, 0, S / 2], [0, S * 1.2, S / 2], [0, 0, 1.0]])
    vp = JZ.project_perspective(vc, K)
    faces = jnp.asarray(m.faces)
    margin = 6.0 * 0.25 + 1.0
    cap = -(-int(JT.max_tile_load(vp, faces, (S, S), margin=margin)) // 128) * 128
    n_act = int(JT.max_active_tiles_load(vp, faces, (S, S), margin=margin))
    frag, _, ov, compact = JP.rasterize_silhouette_pallas(
        vp, faces, (S, S), max_faces=cap, max_active_tiles=n_act + 4, return_compact=True
    )
    assert int(ov) == 0 and compact is not None
    return dict(
        vc=np.asarray(vc), faces=np.asarray(m.faces), uvs=m.face_uvs, tex=m.texture,
        frag=frag, compact=compact,
    )


def test_vertex_normals_match(scene):
    vn_j = JZ.compute_vertex_normals(jnp.asarray(scene["vc"]), jnp.asarray(scene["faces"]))
    vn_t = TZ.compute_vertex_normals(_t(scene["vc"])[None], _t(scene["faces"]))
    np.testing.assert_allclose(vn_t[0].numpy(), np.asarray(vn_j), atol=1e-5)


@pytest.mark.parametrize("tiled", [False, True])
def test_phong_shade_matches(scene, tiled):
    faces, uvs, tex = scene["faces"], scene["uvs"], scene["tex"]
    weight = np.sin(np.arange(S * S * 4, dtype=np.float32) * 0.01).reshape(S, S, 4)
    frag_j, comp_j = scene["frag"], scene["compact"]
    bary0 = np.asarray(comp_j.bary if tiled else frag_j.bary)

    def render_j(v, bary):
        vn = JZ.compute_vertex_normals(v, jnp.asarray(faces))
        args = (jnp.asarray(faces), v, vn, jnp.asarray(uvs), jnp.asarray(tex), JS.fine_lights())
        if tiled:
            return JS.phong_shade_tiles(comp_j._replace(bary=bary), (S, S), 16, *args)
        return JS.phong_shade(frag_j._replace(bary=bary), *args)

    def loss_j(v, bary):
        rgba = render_j(v, bary)
        return (rgba * weight).sum(), rgba

    (_, rgba_j), (gv_j, gb_j) = jax.jit(
        jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)
    )(jnp.asarray(scene["vc"]), jnp.asarray(bary0))

    v = _t(scene["vc"])[None].requires_grad_(True)
    bary = _t(bary0)[None].requires_grad_(True)
    vn = TZ.compute_vertex_normals(v, _t(faces))
    args = (_t(faces), v, vn, _t(uvs), _t(tex), TS.fine_lights("cpu"))
    if tiled:
        comp_t = TF.CompactTiles(
            _t(comp_j.act_ids)[None].long(), _t(comp_j.fid)[None], bary
        )
        rgba_t = TS.phong_shade_tiles(comp_t, (S, S), 16, *args)
    else:
        frag_t = TZ.Fragments(_t(frag_j.pix_to_face)[None], bary, _t(frag_j.zbuf)[None])
        rgba_t = TS.phong_shade(frag_t, *args)
    (rgba_t[0] * _t(weight)).sum().backward()

    assert float(rgba_t[0, ..., 3].sum()) > 100.0  # plenty of hit pixels
    np.testing.assert_allclose(rgba_t[0].detach().numpy(), np.asarray(rgba_j), atol=1e-5)
    for gt, gj in ((v.grad[0], gv_j), (bary.grad[0], gb_j)):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4, atol=1e-5 * np.abs(gj).max())
