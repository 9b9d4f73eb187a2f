"""Port utils vs the JAX package: geometry, camera, masks, resize, OBJ IO.
Same numpy inputs through both; f32 tolerances stated per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.ops import resize as JR
from dynhor_tpu.utils import camera as JC
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.utils import masks as JM
from dynhor_tpu.utils import objio as JO
from dynhor_tpu_torch.ops import resize as TR
from dynhor_tpu_torch.utils import camera as TC
from dynhor_tpu_torch.utils import geometry as TG
from dynhor_tpu_torch.utils import masks as TM
from dynhor_tpu_torch.utils import objio as TO

SHOES = "assets/shoes/1229a2e6e97e_A_basketball_shoes_.obj"


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("shape", [(5, 3, 2), (4, 6)])
def test_rot6d_round_trip_matches(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    Rj = np.asarray(JG.rot6d_to_matrix(jnp.asarray(x)))
    Rt = TG.rot6d_to_matrix(_t(x)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_array_equal(
        TG.matrix_to_rot6d(_t(Rj)).numpy(), np.asarray(JG.matrix_to_rot6d(jnp.asarray(Rj)))
    )


def test_random_rotations_from_the_same_uniforms():
    # JAX's sampler draws its uniforms from a key; hand the port the very
    # same draws (PRNG streams are never compared).
    key = jax.random.PRNGKey(3)
    x = np.asarray(jax.random.uniform(key, (3, 7)))
    Rj = np.asarray(JG.random_rotations(key, 7))
    Rt = TG.rotations_from_uniforms(_t(x)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    Rg = TG.random_rotations(7, torch.Generator().manual_seed(0))
    eye = Rg @ Rg.transpose(1, 2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), (7, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(torch.linalg.det(Rg).numpy(), 1.0, atol=1e-5)


def test_center_normalize_and_obj_copy():
    mj, mt = JO.load_obj(SHOES), TO.load_obj(SHOES)
    for a, b in zip(
        (mj.verts, mj.faces, mj.face_uvs, mj.texture), (mt.verts, mt.faces, mt.face_uvs, mt.texture)
    ):
        np.testing.assert_array_equal(a, b)
    vj = np.asarray(JG.center_and_normalize_verts(jnp.asarray(mj.verts)))
    vt = TG.center_and_normalize_verts(_t(mt.verts)).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-6)


def test_project_ndc_and_mask_iou():
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((2, 50, 3)) * 0.3 + [0, 0, 2]).astype(np.float32)
    K01 = np.tile(np.array([[1.2, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (2, 1, 1))
    np.testing.assert_allclose(
        TC.project_ndc(_t(v), _t(K01)).numpy(),
        np.asarray(JC.project_ndc(jnp.asarray(v), jnp.asarray(K01))),
        rtol=1e-6, atol=1e-6,
    )
    a = rng.random((3, 16, 16)).astype(np.float32)
    b = (rng.random((3, 16, 16)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        TM.batch_mask_iou(_t(a), _t(b)).numpy(),
        np.asarray(JM.batch_mask_iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6,
    )


@pytest.mark.parametrize("sizes", [(256, 518), (37, 40), (4, 3), (9, 9)])
def test_resize_matrices_and_nearest(sizes):
    n_in, n_out = sizes
    np.testing.assert_array_equal(
        TR._bicubic_matrix_ac(n_in, n_out), JR._bicubic_matrix_ac(n_in, n_out)
    )
    np.testing.assert_array_equal(
        TR._bicubic_matrix_halfpix(n_in, n_out), JR._bicubic_matrix_halfpix(n_in, n_out)
    )
    img = np.random.default_rng(2).random((2, n_in, n_in + 1)).astype(np.float32)
    np.testing.assert_array_equal(
        TR.resize_nearest(_t(img), n_out, n_out).numpy(),
        np.asarray(JR.resize_nearest(jnp.asarray(img), n_out, n_out)),
    )
    np.testing.assert_allclose(
        TR.resize_bicubic_halfpix(_t(img), n_out, n_out).numpy(),
        np.asarray(JR.resize_bicubic_halfpix(jnp.asarray(img), n_out, n_out)),
        atol=1e-5,
    )
