"""Port utils vs the JAX package: geometry (rot6d, sampling, the prior
grid's look-at views and rolls, quaternions), camera, masks, resize, boxes,
the host ROI path, OBJ IO.  Same numpy inputs through both; f32 tolerances
stated per test."""
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


# The reference's grid (render.py:95-123, 221-234; io/config.py prior.grid)
# and smaller ones: look-at views times in-plane rolls within 1e-6.
@pytest.mark.parametrize("grid", [(30, 10, 13), (6, 3, 1), (4, 3, 2), (1, 1, 3)])
def test_grid_rotations_match(grid):
    na, ne, nr = grid
    got = torch.einsum("rij,njk->rnik", TG.roll_matrices(nr), TG.spherical_camera_rotations(na, ne))
    want = jnp.einsum("rij,njk->rnik", JG.roll_matrices(nr), JG.spherical_camera_rotations(na, ne))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    R = got.reshape(-1, 3, 3)
    np.testing.assert_allclose(R @ R.transpose(1, 2), torch.eye(3).expand_as(R), atol=1e-6)
    np.testing.assert_allclose(torch.linalg.det(R), 1.0, atol=1e-6)


def test_look_at_rotation_matches_including_the_poles():
    pos = np.array([[0.3, -1.0, 2.0], [0.0, 5.0, 0.0], [0.0, -2.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    at = np.array([[0.1, 0.2, -0.3]], np.float32)
    got = TG.look_at_rotation(_t(pos), _t(at)).numpy()
    np.testing.assert_allclose(got, np.asarray(JG.look_at_rotation(jnp.asarray(pos), jnp.asarray(at))),
                               atol=1e-6)


def test_quaternion_helpers_match():
    """Shepperd's method on random rotations and on the branch edges (the
    identity, 180-degree turns about each axis), the matrix of a
    quaternion, and slerp at 0, 1/3, 1 and between near-equal quaternions:
    within 1e-6."""
    R = np.asarray(JG.random_rotations(jax.random.PRNGKey(0), 32))
    edge = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                     np.diag([-1.0, -1.0, 1.0])]).astype(np.float32)
    R = np.concatenate([R, edge])
    q_t = TG.matrix_to_quaternion(_t(R))
    q_j = np.asarray(JG.matrix_to_quaternion(jnp.asarray(R)))
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=1e-6)
    np.testing.assert_allclose(TG.quaternion_to_matrix(q_t).numpy(), R, atol=1e-5)
    np.testing.assert_allclose(TG.quaternion_to_matrix(_t(q_j)).numpy(),
                               np.asarray(JG.quaternion_to_matrix(jnp.asarray(q_j))), atol=1e-6)
    near = q_j[0] + np.float32(1e-7)
    for a, b in ((q_j[0], q_j[1]), (q_j[2], -q_j[3]), (q_j[0], near)):
        for t in (0.0, 1.0 / 3.0, 1.0):
            got = TG.quaternion_slerp(_t(a), _t(b), t).numpy()
            want = np.asarray(JG.quaternion_slerp(jnp.asarray(a), jnp.asarray(b), jnp.float32(t)))
            np.testing.assert_allclose(got, want, atol=1e-6)
    batch = TG.quaternion_slerp(_t(q_j[:4]), _t(q_j[4:8]), _t(np.full(4, 0.25, np.float32)))
    want = JG.quaternion_slerp(jnp.asarray(q_j[:4]), jnp.asarray(q_j[4:8]), jnp.full(4, 0.25))
    np.testing.assert_allclose(batch.numpy(), np.asarray(want), atol=1e-6)


def test_compute_iou_and_roi_host_path_match():
    """bbox.compute_iou on numpy and torch boxes; the host ROI path
    (roi_align_exact_np, crop_mask_bool_np) on the inputs of
    tests/test_ops_resize_roialign.py and on a mask: equal arrays."""
    from dynhor_tpu.ops import roi_align as JRA
    from dynhor_tpu.utils import bbox as JB
    from dynhor_tpu_torch.ops import roi_align as TRA
    from dynhor_tpu_torch.utils import bbox as TB

    b1 = np.array([[0.0, 0.0, 10.0, 10.0], [2.0, 3.0, 8.0, 9.0], [0.0, 0.0, 1.0, 1.0]], np.float32)
    b2 = np.array([[5.0, 5.0, 15.0, 15.0], [2.0, 3.0, 8.0, 9.0], [3.0, 3.0, 4.0, 4.0]], np.float32)
    want = np.asarray(JB.compute_iou(b1, b2))
    np.testing.assert_array_equal(TB.compute_iou(b1, b2), want)
    np.testing.assert_allclose(TB.compute_iou(_t(b1), _t(b2)).numpy(), want, atol=1e-7)
    rng = np.random.RandomState(3)
    img = rng.rand(1, 50, 60).astype(np.float32)
    for box in ([5.0, 8.0, 45.0, 47.0], [-3.0, 2.5, 30.25, 61.0], [10.0, 10.0, 11.0, 12.0]):
        box = np.array(box, np.float32)
        np.testing.assert_array_equal(TRA.roi_align_exact_np(img, box, 16),
                                      JRA.roi_align_exact_np(img, box, 16))
        mask = (rng.rand(50, 60) > 0.5).astype(np.float32)
        np.testing.assert_array_equal(TRA.crop_mask_bool_np(mask, box, 16),
                                      JRA.crop_mask_bool_np(mask, box, 16))
