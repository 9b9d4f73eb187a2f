"""The port's ``joint_optimize`` vs the JAX package's on the box mesh of
tests/test_refine_jointopt.py at 64²: 3 frames from jittered inits, 5 Adam
steps, on the port's side in host chunks of 2 (chunk boundaries fall inside;
the JAX side runs one launch, one compile), for each silhouette
implementation ("pallas": the JAX fused raster in interpret mode
against the port's plain versions; "tiled"; "dense").  The final rot6d and
translations and every history value agree within 1e-5 (f32 on both sides;
sums in another order), the scale stays exactly 1 when frozen and follows
the JAX trajectory within 1e-5 when optimized (the dense silhouette, the
cheapest to compile on the JAX side)."""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynhor_tpu.tracker import jointopt as JJ
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu_torch.tracker import jointopt as TJ

sys.path.insert(0, str(Path(__file__).parent))
from test_refine_jointopt import SIZE, _K, _mesh, _render_target  # noqa: E402

FRAMES = 3
TOL = 1e-5


def _scene():
    mesh = _mesh()
    R_base = np.asarray(JG.random_rotations(jax.random.PRNGKey(4), 1))[0]
    rng = np.random.default_rng(7)
    Rs, masks = [], []
    for f in range(FRAMES):
        c, s = np.cos(0.06 * f), np.sin(0.06 * f)
        R = R_base @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        Rs.append(R)
        masks.append(np.asarray(_render_target(mesh, jnp.asarray(R), jnp.array([0.0, 0.0, 2.0]))))
    masks = np.stack(masks)
    masks[:, :4] = -1.0  # an ignored band, so keep_masks is not all ones
    r6 = np.asarray(JG.matrix_to_rot6d(jnp.asarray(np.stack(Rs))))
    R0 = np.asarray(JG.rot6d_to_matrix(jnp.asarray(r6 + 0.08 * rng.standard_normal(r6.shape))))
    t0 = (np.array([0.0, 0.0, 2.0]) + 0.03 * rng.standard_normal((FRAMES, 3))).astype(np.float32)
    K = np.stack([np.asarray(_K())] * FRAMES)
    return mesh, R0.astype(np.float32), t0, K, masks.astype(np.float32)


@pytest.mark.parametrize(
    "impl,scale", [("pallas", False), ("tiled", False), ("dense", False), ("dense", True)]
)
def test_joint_trajectory_matches(impl, scale):
    mesh, R0, t0, K, masks = _scene()
    kw = dict(num_iterations=5, lr=1e-3, crop_size=SIZE, face_chunk=12, silhouette_impl=impl,
              optimize_object_scale=scale)
    res_j = JJ.joint_optimize(
        mesh.verts, mesh.faces, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(K),
        jnp.asarray(masks), JJ.JointConfig(**kw), iters_per_launch=5,
    )
    res_t = TJ.joint_optimize(
        np.array(mesh.verts), np.array(mesh.faces), R0, t0, K, masks,
        TJ.JointConfig(**kw), iters_per_launch=2, device="cpu",
    )
    assert set(res_t.history) == set(res_j.history) == set(TJ.HISTORY_KEYS)
    for k in TJ.HISTORY_KEYS:
        assert res_t.history[k].shape == (5,)
        np.testing.assert_allclose(res_t.history[k].numpy(), np.asarray(res_j.history[k]),
                                   atol=TOL, err_msg=k)
    np.testing.assert_allclose(res_t.rot6d.numpy(), np.asarray(res_j.rot6d), atol=TOL)
    np.testing.assert_allclose(res_t.translations.numpy(), np.asarray(res_j.translations), atol=TOL)
    np.testing.assert_allclose(float(res_t.scale), float(res_j.scale), atol=TOL)
    if not scale:
        assert float(res_t.scale) == 1.0
    else:
        assert abs(float(res_t.scale) - 1.0) > 1e-4  # the scale moved
    h = res_t.history
    assert float(h["loss"][-1]) < float(h["loss"][0])
    assert float(h["bin_overflow"].max()) == 0.0
    assert float(np.abs(res_t.rot6d.numpy() - np.asarray(JG.matrix_to_rot6d(jnp.asarray(R0)))).max()) > 1e-4
