"""The slice: the port's ``refine_poses`` vs the JAX package's, on the box
mesh of tests/test_refine_jointopt.py at 64², 3 Adam steps, with the JAX
side on its Pallas fused raster (interpret mode) and an f32 ViT.  Losses,
IoUs, rot6d and trans agree within 1e-4 after every step; the fine mode also
with the port's ``attn_impl="flash"`` (the flash attention's plain versions
on the CPU) against the same JAX trajectory."""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynhor_tpu.models import dino as JD
from dynhor_tpu.tracker import refine as JR
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.tracker import refine as TR

sys.path.insert(0, str(Path(__file__).parent))
from test_refine_jointopt import SIZE, _K, _mesh, _render_target  # noqa: E402

STEPS = 3
TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=32)


# Fine mode with active-tile compaction (and Phong shading on active tiles
# only); coarse mode dense over all tiles.
@pytest.mark.parametrize(
    "mode,max_active_tiles,attn_impl",
    [("fine", 12, "xla"), ("coarse", None, "xla"), ("fine", 12, "flash")],
    ids=["fine-12", "coarse-None", "fine-12-flash"],
)
def test_refine_trajectory_matches(mode, max_active_tiles, attn_impl):
    mesh = _mesh()
    dcfg_j = JD.DinoConfig(**TINY)
    dparams = JD.init_params(jax.random.PRNGKey(0), dcfg_j)
    R_true = np.asarray(JG.random_rotations(jax.random.PRNGKey(2), 1))[0]
    t_true = np.array([0.0, 0.0, 2.0], np.float32)
    target = _render_target(mesh, jnp.asarray(R_true), jnp.asarray(t_true))
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((2, 16, 32)).astype(np.float32)
    targets = JR.FrameTargets(jnp.stack([target, target]), jnp.asarray(gt), jnp.stack([_K(), _K()]))
    R0 = np.stack([R_true, R_true @ np.asarray(JG.rot6d_to_matrix(
        jnp.asarray([[1.0, 0.05], [0.05, 1.0], [0.0, -0.05]])))])
    t0 = np.stack([t_true + [0.02, -0.01, 0.05], t_true + 0.05]).astype(np.float32)

    cfg_j = JR.RefineConfig(
        num_iterations=1, lr=0.01, crop_size=SIZE, mode=mode, silhouette_impl="pallas",
        dino_dtype="float32", max_active_tiles=max_active_tiles,
    )
    # One step per launch, the Adam state carried: the JAX side reports
    # after every step.
    traj_j, state = [], None
    for _ in range(STEPS):
        r, state = JR.refine_poses(
            mesh, targets, jnp.asarray(R0), jnp.asarray(t0), dparams, dcfg_j, cfg_j,
            carry_state=state, return_state=True,
        )
        traj_j.append([np.asarray(x) for x in r[:4]])
    assert int(r.max_overflow) == 0

    mesh_t = TR.MeshArrays(*(np.array(x) for x in mesh))
    targets_t = TR.FrameTargets(*(np.array(x) for x in targets))
    params_t = TD.params_from_jax(jax.tree.map(np.asarray, dparams))
    cfg_t = TR.RefineConfig(
        num_iterations=1, lr=0.01, crop_size=SIZE, mode=mode, dino_dtype="float32",
        max_active_tiles=max_active_tiles,
    )
    for step in range(STEPS):
        res = TR.refine_poses(
            mesh_t, targets_t, R0, t0, params_t, TD.DinoConfig(attn_impl=attn_impl, **TINY),
            dataclasses.replace(cfg_t, num_iterations=step + 1), device="cpu",
        )
        assert res.max_overflow == 0
        for name, a, b in zip(("rot6d", "trans", "loss", "iou"), traj_j[step], res[:4]):
            np.testing.assert_allclose(b.numpy(), a, atol=1e-4, err_msg=f"{name} step {step}")
    assert float(np.abs(traj_j[-1][0] - traj_j[0][0]).max()) > 1e-3  # the poses moved
