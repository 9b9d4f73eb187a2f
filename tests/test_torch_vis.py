"""Visualization: the port's ``Visualizer.draw_mesh`` and
``priors.render_mesh_opencv_pose`` against the JAX package's, on the e2e
test's box (tests/test_pipeline_e2e.py).

Both render with the dense hard raster (``face_chunk`` 1024 and 512) and
flat-colour or prior-view Phong shading in f32.  Held: the hit masks
exactly, the shaded colours within 1e-5, the depth within 1e-5.  The
``vis`` entry point is held against ``vis.py`` in
tests/test_torch_pipeline.py, on a JAX run's experiment directory.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.tracker import pipeline as JPL
from dynhor_tpu.tracker import priors as JP
from dynhor_tpu.utils import camera as JC
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu.visualizer import Visualizer as JVisualizer
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.visualizer import Visualizer as TVisualizer

sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline_e2e import BOX_F, BOX_V, H, W, demo_dir  # noqa: E402,F401


@pytest.mark.parametrize("pose", ["front", "turned"])
def test_draw_mesh_matches(demo_dir, pose):  # noqa: F811
    """test_visualizer_overlay's input (the box 1.6 in front of the camera,
    focal 144), and the box turned by a random rotation."""
    seq = JPL.load_sequence(str(demo_dir))
    img = seq.images[0].astype(np.float32) / 255.0
    R = np.eye(3, dtype=np.float32)
    if pose == "turned":
        R = np.asarray(JG.random_rotations(jax.random.PRNGKey(4), 1))[0]
    verts_cam = BOX_V @ R + np.array([0, 0, 1.6], np.float32)
    cam = (144.0, 144.0, W // 2, H // 2)
    want, mask_j = JVisualizer((H, W)).draw_mesh(img, verts_cam, BOX_F, cam, return_mask=True)
    got, mask_t = TVisualizer((H, W)).draw_mesh(img, verts_cam, BOX_F, cam, return_mask=True,
                                                device="cpu")
    assert got.shape == (H, W, 3) and mask_t.shape == (H, W, 1) and mask_t.dtype == bool
    np.testing.assert_array_equal(mask_t, np.asarray(mask_j))
    assert 500 < mask_t.sum() < H * W
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert not np.allclose(got, img)


def test_render_mesh_opencv_pose_matches(demo_dir):  # noqa: F811
    """The box under an OpenCV pose at the e2e frames' intrinsics (120x160,
    focal 1.2 * 120), prior-view lights, a two-colour texture."""
    K = np.asarray(JC.intrinsics_from_image(H, W))
    R = np.asarray(JG.random_rotations(jax.random.PRNGKey(6), 1))[0]
    t = np.array([0.03, -0.02, 1.5], np.float32)
    uvs = np.random.default_rng(0).random((12, 3, 2)).astype(np.float32)
    tex = np.stack([np.full((2, 3), 0.2), np.full((2, 3), 0.9)]).astype(np.float32)
    args = (BOX_V, BOX_F, uvs, tex, R, t, K, H, W)
    rgba_j, depth_j = JP.render_mesh_opencv_pose(*(jnp.asarray(a) for a in args[:7]), H, W)
    rgba_t, depth_t = TP.render_mesh_opencv_pose(*args, device="cpu")
    assert rgba_t.shape == (H, W, 4) and depth_t.shape == (H, W)
    np.testing.assert_array_equal(rgba_t[..., 3].numpy(), np.asarray(rgba_j[..., 3]))
    assert 200 < float(rgba_t[..., 3].sum()) < H * W
    np.testing.assert_allclose(rgba_t.numpy(), np.asarray(rgba_j), atol=1e-5)
    np.testing.assert_allclose(depth_t.numpy(), np.asarray(depth_j), atol=1e-5)
    assert float(depth_t.min()) == -1.0


def test_draw_mesh_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TVisualizer((4, 4)).draw_mesh(np.zeros((4, 4, 3), np.float32), BOX_V, BOX_F,
                                      (4.0, 4.0, 2, 2))
