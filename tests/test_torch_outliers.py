"""Outlier voting vs the JAX package: ``vote_outliers``,
``interpolate_poses``, ``load_correspondences`` and the pipeline's
``maybe_vote_outliers`` with its re-joint.

On the inputs of tests/test_outliers.py (the 12-face box at 96x128, a
trajectory with one corrupted frame, or none, perfect correspondences):
outlier masks and the pairs voted on equal, frame and pair scores within
SCORE_TOL px (the largest difference measured was 7.6e-6 px: the z-buffers
and the reprojection are the same f32 arithmetic in another order), the
repaired poses within 1e-6.

``maybe_vote_outliers`` on a sequence from the port's demo-data twin (the
box at 120x160, 4 frames, correspondences of adjacent frames), whose frame
2 is corrupted: the same outliers, and the re-joint's poses (5 steps)
within 1e-4 of the JAX package's.  Both re-joints take JointConfig's
default caps.
"""
import copy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.io.config import DEFAULTS
from dynhor_tpu.neus.data import load_correspondences as j_load_corr
from dynhor_tpu.tracker import outliers as JO
from dynhor_tpu.tracker import pipeline as JPL
from dynhor_tpu_torch.neus.data import CorrData, load_correspondences
from dynhor_tpu_torch.tracker import outliers as TO
from dynhor_tpu_torch.tracker import pipeline as TPL
from dynhor_tpu_torch.utils import camera as TC

sys.path.insert(0, str(Path(__file__).parent))
import test_outliers as JT  # noqa: E402
from test_pipeline_e2e import _write_box_obj  # noqa: E402

SCORE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """The port's pipeline is thousands of small ops.  Under the suite's
    parallel workers, torch's intra-op threads oversubscribe the cores and
    every op waits for all of them (a sequential-mode run took 412 s in the
    suite against 1.9 s alone), so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corr_t(corr):
    return CorrData(*(torch.as_tensor(np.array(x)) for x in corr))


@pytest.mark.parametrize("corrupt,threshold", [(3, 6.0), (None, 6.0), (3, 20.0)])
def test_vote_outliers_matches(corrupt, threshold):
    n = 6 if corrupt is not None else 5
    Rs, Ts, K, (gt_Rs, gt_Ts) = JT._make_sequence(n, corrupt=corrupt)
    pairs = [(i, i + 1) for i in range(n - 1)] + [(i, i + 2) for i in range(n - 2)]
    corr = JT._corr_from_gt(gt_Rs, gt_Ts, K, pairs)
    want = JO.vote_outliers(jnp.asarray(JT.BOX_V), jnp.asarray(JT.BOX_F), Rs, Ts, K, corr,
                            (JT.H, JT.W), threshold_px=threshold)
    got = TO.vote_outliers(JT.BOX_V, JT.BOX_F, Rs, Ts, K, _corr_t(corr), (JT.H, JT.W),
                           threshold_px=threshold, device="cpu")
    np.testing.assert_array_equal(got.outliers, want.outliers)
    np.testing.assert_allclose(got.frame_scores, want.frame_scores, atol=SCORE_TOL)
    assert set(got.pair_errors) == set(want.pair_errors)
    for k in want.pair_errors:
        assert abs(got.pair_errors[k] - want.pair_errors[k]) < SCORE_TOL
    if corrupt is not None and threshold == 6.0:
        assert got.outliers.tolist() == [i == corrupt for i in range(n)]
    R_t, T_t = TO.interpolate_poses(Rs, Ts, got.outliers)
    R_j, T_j = JO.interpolate_poses(Rs, Ts, want.outliers)
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(T_t, T_j, atol=1e-6)


@pytest.mark.parametrize("outliers", [[True, False, False, False], [False, True, True, False],
                                      [False, False, False, True], [True, True, True, True]])
def test_interpolate_poses_matches(outliers):
    Rs, Ts, _, _ = JT._make_sequence(4, corrupt=1)
    mask = np.array(outliers)
    R_t, T_t = TO.interpolate_poses(Rs, Ts, mask)
    R_j, T_j = JO.interpolate_poses(Rs, Ts, mask)
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(T_t, T_j, atol=1e-6)


@pytest.fixture(scope="module")
def twin_seq(tmp_path_factory):
    from dynhor_tpu_torch.tools import make_demo_data as MD

    root = tmp_path_factory.mktemp("twin")
    _write_box_obj(root / "box.obj")
    MD.write_sequence(str(root / "seq"), str(root / "box.obj"), frames=4, height=120, width=160,
                      device="cpu", verbose=False)
    return root


def test_load_correspondences_matches(twin_seq):
    ids = ["0000", "0001", "0002", "0003"]
    got = load_correspondences(str(twin_seq / "seq"), ids)
    want = j_load_corr(str(twin_seq / "seq"), ids)
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert load_correspondences(str(twin_seq), ids) is None  # no such directory


def test_maybe_vote_outliers_with_rejoint_matches(twin_seq, capsys):
    cfg = copy.deepcopy(DEFAULTS)
    cfg["data_info"]["dataroot"] = str(twin_seq / "seq")
    cfg["system"].update(crop_size=64, joint_num_iterations=10, joint_lr=1e-3, face_chunk=12)
    seq = TPL.load_sequence(str(twin_seq / "seq"))
    ann = TPL.process_frames(seq, crop_size=64)
    mesh = TPL.load_mesh(str(twin_seq / "box.obj"))
    gt = np.load(twin_seq / "seq" / "gt_poses.npz")
    R = np.ascontiguousarray(gt["R"].transpose(0, 2, 1))  # row convention
    T = gt["T"].copy()
    bad = np.asarray(JT.G.random_rotations(JT.jax.random.PRNGKey(9), 1))[0]
    R[2], T[2] = bad, T[2] + np.array([0.1, -0.05, 0.2], np.float32)
    K = gt["K"]
    K_rois = TC.get_K_crop_resize(
        torch.as_tensor(K).expand(4, 3, 3), torch.as_tensor(ann.square_xyxy), 64).numpy()
    result = TPL.TrackResult(R, T[:, None], R, T[:, None], np.zeros(4, np.int32), K, K_rois,
                             {}, np.zeros(4), np.zeros(4))
    got = TPL.maybe_vote_outliers(cfg, seq, ann, mesh, result, device="cpu")
    want = JPL.maybe_vote_outliers(cfg, seq, ann, mesh, JPL.TrackResult(*result))
    # The report's line: scores to 2 decimals and the outlier frames.
    t_line, j_line = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("outlier voting:")]
    assert t_line == j_line and "outliers=[2" in t_line
    assert not np.allclose(got.rotations_row[2], R[2], atol=1e-2)  # frame 2 repaired
    np.testing.assert_allclose(got.rotations_row, want.rotations_row, atol=1e-4)
    np.testing.assert_allclose(got.translations, want.translations, atol=1e-4)
    assert got.translations.shape == want.translations.shape == (4, 1, 3)
