"""Multi-hypothesis init and the rest of ``RefineConfig``: the port against
the JAX package on the inputs of the JAX package's own tests.

Held exactly (the same numpy operations on identical inputs):
``build_hypotheses`` (tests/test_selection.py's inputs), ``_viterbi_select``
(tests/test_refine_jointopt.py's), and the silhouette-IoU channel of
``prior_scores_batched`` and ``prior_scores_two_stage`` on the e2e test's
box (sums of {0,1} in f32 and one IEEE division: exact when the crop masks
are, and the crop masks are exact, tests/test_torch_priors.py).

``refine_poses(carry_state=...)``: a run split in two equals the unbroken
run of the port exactly (torch's Adam resumes from the carried moments and
step count), and the JAX package's split run within REFINE_TOL (the
tolerance of tests/test_torch_refine.py) after every part.

``refine_poses_multihyp`` on the inputs of tests/test_refine_jointopt.py
(the box at 64², coarse mode, both packages on the plain "tiled"
silhouette): the tournament losses within LOSS_TOL relative; the winners
equal wherever the best loss beats the runner-up by more than LOSS_TOL
(every frame of these inputs); the final poses within POSE_TOL; and the
pose recovered, as the JAX tests assert.  ``k == 1`` equals ``refine_poses``
in the port.

``dino_remat``: the fine step's gradients with ``False`` and ``"frozen"``
(per-block recomputation) agree within 1e-6 in f32 on a tiny ViT.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu.tracker import pipeline as JPL
from dynhor_tpu.tracker import priors as JP
from dynhor_tpu.tracker import refine as JR
from dynhor_tpu.tracker import selection as JS
from dynhor_tpu.utils import geometry as JG
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.tracker import priors as TP
from dynhor_tpu_torch.tracker import refine as TR
from dynhor_tpu_torch.tracker import selection as TS

sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline_e2e import BOX_F, BOX_V, demo_dir  # noqa: E402,F401
from test_refine_jointopt import SIZE, _K, _mesh, _mesh_asym, _render_target, _rot_z  # noqa: E402

REFINE_TOL = 1e-4
LOSS_TOL = 1e-3
POSE_TOL = 1e-3
# The JAX tests' multi-hypothesis inputs run 150 steps (50 or 60 in the
# tournament); these run 60 (20), where the JAX package recovers the same
# poses within 1.4 degrees and the tests' bounds (12 and 15 degrees, IoU
# 0.90 and 0.88) hold.  Launches of TOURNAMENT steps: one JAX compile.
STEPS, TOURNAMENT = 60, 20
TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=32)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """Hundreds of small refine steps: one torch thread under the suite's
    parallel workers (see tests/test_torch_pipeline.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hyp_case(case):
    if case == "sil":  # test_build_hypotheses_slots_flips_and_diversity
        priors = np.asarray(JG.random_rotations(jax.random.PRNGKey(1), 50), np.float32)
        sil = np.random.RandomState(0).rand(3, 50).astype(np.float32)
        return priors[[2, 5, 9]], np.array([2, 5, -1], np.int32), priors, 5, sil
    priors = np.asarray(JG.random_rotations(jax.random.PRNGKey(2), 30), np.float32)
    k = 1 if case == "k1" else 5  # test_build_hypotheses_k1_and_fps_fallback
    return priors[[4]], np.array([4], np.int32), priors, k, None


@pytest.mark.parametrize("case", ["sil", "k1", "fps"])
def test_build_hypotheses_matches_exactly(case):
    rot_init, sel, priors, k, sil = _hyp_case(case)
    want = JS.build_hypotheses(
        jnp.asarray(rot_init), jnp.asarray(sel), jnp.asarray(priors), k,
        sil_scores=None if sil is None else jnp.asarray(sil),
    )
    got = TS.build_hypotheses(
        torch.as_tensor(rot_init), torch.as_tensor(sel), torch.as_tensor(priors), k,
        sil_scores=None if sil is None else torch.as_tensor(sil),
    )
    assert got.rotations.dtype == torch.float32 and got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.rotations.numpy(), np.asarray(want.rotations))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


def _viterbi_case(case):
    if case == "flip_ties":  # test_viterbi_select_resolves_symmetric_flip_ties
        rng = np.random.default_rng(0)
        f = 8
        base = [np.asarray(JG.rot6d_to_matrix(JG.matrix_to_rot6d(
            jnp.asarray(_rot_z(3.0 * i))[None]))[0]) for i in range(f)]
        rots = np.zeros((f, 2, 3, 3), np.float32)
        for i in range(f):
            rots[i, 0] = base[i]
            flip = TS._FLIP_Y if i in (2, 5) else TS._FLIP_X
            rots[i, 1] = base[i] @ flip
        losses = np.full((f, 2), 1.0, np.float32) + 0.01 * rng.standard_normal((f, 2)).astype(np.float32)
        return rots, losses
    f = 6  # test_viterbi_select_respects_strong_loss_signal
    rots = np.zeros((f, 2, 3, 3), np.float32)
    for i in range(f):
        rots[i, 0] = np.eye(3, dtype=np.float32)
        rots[i, 1] = _rot_z(10.0 * ((-1) ** i))
    losses = np.stack([np.full(f, 5.0, np.float32), np.full(f, 1.0, np.float32)], axis=1)
    return rots, losses


@pytest.mark.parametrize("case", ["flip_ties", "strong_loss", "one_frame"])
def test_viterbi_select_matches_exactly(case):
    rots, losses = _viterbi_case("strong_loss" if case == "one_frame" else case)
    if case == "one_frame":
        rots, losses = rots[:1], losses[:1]
    want = np.asarray(JR._viterbi_select(jnp.asarray(rots), jnp.asarray(losses)))
    got = TR._viterbi_select(torch.as_tensor(rots), torch.as_tensor(losses))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "flip_ties":
        assert (want == want[0]).all() and np.argmin(losses, 1).min() != np.argmin(losses, 1).max()


def _box_targets(mesh, R_true, t_true, frames):
    target = _render_target(mesh, jnp.asarray(R_true), jnp.asarray(t_true))
    return JR.FrameTargets(
        target_masks=jnp.stack([target] * frames), gt_feats=jnp.zeros((frames, 4, 8)),
        K_rois=jnp.stack([_K()] * frames),
    )


def _to_torch(mesh, targets):
    return (TR.MeshArrays(*(np.array(x) for x in mesh)),
            TR.FrameTargets(*(np.array(x) for x in targets)))


def _coarse_cfg(pkg, iters):
    return pkg.RefineConfig(num_iterations=iters, lr=0.01, crop_size=SIZE, mode="coarse",
                            face_chunk=12, silhouette_impl="tiled",
                            max_faces_per_tile=16)


def _dR(key, scale):
    return np.asarray(JG.rot6d_to_matrix(
        JG.matrix_to_rot6d(jnp.eye(3)[None]) + scale * jax.random.normal(key, (1, 3, 2))))[0]


def test_carry_state_resumes_the_unbroken_trajectory():
    """Coarse mode on the box, 3 frames: TOURNAMENT + TOURNAMENT steps
    carried against 2 x TOURNAMENT unbroken; the JAX package's carried run
    alongside (the launch shape of the propagation case: one compile)."""
    mesh = _mesh()
    R_true = np.asarray(JG.random_rotations(jax.random.PRNGKey(2), 1))[0]
    t_true = np.array([0.0, 0.0, 2.0], np.float32)
    targets = _box_targets(mesh, R_true, t_true, 3)
    R0 = np.stack([R_true, R_true @ _dR(jax.random.PRNGKey(1), 0.05),
                   R_true @ _rot_z(8.0)]).astype(np.float32)
    t0 = np.stack([t_true + [0.02, -0.01, 0.05], t_true + 0.05, t_true]).astype(np.float32)
    n = TOURNAMENT

    r1_j, st_j = JR.refine_poses(mesh, targets, jnp.asarray(R0), jnp.asarray(t0), None, None,
                                 _coarse_cfg(JR, n), return_state=True)
    r2_j = JR.refine_poses(mesh, targets, jnp.asarray(R0), jnp.asarray(t0), None, None,
                           _coarse_cfg(JR, n), carry_state=st_j)

    mesh_t, targets_t = _to_torch(mesh, targets)
    whole = TR.refine_poses(mesh_t, targets_t, R0, t0, None, None, _coarse_cfg(TR, 2 * n),
                            device="cpu")
    r1, st = TR.refine_poses(mesh_t, targets_t, R0, t0, None, None, _coarse_cfg(TR, n),
                             return_state=True, device="cpu")
    assert float(st.step) == n and st.m_rot6d.shape == (3, 3, 2) and st.v_trans.shape == (3, 1, 3)
    # The inits are ignored when a state is given.
    r2 = TR.refine_poses(mesh_t, targets_t, R0 * 0, t0 * 0, None, None, _coarse_cfg(TR, n),
                         carry_state=st, device="cpu")
    for a, b in zip(r2[:4], whole[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for got, want in ((r1, r1_j), (r2, r2_j)):
        for name, a, b in zip(("rot6d", "trans", "loss", "iou"), got[:4], want[:4]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=REFINE_TOL, err_msg=name)
    assert float((r2.rot6d - r1.rot6d).abs().max()) > 1e-4  # the second part moved


def _winners_and_poses_match(mres_t, mres_j):
    """Tournament losses within LOSS_TOL; winners equal on every frame whose
    best loss beats its runner-up by more; the final poses within POSE_TOL
    on the frames whose winners agree.  The near-tie frames are printed."""
    lt, lj = mres_t.tournament_loss.numpy(), np.asarray(mres_j.tournament_loss)
    np.testing.assert_allclose(lt, lj, rtol=LOSS_TOL)
    srt = np.sort(lj, axis=1)
    decided = (srt[:, 1] - srt[:, 0]) > LOSS_TOL * np.abs(srt[:, 0])
    win_t, win_j = mres_t.winner.numpy(), np.asarray(mres_j.winner)
    np.testing.assert_array_equal(win_t[decided], win_j[decided])
    same = win_t == win_j
    print(f"near-tie frames {np.nonzero(~decided)[0].tolist()}, winners {win_t.tolist()} "
          f"(JAX {win_j.tolist()})")
    for a, b in ((mres_t.result.rot6d, mres_j.result.rot6d),
                 (mres_t.result.translations, mres_j.result.translations)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], atol=POSE_TOL)


def test_multihyp_selects_the_recovering_init():
    """test_refine_multihyp_selects_recovering_init's inputs: slot 0 ~95
    degrees off, slot 1 ~10 degrees off."""
    mesh = _mesh()
    R_true = np.asarray(JG.random_rotations(jax.random.PRNGKey(0), 1))[0]
    t_true = np.array([0.05, -0.03, 2.0], np.float32)
    targets = _box_targets(mesh, R_true, t_true, 1)
    R_near = R_true @ _dR(jax.random.PRNGKey(1), 0.1)
    R_far = R_true @ _rot_z(95.0)
    rot_inits = np.stack([R_far, R_near])[None].astype(np.float32)  # (1, 2, 3, 3)
    t0 = t_true + np.array([0.08, -0.06, 0.15], np.float32)
    trans_inits = np.stack([t0, t0])[None]
    want = JR.refine_poses_multihyp(mesh, targets, jnp.asarray(rot_inits),
                                    jnp.asarray(trans_inits), None, None,
                                    _coarse_cfg(JR, STEPS), tournament_iters=TOURNAMENT,
                                    iters_per_launch=TOURNAMENT)
    mesh_t, targets_t = _to_torch(mesh, targets)
    got = TR.refine_poses_multihyp(mesh_t, targets_t, rot_inits, trans_inits, None, None,
                                   _coarse_cfg(TR, STEPS), tournament_iters=TOURNAMENT,
                                   device="cpu")
    assert got.tournament_loss.shape == (1, 2) and got.winner.tolist() == [1]
    _winners_and_poses_match(got, want)
    assert float(got.result.final_iou[0]) > 0.90
    ang = float(JG.rotation_angle_difference(
        jnp.asarray(TR.G.rot6d_to_matrix(got.result.rot6d).numpy()), jnp.asarray(R_true)[None])[0])
    assert ang < 12.0


def test_multihyp_k1_equals_refine_poses():
    mesh = _mesh()
    R_true = np.asarray(JG.random_rotations(jax.random.PRNGKey(7), 1))[0]
    mesh_t, targets_t = _to_torch(mesh, _box_targets(mesh, R_true, [0.0, 0.0, 2.0], 1))
    R0, t0 = R_true[None], np.asarray([[0.0, 0.0, 2.0]], np.float32)
    single = TR.refine_poses(mesh_t, targets_t, R0, t0, None, None, _coarse_cfg(TR, 10),
                             device="cpu")
    multi = TR.refine_poses_multihyp(mesh_t, targets_t, R0[:, None], t0[:, None], None, None,
                                     _coarse_cfg(TR, 10), device="cpu")
    for a, b in zip(multi.result[:4], single[:4]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert multi.winner.tolist() == [0] and multi.tournament_loss.shape == (1, 1)


def test_multihyp_propagation_rescues_a_frame():
    """test_multihyp_propagation_rescues_frame_with_no_good_hypothesis's
    inputs: the middle frame's two hypotheses are both ~95-100 degrees off;
    one propagation round re-seeds it from its neighbours' winners."""
    mesh = _mesh_asym()
    R_true = np.asarray(JG.random_rotations(jax.random.PRNGKey(3), 1))[0]
    t_true = np.array([0.02, -0.01, 2.0], np.float32)
    targets = _box_targets(mesh, R_true, t_true, 3)
    R_near = R_true @ _dR(jax.random.PRNGKey(4), 0.08)
    R_far, R_far2 = R_true @ _rot_z(95.0), R_true @ _rot_z(-100.0)
    rot_inits = np.stack([np.stack([R_far, R_near]), np.stack([R_far, R_far2]),
                          np.stack([R_far, R_near])]).astype(np.float32)
    t0 = t_true + np.array([0.06, -0.04, 0.1], np.float32)
    trans_inits = np.tile(t0, (3, 2, 1))
    kw = dict(tournament_iters=TOURNAMENT, select="viterbi", propagate_rounds=1,
              iters_per_launch=TOURNAMENT)
    want = JR.refine_poses_multihyp(mesh, targets, jnp.asarray(rot_inits),
                                    jnp.asarray(trans_inits), None, None,
                                    _coarse_cfg(JR, STEPS), **kw)
    mesh_t, targets_t = _to_torch(mesh, targets)
    got = TR.refine_poses_multihyp(mesh_t, targets_t, rot_inits, trans_inits, None, None,
                                   _coarse_cfg(TR, STEPS), device="cpu", **kw)
    _winners_and_poses_match(got, want)
    ang = np.asarray(JG.rotation_angle_difference(
        jnp.asarray(TR.G.rot6d_to_matrix(got.result.rot6d).numpy()),
        jnp.asarray(np.stack([R_true] * 3))))
    assert ang[0] < 12.0 and ang[2] < 12.0 and ang[1] < 15.0, ang
    assert float(got.result.final_iou[1]) > 0.88


def test_dino_remat_gives_the_same_step():
    """One fine step's loss and d(rot6d, trans) under each recomputation
    policy ("frozen", "dots", True) and without (False), f32, within 1e-6; the JAX package's
    RefineConfig fields build in the port."""
    cfg_j = JR.RefineConfig(lw_mask=0.5, dino_remat="dots")
    assert TR.RefineConfig(lw_mask=0.5, dino_remat="dots").lw_mask == cfg_j.lw_mask
    assert TR.RefineConfig().dino_remat == JR.RefineConfig().dino_remat == "frozen"
    mesh = _mesh()
    mesh_t, targets_t = _to_torch(mesh, _box_targets(
        mesh, np.eye(3, dtype=np.float32), [0.0, 0.0, 2.0], 2))
    mesh_t = TR.MeshArrays(*(torch.as_tensor(x) for x in mesh_t))
    gen = torch.Generator().manual_seed(0)
    dcfg = TD.DinoConfig(**TINY)
    params = TD.init_params(dcfg, gen)
    gt = torch.randn((2, 16, 32), generator=gen)
    targets_t = TR.FrameTargets(torch.as_tensor(targets_t.target_masks), gt,
                                torch.as_tensor(targets_t.K_rois))
    rot0 = TR.G.matrix_to_rot6d(torch.as_tensor(np.stack([
        np.eye(3), _rot_z(20.0)]).astype(np.float32)))
    out = {}
    for remat in (False, "frozen", "dots", True):
        cfg = TR.RefineConfig(crop_size=SIZE, mode="fine", dino_dtype="float32", face_chunk=12,
                              silhouette_impl="tiled", dino_remat=remat)
        r6 = rot0.clone().requires_grad_(True)
        tr = torch.tensor([[[0.01, 0.0, 2.0]], [[0.0, 0.02, 2.1]]], requires_grad=True)
        loss, _, _ = TR._frame_loss(r6, tr, mesh_t, targets_t, params, dcfg, cfg)
        loss.sum().backward()
        out[remat] = (loss.detach(), r6.grad, tr.grad)
    for remat in ("frozen", "dots", True):
        for a, b in zip(out[remat], out[False]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert float(out[False][1].abs().max()) > 0


@pytest.mark.parametrize("stages", ["batched", "two_stage"])
def test_sil_channel_matches_exactly(demo_dir, stages):  # noqa: F811
    """The (F, N) silhouette-IoU matrix of the e2e box (4 frames, crop 64,
    24 random views at 96²), a tiny f32 ViT: exactly the JAX package's,
    from ``prior_scores_batched`` and from the two-stage scoring's
    prescreen (topk 2: 24 views are pruned); the scores within 1e-5."""
    seq = JPL.load_sequence(str(demo_dir))
    ann = JPL.process_frames(seq, crop_size=64)
    mesh = (BOX_V, BOX_F, np.zeros((12, 3, 2), np.float32) + 0.5,
            np.ones((2, 2, 3), np.float32) * np.array([0.7, 0.45, 0.3], np.float32))
    rots = np.array(JG.random_rotations(jax.random.PRNGKey(1), 24))
    dcfg_j = JD.DinoConfig(**TINY)
    params_j = JD.init_params(jax.random.PRNGKey(0), dcfg_j)
    params_t = TD.params_from_jax(jax.tree.map(np.asarray, params_j))
    out = {}
    for name, P, to, params, dcfg, kw in (
        ("jax", JP, jnp.asarray, params_j, dcfg_j, {}),
        ("torch", TP, torch.as_tensor, params_t, TD.DinoConfig(**TINY), {"device": "cpu"}),
    ):
        verts, faces, face_uvs, texture = (to(np.asarray(x)) for x in mesh)
        cfg = P.PriorConfig(num_views=24, view_chunk=6, render_h=96, render_w=96,
                            crop_size=64, dino_dtype="float32")
        radius, _ = P.mesh_radius_center(verts)
        window = P.compute_window(cfg, float(P.mesh_norm_radius(verts)),
                                  float(cfg.distance_scale * radius))
        gt, cm = P.frame_gt_features(params, dcfg, to(ann.crop_images), to(ann.target_masks),
                                     "float32", **kw)
        common = (params, dcfg, verts, faces, face_uvs, texture, to(rots))
        if stages == "batched":
            sil_masks = np.asarray(TP.frame_sil_masks(torch.as_tensor(ann.target_masks)))
            scores, sil = P.prior_scores_batched(
                *common, gt, cm, cfg, window, with_sil=True, sil_masks=to(sil_masks), **kw)
        else:
            scores, sil = P.prior_scores_two_stage(
                *common, to(ann.crop_images), to(ann.target_masks), gt, cm, cfg, window,
                prescreen_edge=24, topk=2, with_sil=True, **kw)
        out[name] = np.asarray(scores), np.asarray(sil)
    (s_j, sil_j), (s_t, sil_t) = out["jax"], out["torch"]
    assert sil_t.shape == (4, 24) and sil_t.dtype == np.float32
    np.testing.assert_array_equal(sil_t, sil_j)
    assert 0.0 <= sil_j.min() and sil_j.max() <= 1.0 and len(np.unique(sil_j)) > 24
    np.testing.assert_allclose(s_t, s_j, atol=1e-5)
    # The frame side of the channel: resize_nearest of the crop masks.
    np.testing.assert_array_equal(
        TP.frame_sil_masks(torch.as_tensor(ann.target_masks)).numpy(),
        np.asarray(JP.resize_nearest((jnp.asarray(ann.target_masks) > 0).astype(jnp.float32),
                                     JP.SIL_RES, JP.SIL_RES)).reshape(4, -1))
