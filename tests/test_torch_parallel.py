"""Sharding over ``torch.distributed``: the port's ``parallel/mesh.py`` and the
sharded paths, run by real process groups on the CPU (gloo) and held against
one process and against the JAX package's ``tests/test_parallel.py``.

One 2-rank group (``tests/torch_dist_worker.py``, no JAX in its processes,
torch on one thread) runs the cases, a second one ``run_multi``'s, and a
4-rank group the 2 x 2 ``seq x frames`` pool; all start before the JAX
references are computed here, on one device, and run beside them.  Held:

- ``shard_leading``'s slices, its warning and the replicated leaf on a
  non-divisible axis; ``replicate``, ``pad_to_multiple``, ``gather_leading``
  (uneven slices, bool and int leaves) and ``all_reduce``; ``halo_prev``'s
  row and its gradient, returned to the rank that owns the row;
- the frame-sharded refine (3 steps, fine mode, tests/test_parallel.py's
  ``_tiny_setup`` scene at 8 frames) equal to one process bit for bit, and
  within 2e-5 of the JAX package's;
- the frame-sharded joint (4 steps, ``lw_smooth_obj`` 5, the halo across the
  ranks) against the JAX package's: poses 2e-5, history 1e-4;
- view-sharded ``prior_scores_two_stage`` (24 views in chunks of 8, each
  chunk 4 + 4, sil channel on) against one process within 1e-5, the prior
  parity tests' bound;
- ``refine_poses_multi`` over the 2 x 2 ``seq x frames`` mesh on
  tests/test_multiseq.py's four box sequences, against the JAX package's
  pooled refine in one process (1e-4, the JAX test's bound);
- ray-sharded ``render_rays`` within 1e-5 of the JAX package's whole batch,
  and the per-ray shade selection of a slice equal to the slice of the
  whole selection; three ray-sharded NeuS train steps against three whole
  ones: logs 1e-5 relative, Adam's moments within 1e-4 relative (+1e-4 of
  each tensor's largest entry) and the parameters within 1e-4 of the summed
  learning rates; the replicas bitwise equal;
- ``replicate`` makes the ViT's and a field's weights bitwise equal on
  every rank;
- ``track_sequence`` through ``run_from_config`` on
  tests/test_torch_pipeline.py's box twin with ``system.devices: 2`` over 2
  ranks against ``devices: 1``: the same npz artifacts, written by rank 0
  alone; and ``run_multi``'s main on two copies of it (views and pooled
  frames sharded) against ``devices: 1``: the same artifacts.
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline_e2e import demo_dir  # noqa: E402,F401
from test_torch_multihost import launch  # noqa: E402
from test_torch_pipeline import _tiny_checkpoint, _user_config  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CASES_2 = "mesh,refine,joint,priors,neus_render,neus_train,replicate,pipeline"
NEUS_SDF = dict(encoder="pe", pe_freqs=2, hidden=32, depth=2, skip_layer=1, feat_dim=8,
                color_hidden=32, color_depth=2)
NEUS_RCFG = dict(n_coarse=16, n_importance=8, up_sample_steps=2, perturb=False)


def _tiny_inputs():
    import __graft_entry__ as gre

    mesh, targets, rot, trans, dparams, dcfg, cfg = gre._tiny_setup(
        crop_size=32, frames=8, dino_edge=28)
    return mesh, targets, rot, trans, dparams, dcfg, cfg


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def groups(demo_dir, tmp_path_factory):  # noqa: F811
    """Both groups' results, the JAX references and the inputs."""
    from dynhor_tpu.models import dino as JD
    from dynhor_tpu.neus import fields as JF
    from dynhor_tpu.neus import rendering as JR
    from dynhor_tpu.parallel import multiseq as JMS
    from dynhor_tpu.tracker import jointopt as JJ
    from dynhor_tpu.tracker import refine as JRF
    from test_multiseq import SIZE, _box_mesh, _targets_for
    from test_neus import _sphere_data

    work = tmp_path_factory.mktemp("dist")
    mesh, targets, rot, trans, dparams, dcfg, cfg = _tiny_inputs()
    np_mesh = [np.asarray(x) for x in mesh]
    np_targets = [np.asarray(x) for x in targets]
    dcfg_kw = {f.name: getattr(dcfg, f.name) for f in dataclasses.fields(JD.DinoConfig)
               if f.name in ("patch_size", "embed_dim", "depth", "num_heads", "pos_grid",
                             "smaller_edge_size")}
    refine_kw = dict(num_iterations=3, crop_size=32, mode="fine", face_chunk=12, sigma=0.25,
                     silhouette_impl="tiled", dino_dtype="float32")
    joint_kw = dict(num_iterations=4, crop_size=32, face_chunk=12, lw_smooth_obj=5.0,
                    silhouette_impl="tiled")
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.standard_normal((24, 3, 3)))
    rots = (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)

    # NeuS: tests/test_parallel.py's rays and field, and a small scene for
    # the train steps (tests/test_torch_neus_train.py's).
    jsdf = JF.SDFConfig(**NEUS_SDF)
    jparams = JF.init_field_params(jax.random.PRNGKey(0), jsdf)
    K = jnp.array([[50.0, 0, 25], [0, 50.0, 25], [0, 0, 1]])
    pix = jnp.stack([jnp.linspace(5, 45, 64), jnp.linspace(5, 45, 64)], axis=-1)
    rays = JR.rays_from_pose(pix, K, jnp.eye(3), jnp.array([0.0, 0.0, 2.0]), 1.0)
    scene = _sphere_data(n_frames=3, hw=24, radius=0.4)
    nrm = rng.standard_normal((3, 24, 24, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    scene = scene._replace(normals=jnp.asarray(nrm))
    m = 300
    corr = [rng.integers(0, 3, m).astype(np.int32), rng.integers(0, 3, m).astype(np.int32),
            rng.uniform(4, 20, (m, 2)).astype(np.float32),
            rng.uniform(4, 20, (m, 2)).astype(np.float32)]

    ckpt = work / "dino.npz"
    _tiny_checkpoint(ckpt)
    cfg_path = work / "box.yaml"
    cfg_path.write_text(yaml.safe_dump(_user_config(demo_dir, ckpt)))

    inputs = {
        "refine": dict(mesh=np_mesh, targets=np_targets, dparams=_np_tree(dparams),
                       dcfg=dcfg_kw, cfg=refine_kw, rot=np.asarray(rot), trans=np.asarray(trans)),
        "joint": dict(cfg=joint_kw, verts=np_mesh[0], faces=np_mesh[1], rot=np.asarray(rot),
                      trans=np.asarray(trans), K=np_targets[2], masks=np_targets[0]),
        "priors": dict(mesh=np_mesh, targets=np_targets, dparams=_np_tree(dparams), dcfg=dcfg_kw,
                       cfg=dict(num_views=24, view_chunk=8, crop_size=32, render_h=96,
                                render_w=96, max_faces_per_tile=5000, dino_dtype="float32"),
                       rots=rots, crops=rng.uniform(size=(2, 3, 32, 32)).astype(np.float32),
                       masks=np_targets[0][:2], prescreen_edge=14, topk=2),
        "neus": dict(sdf_cfg=NEUS_SDF, params=_np_tree(jparams), rays=[np.asarray(x) for x in rays],
                     rcfg=NEUS_RCFG, data=[None if x is None else np.asarray(x) for x in scene],
                     corr=corr, steps=3,
                     train_rcfg=dict(n_coarse=16, n_importance=8, up_sample_steps=2, n_shade=8),
                     tcfg=dict(num_steps=10, batch_rays=32, lr=1e-3, warmup=2, lw_corr=0.01,
                               log_every=1)),
        "pipeline": dict(cfg_path=str(cfg_path), work=str(work), exps_one=str(work / "one"),
                         exps_two=str(work / "two"), multi_one=str(work / "m1"),
                         multi_two=str(work / "m2")),
    }
    wait2 = launch(2, CASES_2, inputs, work / "g2")
    wait_m = launch(2, "run_multi", inputs, work / "gm")

    meshes, tgts, rots4, transs4 = [], [], [], []
    for s in range(4):
        bm = _box_mesh(1.0 - 0.1 * s, nv_extra=s)
        t, r, tr = _targets_for(bm, 2, seed=s)
        meshes.append(bm)
        tgts.append(t)
        rots4.append(r)
        transs4.append(tr)
    ms_cfg = dict(num_iterations=4, crop_size=SIZE, mode="coarse", face_chunk=12, use_tiled=False)
    wait4 = launch(4, "multiseq", {"multiseq": dict(
        meshes=[dict(verts=np.asarray(bm.verts), faces=np.asarray(bm.faces),
                     face_uvs=np.asarray(bm.face_uvs), texture=np.asarray(bm.texture),
                     has_texture=bm.has_texture) for bm in meshes],
        targets=[[np.asarray(x) for x in t] for t in tgts], num_sequences=2, cfg=ms_cfg,
        rot=np.concatenate([np.asarray(r) for r in rots4]),
        trans=np.concatenate([np.asarray(tr) for tr in transs4]))}, work / "g4")

    # The JAX references, on one device, while the groups run.
    ref = {}
    res = JRF.refine_poses(mesh, targets, rot, trans, dparams, dcfg,
                           dataclasses.replace(cfg, **refine_kw))
    ref["refine"] = dict(rot6d=np.asarray(res.rot6d), translations=np.asarray(res.translations))
    jres = JJ.joint_optimize(mesh.verts, mesh.faces, rot, trans, targets.K_rois,
                             targets.target_masks, JJ.JointConfig(**joint_kw))
    ref["joint"] = dict(rot6d=np.asarray(jres.rot6d), trans=np.asarray(jres.translations),
                        history={k: np.asarray(v) for k, v in jres.history.items()})
    # The JAX package's pool in one process (tests/test_multiseq.py holds it
    # against the per-sequence refines and against its seq x frames mesh).
    ms = JMS.refine_poses_multi(JMS.build_batch(meshes, tgts), jnp.concatenate(rots4),
                                jnp.concatenate(transs4), None, None, JRF.RefineConfig(**ms_cfg))
    ref["multiseq"] = np.asarray(ms.rot6d)
    out = jax.jit(lambda p, r: JR.render_rays(p, jsdf, JR.RenderConfig(**NEUS_RCFG), r))(
        jparams, rays)
    ref["neus_render"] = dict(rgb=np.asarray(out.rgb), acc=np.asarray(out.acc))
    return dict(g2=wait2(), g4=wait4(), gm=wait_m(), ref=ref, work=work, inputs=inputs)


def _case(groups, name, group="g2"):
    outs = []
    for rank, res in enumerate(groups[group]):
        assert not res["jax_imported"], f"rank {rank} imported JAX"
        r = res[name]
        assert "error" not in r, f"rank {rank}:\n{r.get('error')}"
        outs.append(r)
    return outs


def test_shard_replicate_pad_gather(groups):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, r in enumerate(_case(groups, "mesh")):
        np.testing.assert_array_equal(r["a"], x[4 * rank:4 * rank + 4])
        np.testing.assert_array_equal(r["d"], np.arange(8)[4 * rank:4 * rank + 4])
        assert r["b"].shape == () and r["c"].shape == (5, 2)  # replicated
        assert len(r["warnings"]) == 1 and "leading axis 5 not divisible by mesh axis" \
            " 'frames'=2; REPLICATING this array" in r["warnings"][0]
        np.testing.assert_array_equal(r["gather_whole"], x)
        np.testing.assert_array_equal(r["gather_f"][:, 0], [0.0, 1.0, 2.0, 10.0, 11.0])
        np.testing.assert_array_equal(r["gather_b"][:, 0], [False] * 4 + [True])
        assert r["gather_i"].dtype == np.int64 and r["gather_i"][-1, 0] == 11
        np.testing.assert_array_equal(r["rep_t"], [1.0, 1.0, 1.0])
        np.testing.assert_array_equal(r["rep_n"], [1, 1])
        np.testing.assert_array_equal(r["rep_b"], [True, True])
        assert int(r["max"]) == 2 and float(r["sum"]) == 3.0
        np.testing.assert_array_equal(r["pad"], [0, 1, 2, 3, 4, 4, 4, 4])
        assert int(r["pad_size"]) == 5


def test_halo_prev_forward_and_gradient(groups):
    r0, r1 = _case(groups, "mesh")
    np.testing.assert_array_equal(r0["halo"], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(r1["halo"], [9.0, 10.0, 11.0])  # rank 0's last row
    want = np.zeros((8, 3), np.float32)
    want[3] = [1.0, 2.0, 3.0]  # rank 1's use of the row, back to rank 0's row 3
    np.testing.assert_array_equal(r0["halo_grad"], want)
    np.testing.assert_array_equal(r1["halo_grad"], np.zeros((8, 3)))


def test_sharded_refine_matches_one_process_and_jax(groups):
    ref = groups["ref"]["refine"]
    for r in _case(groups, "refine"):
        assert int(r["local_frames"]) == 4
        for k in ("rot6d", "translations", "final_loss", "final_iou"):
            np.testing.assert_array_equal(r[f"sharded_{k}"], r[f"single_{k}"], err_msg=k)
        assert int(r["sharded_overflow"]) == int(r["single_overflow"]) == 0
        np.testing.assert_allclose(r["sharded_rot6d"], ref["rot6d"], atol=2e-5)
        np.testing.assert_allclose(r["sharded_translations"], ref["translations"], atol=2e-5)


def test_sharded_joint_smoothness_halo_matches_jax(groups):
    ref = groups["ref"]["joint"]
    for r in _case(groups, "joint"):
        np.testing.assert_allclose(r["sharded_rot6d"], ref["rot6d"], atol=2e-5)
        np.testing.assert_allclose(r["sharded_trans"], ref["trans"], atol=2e-5)
        for k, v in ref["history"].items():
            np.testing.assert_allclose(r[f"sharded_h_{k}"], v, atol=1e-4, err_msg=k)
            np.testing.assert_allclose(r[f"sharded_h_{k}"], r[f"single_h_{k}"], atol=1e-6,
                                       err_msg=k)
        assert float(np.abs(ref["history"]["loss_smooth_obj"]).max()) > 0


def test_view_sharded_prior_scores_match_one_process(groups):
    for r in _case(groups, "priors"):
        np.testing.assert_allclose(r["sharded"], r["single"], atol=1e-5)
        np.testing.assert_array_equal(r["sharded_sil"], r["single_sil"])
        gap = np.sort(r["single"], axis=1)
        decided = gap[:, -1] - gap[:, -2] > 1e-5
        np.testing.assert_array_equal(r["sharded"].argmax(1)[decided],
                                      r["single"].argmax(1)[decided])


def test_multiseq_seq_frame_mesh_matches_jax(groups):
    want = groups["ref"]["multiseq"]
    outs = _case(groups, "multiseq", "g4")
    coords = sorted(tuple(r["coords"]) for r in outs)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in outs:
        assert tuple(r["shape"]) == (2, 2) and int(r["local_frames"]) == 2
        np.testing.assert_allclose(r["rot6d"], want, atol=1e-4)


def test_ray_sharded_render_rays(groups):
    ref = groups["ref"]["neus_render"]
    for r in _case(groups, "neus_render"):
        np.testing.assert_allclose(r["sharded_rgb"], ref["rgb"], atol=1e-5)
        np.testing.assert_allclose(r["sharded_acc"], ref["acc"], atol=1e-5)
        np.testing.assert_allclose(r["sharded_rgb"], r["whole_rgb"], atol=1e-6)
        assert bool(r["shade_slice_equal"])


def test_ray_sharded_neus_steps_match_whole_steps(groups):
    outs = _case(groups, "neus_train")
    r = outs[0]
    np.testing.assert_allclose(r["sharded_logs"], r["whole_logs"], rtol=1e-5, atol=1e-6)
    tol = 1e-4 * float(r["whole_lrs"][0])
    for k in r:
        if k.startswith("whole_m_") or k.startswith("whole_v_"):
            want, got = r[k], r["sharded" + k[5:]]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)
        if k.startswith("whole_param_"):
            np.testing.assert_allclose(r["sharded" + k[5:]], r[k], rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(r["sharded_bg"], r["whole_bg"], atol=1e-6)
    # The replicas start and stay bitwise equal.
    assert outs[0]["sharded_init_digest"] == outs[1]["sharded_init_digest"]
    assert outs[0]["sharded_digest"] == outs[1]["sharded_digest"]


def test_ray_sharded_neus_steps_equal_the_halves_in_one_process(groups):
    """``chip_smoke._witness_step``, the witness that holds the card's two
    ranks over 50 steps: the ranks' two halves of the rays taken in one
    process in rank order give the ranks' logged losses and final weights
    bit for bit (the same sums in the same order)."""
    import torch

    import chip_smoke
    from dynhor_tpu_torch.neus import data as TDA
    from dynhor_tpu_torch.neus import draws as TDR
    from dynhor_tpu_torch.neus import fields as TF
    from dynhor_tpu_torch.neus import rendering as TRN
    from dynhor_tpu_torch.neus import trainer as TT

    d = groups["inputs"]["neus"]
    data = TDA.ReconData(*(None if x is None else torch.as_tensor(x) for x in d["data"]))
    corr = TDA.CorrData(*(torch.as_tensor(x) for x in d["corr"]))
    tcfg = TT.TrainConfig(**d["tcfg"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        key = TDR.Key(0)
        state = TT.init_train_state(key, TF.SDFConfig(**d["sdf_cfg"]), tcfg)
        step = chip_smoke._witness_step(TRN.RenderConfig(**d["train_rcfg"]), tcfg)
        losses = [float(step(state, key.fold_in(i), data, corr, None)["loss"])
                  for i in range(d["steps"])]
    finally:
        torch.set_num_threads(threads)
    for r in _case(groups, "neus_train"):
        col = list(r["log_keys"]).index("loss")
        np.testing.assert_array_equal(r["sharded_logs"][:, col], np.array(losses))
        for name, p in state.field.named_parameters():
            np.testing.assert_array_equal(r[f"sharded_param_{name}"], p.detach().numpy(),
                                          err_msg=name)
        np.testing.assert_array_equal(r["sharded_bg"], state.bg.detach().numpy())


def test_replicate_makes_the_weights_equal_on_every_rank(groups):
    r0, r1 = _case(groups, "replicate")
    assert r0["before"] != r1["before"]
    assert r0["after"] == r1["after"] == r0["before"]


def test_track_sequence_over_two_ranks_writes_one_rank_artifacts(groups):
    r0, r1 = _case(groups, "pipeline")
    assert int(r0["view_devices_2"]) == 2 and int(r0["view_devices_1"]) == 1
    for r in (r0, r1):
        np.testing.assert_array_equal(r["sel_2"], r["sel_1"])
        np.testing.assert_array_equal(r["rot_2"], r["rot_1"])
    assert [int(r0[f"calls_{k}"]) for k in ("save_pose_npzs", "copy_config", "Board")] == [2, 2, 2]
    assert [int(r1[f"calls_{k}"]) for k in ("save_pose_npzs", "copy_config", "Board")] == [0, 0, 0]
    one = groups["work"] / "one" / "boxseq" / "pred"
    two = groups["work"] / "two" / "boxseq" / "pred"
    names = sorted(os.listdir(one / "obj_infos"))
    assert names == sorted(os.listdir(two / "obj_infos")) and len(names) == 4
    for name in names:
        a, b = np.load(one / "obj_infos" / name), np.load(two / "obj_infos" / name)
        for k in ("R", "T", "K"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    assert (two / "config.yaml").exists() and os.listdir(two / "board")


def test_run_multi_over_two_ranks_writes_one_rank_artifacts(groups):
    for r in _case(groups, "run_multi", "gm"):
        np.testing.assert_array_equal(r["rot_2"], r["rot_1"])
    for name in ("boxa", "boxb"):
        one = groups["work"] / "m1" / name / "pred" / "obj_infos"
        two = groups["work"] / "m2" / name / "pred" / "obj_infos"
        names = sorted(os.listdir(one))
        assert names == sorted(os.listdir(two)) and len(names) == 4
        for f in names:
            a, b = np.load(one / f), np.load(two / f)
            for k in ("R", "T", "K"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {f} {k}")
