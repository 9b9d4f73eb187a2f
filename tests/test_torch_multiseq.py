"""Multi-sequence pooling: the port's ``parallel/multiseq.py`` vs the JAX
package's, on tests/test_multiseq.py's inputs (two box meshes of different
scales and vertex counts, 32², coarse mode on the dense silhouette, 4-5
Adam steps), the masks rendered by the JAX package.

Held: ``pad_mesh`` and ``build_batch`` equal the JAX package's exactly
(the port keeps one texture per sequence, indexed per frame; it is held
through that index); ``refine_poses_multi`` within 1e-5 of the JAX
package's (f32 sums in another order: measured 6.0e-7); pooled
against per-sequence ``refine_poses`` in the port within 1e-6, with a third
mesh whose padding faces (0, 0, 0) take part; micro-batched
(``frames_per_launch=3``, a padded last group) against the whole pool
within 1e-6, the JAX test's bound (measured 1.8e-7: torch's CPU kernels
round a frame's sums differently at another batch size, so the split is
not bit for bit); and a fine-mode pool with a tiny f32 ViT (its weights carried
across by ``params_from_jax``), the fused raster on both sides (the JAX
Pallas kernels in interpret mode), within 1e-4 as tests/test_torch_refine.py
holds the fine refine.

``python -m dynhor_tpu_torch.run_multi --device cpu`` (its ``main``)
against ``run_multi.py``'s ``main`` on two 4-frame box sequences of
tests/test_pipeline_e2e.py (the box, and the box with two faces dropped,
whose frames get two padding faces each), both packages given the same 24
prior rotations (each package's ``prior_view_rotations`` monkeypatched) and
one small DINOv2 checkpoint (tests/test_torch_pipeline.py's, in bf16): the
printed caps equal, the same npz files with K exact and R, T within 1e-2
(the pipeline test's FINAL_TOL: bf16 rounds differently in XLA's and
torch's CPU kernels).
"""
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynhor_tpu.models import dino as JD
from dynhor_tpu.parallel import multiseq as JMS
from dynhor_tpu.tracker import refine as JR
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.parallel import multiseq as TMS
from dynhor_tpu_torch.tracker import refine as TR
from dynhor_tpu_torch.utils import geometry as TG
from dynhor_tpu_torch.utils.objio import MeshData as TMeshData

sys.path.insert(0, str(Path(__file__).parent))
from test_multiseq import SIZE, _box_mesh, _targets_for  # noqa: E402
from test_pipeline_e2e import BOX_F, BOX_V, demo_dir  # noqa: E402,F401
from test_torch_pipeline import _tiny_checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FINAL_TOL = 1e-2

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pos_grid=4, smaller_edge_size=32)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """Thousands of small ops: under the suite's parallel workers torch's
    intra-op threads oversubscribe the cores, so this module runs torch on
    one thread (as tests/test_torch_pipeline.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tmesh(m):
    return TMeshData(verts=np.asarray(m.verts), faces=np.asarray(m.faces),
                     face_uvs=np.asarray(m.face_uvs), texture=np.asarray(m.texture),
                     has_texture=m.has_texture)


def _ttargets(t):
    return TR.FrameTargets(*(np.array(x) for x in t))


def _coarse(steps, **kw):
    return (JR.RefineConfig(num_iterations=steps, crop_size=SIZE, mode="coarse", face_chunk=12,
                            use_tiled=False, **kw),
            TR.RefineConfig(num_iterations=steps, crop_size=SIZE, mode="coarse", face_chunk=12,
                            use_tiled=False, **kw))


@pytest.fixture(scope="module")
def two():
    """tests/test_multiseq.py's first scene: boxes of scale 1 and 0.7 (3
    extra vertices), 4 frames each."""
    mesh_a, mesh_b = _box_mesh(1.0), _box_mesh(0.7, nv_extra=3)
    tgt_a, rot_a, trans_a = _targets_for(mesh_a, 4, seed=0)
    tgt_b, rot_b, trans_b = _targets_for(mesh_b, 4, seed=1)
    return dict(meshes=[mesh_a, mesh_b], tgts=[tgt_a, tgt_b],
                rot=np.concatenate([np.asarray(rot_a), np.asarray(rot_b)]),
                trans=np.concatenate([np.asarray(trans_a), np.asarray(trans_b)]))


def test_pad_mesh_and_build_batch_match_exactly(two):
    meshes = two["meshes"] + [dataclasses.replace(
        _box_mesh(0.8), faces=_box_mesh(0.8).faces[:9], face_uvs=_box_mesh(0.8).face_uvs[:9] + 0.1,
        texture=np.full((3, 5, 3), 0.25, np.float32))]
    for m in meshes:
        pj, pt = JMS.pad_mesh(m, 13, 12), TMS.pad_mesh(_tmesh(m), 13, 12)
        for k in ("verts", "faces", "face_uvs", "texture"):
            a, b = np.asarray(getattr(pt, k)), np.asarray(getattr(pj, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    tgts = two["tgts"] + [_targets_for(meshes[2], 2, seed=4)[0]]
    bj = JMS.build_batch(meshes, tgts)
    bt = TMS.build_batch([_tmesh(m) for m in meshes], [_ttargets(t) for t in tgts], device="cpu")
    np.testing.assert_array_equal(bt.mesh_verts.numpy(), np.asarray(bj.mesh_verts))
    np.testing.assert_array_equal(bt.mesh_faces.numpy(), np.asarray(bj.mesh_faces))
    np.testing.assert_array_equal(bt.mesh_uvs.numpy(), np.asarray(bj.mesh_uvs))
    assert bt.mesh_tex.textures.shape[0] == 3  # one texture per sequence
    np.testing.assert_array_equal(
        bt.mesh_tex.textures[bt.mesh_tex.index].numpy(), np.asarray(bj.mesh_tex))
    for a, b in zip(bt.targets, bj.targets):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(bt.seq_id, bj.seq_id)
    assert bt.seq_id.dtype == bj.seq_id.dtype


def test_refine_poses_multi_matches_jax(two):
    cfg_j, cfg_t = _coarse(5)
    bj = JMS.build_batch(two["meshes"], two["tgts"])
    want = JMS.refine_poses_multi(bj, jnp.asarray(two["rot"]), jnp.asarray(two["trans"]),
                                  None, None, cfg_j)
    bt = TMS.build_batch([_tmesh(m) for m in two["meshes"]],
                         [_ttargets(t) for t in two["tgts"]], device="cpu")
    got = TMS.refine_poses_multi(bt, two["rot"], two["trans"], None, None, cfg_t, device="cpu")
    assert got.max_overflow == 0 == int(want.max_overflow)
    for name, a, b in zip(("rot6d", "trans", "loss", "iou"), got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    init = TG.matrix_to_rot6d(torch.as_tensor(two["rot"])).numpy()
    assert float(np.abs(got.rot6d.numpy() - init).max()) > 1e-3  # the poses moved


def test_pool_matches_per_sequence(two):
    """The pooled refine (padded meshes, a mesh per frame) against each
    sequence's own ``refine_poses`` (its mesh shared), in the port; the
    third mesh has 9 faces, so three padding faces in each of its frames."""
    m_c = dataclasses.replace(_box_mesh(0.8), faces=_box_mesh(0.8).faces[:9],
                              face_uvs=_box_mesh(0.8).face_uvs[:9])
    tgt_c, rot_c, trans_c = _targets_for(m_c, 2, seed=4)
    meshes = two["meshes"] + [m_c]
    tgts = two["tgts"] + [tgt_c]
    rot = np.concatenate([two["rot"], np.asarray(rot_c)])
    trans = np.concatenate([two["trans"], np.asarray(trans_c)])
    _, cfg_t = _coarse(5)
    bt = TMS.build_batch([_tmesh(m) for m in meshes], [_ttargets(t) for t in tgts], device="cpu")
    assert bt.mesh_verts.shape == (10, 11, 3) and bt.mesh_faces.shape == (10, 12, 3)
    pooled = TMS.refine_poses_multi(bt, rot, trans, None, None, cfg_t, device="cpu")
    off, singles = 0, []
    for m, t in zip(meshes, tgts):
        n = np.asarray(t.target_masks).shape[0]
        ma = TR.MeshArrays(m.verts, np.asarray(m.faces), m.face_uvs, m.texture)
        singles.append(TR.refine_poses(ma, _ttargets(t), rot[off:off + n], trans[off:off + n],
                                       None, None, cfg_t, device="cpu"))
        off += n
    for k in ("rot6d", "translations", "final_loss", "final_iou"):
        want = torch.cat([getattr(r, k) for r in singles]).numpy()
        np.testing.assert_allclose(getattr(pooled, k).numpy(), want, atol=1e-6, err_msg=k)


def test_frame_microbatch_exact():
    """tests/test_multiseq.py's micro-batch scene: 5 + 3 frames in groups
    of 3 (the last padded by the pool's first frame) against the whole
    pool, within 1e-6."""
    m1, m2 = _box_mesh(1.0), _box_mesh(0.8, nv_extra=2)
    t1, r1, tr1 = _targets_for(m1, 5, seed=0)
    t2, r2, tr2 = _targets_for(m2, 3, seed=1)
    bt = TMS.build_batch([_tmesh(m1), _tmesh(m2)], [_ttargets(t1), _ttargets(t2)], device="cpu")
    rot = np.concatenate([np.asarray(r1), np.asarray(r2)])
    trans = np.concatenate([np.asarray(tr1), np.asarray(tr2)])
    _, cfg_t = _coarse(4)
    whole = TMS.refine_poses_multi(bt, rot, trans, None, None, cfg_t, device="cpu")
    split = TMS.refine_poses_multi(bt, rot, trans, None, None, cfg_t, frames_per_launch=3,
                                   device="cpu")
    for k in ("rot6d", "translations", "final_loss", "final_iou"):
        np.testing.assert_allclose(getattr(split, k).numpy(), getattr(whole, k).numpy(),
                                   atol=1e-6, err_msg=k)
    assert split.rot6d.shape == (8, 3, 2)


def test_fine_pool_with_tiny_vit_matches_jax(two):
    """Fine mode (textured Phong render, the ViT's sem loss) over the pool,
    the fused raster on both sides, a tiny f32 ViT, 3 steps."""
    dcfg_j = JD.DinoConfig(**TINY)
    dparams = JD.init_params(jax.random.PRNGKey(0), dcfg_j)
    rng = np.random.default_rng(0)
    tgts = [t._replace(gt_feats=jnp.asarray(rng.standard_normal((4, 16, 32)).astype(np.float32)))
            for t in two["tgts"]]
    kw = dict(num_iterations=3, crop_size=SIZE, mode="fine", face_chunk=12,
              silhouette_impl="pallas", dino_dtype="float32")
    bj = JMS.build_batch(two["meshes"], tgts)
    want = JMS.refine_poses_multi(bj, jnp.asarray(two["rot"]), jnp.asarray(two["trans"]),
                                  dparams, dcfg_j, JR.RefineConfig(**kw))
    bt = TMS.build_batch([_tmesh(m) for m in two["meshes"]], [_ttargets(t) for t in tgts],
                         device="cpu")
    got = TMS.refine_poses_multi(
        bt, two["rot"], two["trans"], TD.params_from_jax(jax.tree.map(np.asarray, dparams)),
        TD.DinoConfig(**TINY), TR.RefineConfig(**kw), device="cpu",
    )
    assert got.max_overflow == 0 == int(want.max_overflow)
    for name, a, b in zip(("rot6d", "trans", "loss", "iou"), got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, err_msg=name)


def _run_multi_config(root, obj, name, ckpt):
    return {
        "seq_name": name, "exp_name": "pred",
        "data_info": {"dataroot": str(root), "obj_path": str(obj), "normalize_mesh": False},
        "system": {
            "init_num_iterations": 6, "init_lr": 0.01,
            "joint_num_iterations": 8, "joint_lr": 0.001,
            "crop_size": 64, "face_chunk": 12,
            "prior": {"num_views": 24, "view_chunk": 6},
            "dino": {"smaller_edge_size": 56, "checkpoint": str(ckpt)},
        },
    }


@pytest.mark.mid
def test_run_multi_matches_jax(demo_dir, tmp_path, monkeypatch, capsys):  # noqa: F811
    import importlib.util
    import re

    import yaml

    from dynhor_tpu.tracker import priors as JP
    from dynhor_tpu.utils import compcache
    from dynhor_tpu.utils import geometry as JG
    from dynhor_tpu_torch import run_multi as TRM
    from dynhor_tpu_torch.io.artifacts import load_pose_npz
    from dynhor_tpu_torch.tracker import priors as TP

    _tiny_checkpoint(tmp_path / "dino.npz")
    with open(tmp_path / "cut.obj", "w") as f:
        for v in BOX_V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in BOX_F[:10] + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
    paths = []
    for name, obj in (("boxseq", demo_dir / "box.obj"), ("cutseq", tmp_path / "cut.obj")):
        p = tmp_path / f"{name}.yaml"
        p.write_text(yaml.safe_dump(_run_multi_config(demo_dir, obj, name, tmp_path / "dino.npz")))
        paths.append(str(p))
    views = np.array(JG.random_rotations(jax.random.PRNGKey(7), 24))
    monkeypatch.setattr(JP, "prior_view_rotations", lambda key, cfg: jnp.asarray(views))
    monkeypatch.setattr(TP, "prior_view_rotations", lambda cfg, gen=None: torch.as_tensor(views))
    monkeypatch.setattr(compcache, "enable_persistent_cache", lambda *a, **k: None)

    spec = importlib.util.spec_from_file_location("run_multi_jax", REPO / "run_multi.py")
    jrm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jrm)
    monkeypatch.setattr(sys, "argv", ["run_multi.py", "--config_paths", *paths,
                                      "--exps_root", str(tmp_path / "jax_exps")])
    jrm.main()
    jax_out = capsys.readouterr().out
    res = TRM.main(["--config_paths", *paths, "--exps_root", str(tmp_path / "torch_exps"),
                    "--device", "cpu"])
    torch_out = capsys.readouterr().out

    cap_j = re.search(r"per-tile face cap (\d+), active-tile cap (\w+)", jax_out).groups()
    cap_t = re.search(r"per-tile face cap (\d+), active-tile cap (\w+)", torch_out).groups()
    assert cap_t == cap_j and int(cap_t[0]) == res.cap
    assert res.refine.max_overflow == 0
    assert [s["name"] for s in res.sequences] == ["boxseq", "cutseq"]
    for name in ("boxseq", "cutseq"):
        exp_j = tmp_path / "jax_exps" / name / "pred"
        exp_t = tmp_path / "torch_exps" / name / "pred"
        files = sorted(os.listdir(exp_j / "obj_infos"))
        assert sorted(os.listdir(exp_t / "obj_infos")) == files and len(files) == 4
        assert (exp_t / "config.yaml").read_bytes() == (exp_j / "config.yaml").read_bytes()
        assert os.listdir(exp_t / "board")
        for fname in files:
            fid = fname.split(".")[0]
            got, want = load_pose_npz(str(exp_t), fid), load_pose_npz(str(exp_j), fid)
            np.testing.assert_array_equal(got["K"], want["K"])
            for k in ("R", "T"):
                np.testing.assert_allclose(got[k], want[k], atol=FINAL_TOL, err_msg=f"{name} {k}")


def test_run_multi_needs_a_card_and_one_device(demo_dir, tmp_path, monkeypatch):  # noqa: F811
    """Without a card and without ``--device`` the entry point raises before
    any work; ``system.devices: 2`` in one process shards over one device
    (tests/test_torch_parallel.py runs it over ranks); and
    ``refine_poses_multi`` with no device needs a card."""
    import yaml

    from dynhor_tpu_torch import run_multi as TRM

    cfg = _run_multi_config(demo_dir, demo_dir / "box.obj", "boxseq", tmp_path / "none.npz")
    path = tmp_path / "box.yaml"
    path.write_text(yaml.safe_dump(cfg))
    exps = tmp_path / "exps"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRM.main(["--config_paths", str(path), "--exps_root", str(exps)])
    assert not exps.exists()
    from dynhor_tpu_torch.tracker import pipeline as TPL

    cfg["system"]["devices"] = 2
    assert TPL.view_devices(cfg["system"]) == 1
    batch = TMS.build_batch([_tmesh(_box_mesh())], [_ttargets(_targets_for(_box_mesh(), 1, 0)[0])],
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TMS.refine_poses_multi(batch, np.eye(3, dtype=np.float32)[None],
                               np.zeros((1, 3), np.float32), None, None, _coarse(1)[1])
