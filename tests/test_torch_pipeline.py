"""The whole ``run.py`` slice: the port's ``tracker/pipeline.py`` and
``python -m dynhor_tpu_torch.run`` vs the JAX package's, on the box
sequence of tests/test_pipeline_e2e.py (12 faces, 4 frames at 120x160, crop
64, 24 random or 20 grid prior views at 96², 8 refine and 10 joint steps).

Both packages load one small DINOv2 checkpoint (official layout, embed 64,
depth 2, patch 14, at an edge of 56: 16 tokens) through
``system.dino.checkpoint``, so their ViTs hold the same weights; the ViT
runs in bf16, as the pipeline runs it.  In random mode the port gets the
JAX package's draws (``view_rotations``); grid mode draws nothing.  The
grid is 6 x 3 with one roll: the reference's rolls, linspace(-180, 180,
n), repeat each view at -180 and +180 degrees, two equal rotations whose
scores tie to the last bit and whose pick the two packages may break
differently.  Each JAX pipeline runs once, in a module fixture.

Held, in each mode and for both ``parallel_refine`` values:
``selected_idx`` exact; the refine's poses within INIT_TOL and the joint's
within FINAL_TOL; the refine's losses within a relative 1e-2; the joint's
loss history within HISTORY_TOL.  The largest differences measured were
1.45e-3, 2.8e-3, 2.6e-3 and 5.2e-5: bf16 rounds differently in XLA's and
torch's CPU kernels (run in f32, the same pipelines agree within 9.2e-5
after the refine).  The hard-IoU history is not held: on the CPU the JAX
package's "auto" silhouette is "tiled" and the port's the fused raster,
whose hard masks differ at a few edge pixels (their soft objectives agree,
as the losses show).

``python -m dynhor_tpu_torch.run --device cpu`` writes the tree that the
JAX package's ``run_from_config`` writes (config.yaml byte for byte,
board/ with an events file, one npz per frame with R, T, K read back by the
JAX package's ``load_pose_npz``), its poses within FINAL_TOL of the JAX
run's.  Without a card and without ``--device`` it raises before any work;
``devices: 2`` raises.

Multi-hypothesis init (``num_initializations: 4``, the default
``hypotheses`` block with 4 tournament steps of the 8) in grid mode, the
port given the JAX package's grid rotations (its own agree within 1e-6):
the silhouette-IoU matrix and the hypotheses exactly the JAX package's; the
tournament losses within a relative 1e-2 (the refine losses' bound); the
winners equal wherever the best loss beats the runner-up by more than that;
``selected_idx`` exact; the poses within INIT_TOL and FINAL_TOL.  In
sequential mode the port prints the JAX package's note and refines the gate
pick.

``python -m dynhor_tpu_torch.vis --device cpu`` (its ``main``) on a copy of
the JAX run's experiment directory writes the files that ``vis.py`` writes
on another copy: the same render_res/ jpgs, their decoded pixels within 1
level of 255 (the composites agree within 1e-5 before the uint8 cast,
tests/test_torch_vis.py).  Without a card and without ``--device`` it
raises before writing.
"""
import copy
import filecmp
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from dynhor_tpu.io import artifacts as JA
from dynhor_tpu.io import config as JCFG
from dynhor_tpu.tracker import pipeline as JPL
from dynhor_tpu.tracker import priors as JP
from dynhor_tpu_torch.io import config as TCFG
from dynhor_tpu_torch.tracker import pipeline as TPL

sys.path.insert(0, str(Path(__file__).parent))
from test_pipeline_e2e import FRAMES, demo_dir  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
INIT_TOL = 5e-3
FINAL_TOL = 1e-2
HISTORY_TOL = 5e-4
GRID = [6, 3, 1]
MODES = [("grid", True), ("grid", False), ("random", True), ("random", False)]


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


def _tiny_checkpoint(path, d=64, depth=2, patch=14, grid=4, seed=5):
    """A DINOv2 state_dict in the official layout, random values."""
    rng = np.random.default_rng(seed)

    def tn(*shape, std=0.02):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    sd = {"cls_token": tn(1, 1, d), "pos_embed": tn(1, grid * grid + 1, d),
          "patch_embed.proj.weight": tn(d, 3, patch, patch), "patch_embed.proj.bias": tn(d),
          "norm.weight": 1.0 + tn(d), "norm.bias": tn(d)}
    for i in range(depth):
        p = f"blocks.{i}."
        sd.update({
            p + "norm1.weight": 1.0 + tn(d), p + "norm1.bias": tn(d),
            p + "attn.qkv.weight": tn(3 * d, d), p + "attn.qkv.bias": tn(3 * d),
            p + "attn.proj.weight": tn(d, d), p + "attn.proj.bias": tn(d),
            p + "ls1.gamma": np.full(d, 0.1, np.float32),
            p + "norm2.weight": 1.0 + tn(d), p + "norm2.bias": tn(d),
            p + "mlp.fc1.weight": tn(4 * d, d), p + "mlp.fc1.bias": tn(4 * d),
            p + "mlp.fc2.weight": tn(d, 4 * d), p + "mlp.fc2.bias": tn(d),
            p + "ls2.gamma": np.full(d, 0.1, np.float32),
        })
    np.savez(path, **sd)


def _user_config(root, ckpt):
    return {
        "seq_name": "boxseq",
        "exp_name": "pred",
        "random_render": False,
        "data_info": {"dataroot": str(root), "obj_path": str(root / "box.obj"),
                      "normalize_mesh": False},
        "system": {
            "init_num_iterations": 8, "init_lr": 0.01,
            "joint_num_iterations": 10, "joint_lr": 0.001,
            "crop_size": 64, "face_chunk": 12,
            "prior": {"num_views": 24, "view_chunk": 6, "render_hw": [96, 96],
                      "grid": GRID},
            "dino": {"smaller_edge_size": 56, "checkpoint": str(ckpt)},
        },
    }


def _mode_config(cfg, mode, parallel):
    cfg = copy.deepcopy(cfg)
    cfg["random_render"] = mode == "random"
    cfg["system"]["parallel_refine"] = parallel
    return cfg


@pytest.fixture(scope="module")
def box(demo_dir, tmp_path_factory):  # noqa: F811
    """(config path, loaded config, seq, ann, mesh, JAX results by mode,
    the JAX run's experiment dir, the JAX random-mode view rotations)."""
    work = tmp_path_factory.mktemp("pipe")
    _tiny_checkpoint(work / "dino.npz")
    cfg_path = work / "box.yaml"
    cfg_path.write_text(yaml.safe_dump(_user_config(demo_dir, work / "dino.npz")))
    cfg = JCFG.load_config(str(cfg_path))
    seq = JPL.load_sequence(str(demo_dir))
    ann = JPL.process_frames(seq, crop_size=64)
    mesh = JPL.load_mesh(str(demo_dir / "box.obj"), normalize=False)
    view_rots = np.asarray(JP.prior_view_rotations(
        jax.random.PRNGKey(0), JP.PriorConfig(num_views=24)))
    results = {("grid", True): JPL.run_from_config(cfg, exps_root=str(work / "jax_exps"))}
    for mode, parallel in MODES[1:]:
        results[(mode, parallel)] = JPL.track_sequence(
            _mode_config(cfg, mode, parallel), seq, ann, mesh)
    return dict(cfg_path=cfg_path, cfg=cfg, seq=seq, ann=ann, mesh=mesh, results=results,
                jax_exp=work / "jax_exps" / "boxseq" / "pred", view_rots=view_rots, work=work)


def test_host_preprocessing_matches(demo_dir):  # noqa: F811
    """load_sequence, process_frames (the numpy ROI path) and load_mesh:
    equal arrays."""
    seq_t, seq_j = TPL.load_sequence(str(demo_dir)), JPL.load_sequence(str(demo_dir))
    assert seq_t.frame_ids == seq_j.frame_ids
    for a, b in zip(seq_t[1:], seq_j[1:]):
        np.testing.assert_array_equal(a, b)
    for crop, expansion in ((64, 0.3), (48, 0.1)):
        ann_t = TPL.process_frames(seq_t, crop, expansion)
        ann_j = JPL.process_frames(seq_j, crop, expansion)
        for name, a, b in zip(ann_t._fields, ann_t, ann_j):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    for normalize in (True, False):
        m_t = TPL.load_mesh(str(demo_dir / "box.obj"), normalize)
        m_j = JPL.load_mesh(str(demo_dir / "box.obj"), normalize)
        np.testing.assert_array_equal(m_t.verts, m_j.verts)
        np.testing.assert_array_equal(m_t.faces, m_j.faces)


@pytest.mark.mid
@pytest.mark.parametrize("mode,parallel", MODES, ids=[f"{m}-{'par' if p else 'seq'}" for m, p in MODES])
def test_track_sequence_matches(box, mode, parallel):
    want = box["results"][(mode, parallel)]
    got = TPL.track_sequence(
        _mode_config(box["cfg"], mode, parallel), box["seq"], box["ann"], box["mesh"],
        view_rotations=box["view_rots"] if mode == "random" else None, device="cpu",
    )
    np.testing.assert_array_equal(got.selected_idx, want.selected_idx)
    assert got.selected_idx.dtype == want.selected_idx.dtype
    np.testing.assert_array_equal(got.K, want.K)
    np.testing.assert_allclose(got.K_rois, want.K_rois, rtol=1e-6)
    for name, tol in (("init_rotations_row", INIT_TOL), ("init_translations", INIT_TOL),
                      ("rotations_row", FINAL_TOL), ("translations", FINAL_TOL)):
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=tol, err_msg=name)
    np.testing.assert_allclose(got.refine_loss, want.refine_loss, rtol=1e-2)
    np.testing.assert_array_equal(got.refine_iou.shape, want.refine_iou.shape)
    assert set(got.history) == set(want.history)
    for k in ("loss", "loss_sil_obj", "loss_smooth_obj", "bin_overflow"):
        np.testing.assert_allclose(got.history[k], want.history[k], atol=HISTORY_TOL, err_msg=k)
    eye = np.einsum("bij,bkj->bik", got.rotations_row, got.rotations_row)
    np.testing.assert_allclose(eye, np.tile(np.eye(3), (FRAMES, 1, 1)), atol=1e-4)


def _tree(root):
    out = set()
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for f in files:
            # Event files carry the host name and a timestamp.
            out.add(os.path.join(rel, "events" if f.startswith("events.out") else f))
    return out


@pytest.mark.mid
def test_run_module_writes_the_same_artifacts(box):
    out = box["work"] / "torch_exps"
    proc = subprocess.run(
        [sys.executable, "-m", "dynhor_tpu_torch.run", "--config_path", str(box["cfg_path"]),
         "--exps_root", str(out), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1].startswith(f"tracked {FRAMES} frames; final joint loss")
    assert "[profile] host preprocessing" in proc.stdout and "[profile] refine" in proc.stdout
    exp = out / "boxseq" / "pred"
    assert _tree(exp) == _tree(box["jax_exp"])
    assert filecmp.cmp(exp / "config.yaml", box["cfg_path"], shallow=False)
    for fid in box["seq"].frame_ids:
        got = JA.load_pose_npz(str(exp), fid)
        want = JA.load_pose_npz(str(box["jax_exp"]), fid)
        assert set(got) == {"R", "T", "K"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.float32 and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], atol=FINAL_TOL, err_msg=k)


def test_run_without_a_device_needs_a_card(tmp_path, monkeypatch):
    from dynhor_tpu_torch import run as TRUN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({"seq_name": "s", "data_info": {"dataroot": str(tmp_path / "none")}}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRUN.main(["--config_path", str(cfg), "--exps_root", str(tmp_path / "exps")])
    assert not (tmp_path / "exps").exists()


@pytest.mark.parametrize("key,value", [("devices", 2)])
def test_unported_options_raise(key, value):
    """``devices`` is ported: in one process ``devices: 2`` shards the views
    over one rank, as the JAX package runs on a one-chip host (over two
    ranks: tests/test_torch_parallel.py), and no option of the config
    raises as unported."""
    cfg = copy.deepcopy(TCFG.DEFAULTS)
    cfg["system"][key] = value
    assert TPL.view_devices(cfg["system"]) == 1
    assert not hasattr(TPL, "_check_ported")


class _Spy:
    """Wraps a module function and keeps each call's arguments and result."""

    def __init__(self, module, name, monkeypatch):
        self.fn, self.calls = getattr(module, name), []
        monkeypatch.setattr(module, name, self)

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((args, kw, out))
        return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.mid
@pytest.mark.parametrize("parallel", [True, False], ids=["par", "seq"])
def test_track_sequence_multihyp_matches(box, monkeypatch, capsys, parallel):
    from dynhor_tpu.tracker import refine as JRF
    from dynhor_tpu.tracker import selection as JSEL
    from dynhor_tpu_torch.tracker import refine as TRF
    from dynhor_tpu_torch.tracker import selection as TSEL

    cfg = _mode_config(box["cfg"], "grid", parallel)
    cfg["system"]["num_initializations"] = 4
    cfg["system"]["hypotheses"]["tournament_iters"] = 4
    # The JAX package's default attention, written out, on both sides: the
    # port's default kernel keeps the scores in f32, which moves this
    # near-tie tournament's poses past INIT_TOL (its plain version is held
    # to the JAX package's attention in test_torch_flash.py).
    monkeypatch.setattr(TPL.dino_mod, "config_for_model",
                        functools.partial(TPL.dino_mod.config_for_model, attn_impl="xla"))
    grid = np.array(JP.prior_view_rotations(jax.random.PRNGKey(0), JP.PriorConfig(grid=tuple(GRID))))
    spies = {}
    if parallel:
        for tag, sel_mod, rf_mod in (("jax", JSEL, JRF), ("torch", TSEL, TRF)):
            spies[tag] = (_Spy(sel_mod, "build_hypotheses", monkeypatch),
                          _Spy(rf_mod, "refine_poses_multihyp", monkeypatch))
        want = JPL.track_sequence(cfg, box["seq"], box["ann"], box["mesh"])
    else:
        want = box["results"][("grid", False)]
    capsys.readouterr()
    got = TPL.track_sequence(cfg, box["seq"], box["ann"], box["mesh"], view_rotations=grid,
                             device="cpu")
    printed = capsys.readouterr().out
    np.testing.assert_array_equal(got.selected_idx, want.selected_idx)
    assert got.selected_idx.dtype == want.selected_idx.dtype
    if parallel:
        (hj, mj), (ht, mt) = spies["jax"], spies["torch"]
        assert len(hj.calls) == len(ht.calls) == 1 == len(mj.calls) == len(mt.calls)
        sil_j, sil_t = hj.calls[0][1]["sil_scores"], ht.calls[0][1]["sil_scores"]
        assert sil_t.shape == (FRAMES, len(grid))
        np.testing.assert_array_equal(_np(sil_t), _np(sil_j))
        hyp_j, hyp_t = hj.calls[0][2], ht.calls[0][2]
        np.testing.assert_array_equal(hyp_t.indices.numpy(), np.asarray(hyp_j.indices))
        np.testing.assert_array_equal(hyp_t.rotations.numpy(), np.asarray(hyp_j.rotations))
        assert (hyp_t.indices.numpy()[:, 1:3] == -1).all() and (hyp_t.indices.numpy()[:, 3] >= 0).all()
        res_j, res_t = mj.calls[0][2], mt.calls[0][2]
        lj, lt = np.asarray(res_j.tournament_loss), _np(res_t.tournament_loss)
        np.testing.assert_allclose(lt, lj, rtol=1e-2)
        srt = np.sort(lj, axis=1)
        decided = (srt[:, 1] - srt[:, 0]) > 1e-2 * np.abs(srt[:, 0])
        win_j, win_t = np.asarray(res_j.winner), res_t.winner.numpy()
        np.testing.assert_array_equal(win_t[decided], win_j[decided])
        print(f"near-tie frames {np.nonzero(~decided)[0].tolist()}; winners {win_t.tolist()} "
              f"(JAX {win_j.tolist()})")
        assert printed.count("[hypotheses] 4 inits/frame + 1 propagation round(s)") == 1
    else:
        assert "note: num_initializations > 1 is a parallel-pipeline feature" in printed
    for name, tol in (("init_rotations_row", INIT_TOL), ("init_translations", INIT_TOL),
                      ("rotations_row", FINAL_TOL), ("translations", FINAL_TOL)):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(got.refine_loss, want.refine_loss, rtol=1e-2)


def test_vis_module_writes_the_same_overlays(box, tmp_path, monkeypatch):
    import importlib.util
    import shutil

    from PIL import Image

    from dynhor_tpu.utils import compcache
    from dynhor_tpu_torch import vis as TVIS

    roots = {tag: tmp_path / tag for tag in ("jax", "torch")}
    for root in roots.values():
        shutil.copytree(box["jax_exp"], root / "boxseq" / "pred")
    cfg = str(roots["jax"] / "boxseq" / "pred" / "config.yaml")
    spec = importlib.util.spec_from_file_location("vis_script", REPO / "vis.py")
    vis_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vis_script)
    monkeypatch.setattr(compcache, "enable_persistent_cache", lambda *a, **k: "")
    monkeypatch.setattr(sys, "argv", ["vis.py", "--config_path", cfg,
                                      "--exps_root", str(roots["jax"])])
    vis_script.main()
    argv = ["--config_path", cfg, "--exps_root", str(roots["torch"])]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TVIS.main(argv)
    assert not (roots["torch"] / "boxseq" / "pred" / "render_res").exists()
    written = TVIS.main(argv + ["--device", "cpu"])
    assert _tree(roots["torch"]) == _tree(roots["jax"])
    names = sorted(os.listdir(roots["jax"] / "boxseq" / "pred" / "render_res"))
    assert names == [f"{fid}.jpg" for fid in box["seq"].frame_ids]
    assert sorted(os.path.basename(p) for p in written) == names
    for name in names:
        a, b = (np.asarray(Image.open(root / "boxseq" / "pred" / "render_res" / name), np.int16)
                for root in (roots["torch"], roots["jax"]))
        assert a.shape == (120, 160, 3)
        assert int(np.abs(a - b).max()) <= 1, name


def test_profiler_phases_and_trace(tmp_path):
    from dynhor_tpu_torch.utils.profiling import Profiler

    prof = Profiler(trace_dir=str(tmp_path / "trace"), device="cpu")
    for _ in range(2):
        with prof.phase("a"):
            torch.ones(8).sum()
    with prof.phase("b"):
        pass
    lines = []
    times = prof.summary(lines.append)
    assert set(times) == {"a", "b"} and all(v >= 0 for v in times.values())
    assert lines[-1].startswith("[profile] total:") and len(lines) == 3
    assert sorted(os.listdir(tmp_path / "trace")) == ["a.json", "b.json"]
    off = Profiler(enabled=False)
    with off.phase("a"):
        pass
    assert off.summary(lines.append) == {}
