"""The port's host side of ``run.py`` vs the JAX package: config, ingest,
artifacts and the DINOv2 checkpoint loader, and the demo-data twin.

- config: the port's ``DEFAULTS`` equal the JAX package's, ``load_config``
  gives equal dicts from one YAML file, ``_merge`` and ``experiment_dir``
  agree;
- ingest: ``validate_dataroot`` gives the same findings (level, place and
  message) on every input of tests/test_ingest.py, and ``validate_or_raise``
  raises where the JAX one does;
- artifacts: the port's npz files are byte-identical to the JAX package's
  and its ``load_pose_npz`` reads them back; ``copy_config`` and ``Board``
  write the same tree;
- checkpoint: a full-size official-layout file from the port's
  ``tools.make_dino_checkpoint`` (.npz and .pth; its values are the JAX
  tool's, tests/test_torch_tools.py) gives equal parameters in
  both packages (exact), as does a HuggingFace-named one;
- the demo-data twin on the box mesh at 120x160, 3 frames: both packages'
  ``validate_or_raise`` accept it, and its correspondences reproject under
  its own gt_poses.npz within 0.5 px.
"""
import copy
import filecmp
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from dynhor_tpu.io import artifacts as JA
from dynhor_tpu.io import config as JCFG
from dynhor_tpu.io import ingest as JI
from dynhor_tpu.models import dino as JD
from dynhor_tpu_torch.io import artifacts as TA
from dynhor_tpu_torch.io import config as TCFG
from dynhor_tpu_torch.io import ingest as TI
from dynhor_tpu_torch.models import dino as TD
from dynhor_tpu_torch.tools.make_dino_checkpoint import official_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from test_ingest import _write_seq  # noqa: E402
from test_pipeline_e2e import _write_box_obj  # noqa: E402


def test_defaults_and_merge_match():
    assert TCFG.DEFAULTS == JCFG.DEFAULTS
    user = {"seq_name": "s", "system": {"prior": {"num_views": 7, "prescreen": {"topk": 3}},
                                        "loss": {"lw_sil_obj": 2.0}, "devices": 1}}
    got = TCFG._merge(copy.deepcopy(TCFG.DEFAULTS), copy.deepcopy(user))
    want = JCFG._merge(copy.deepcopy(JCFG.DEFAULTS), copy.deepcopy(user))
    assert got == want
    assert got["system"]["prior"]["view_chunk"] == 25  # untouched sibling kept
    assert TCFG.experiment_dir(got, "/x") == JCFG.experiment_dir(want, "/x") == "/x/s/pred"


def test_load_config_matches(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"seq_name": "q", "exp_name": "e", "random_render": False,
                                    "system": {"crop_size": 64, "dino": {"smaller_edge_size": 56}}}))
    got, want = TCFG.load_config(str(path)), JCFG.load_config(str(path))
    assert got == want
    assert got["_config_path"] == os.path.abspath(path)


INGEST_CASES = {
    "clean": {},
    "miswired": {"obj_channel": 0},
    "soft": {"soft_mask": True},
    "seg_size": {"seg_size": (16, 20)},
    "missing_seg": {"skip_seg_for": ("0001",)},
    "normal_encoding": {"normal_encoding": "raw01"},
    "normalized_corr": {"corr": "normalized"},
    "bad_corr_keys": {"corr": "badkeys"},
    "missing_rgb": None,
}


@pytest.mark.parametrize("case", list(INGEST_CASES))
def test_validate_dataroot_matches(tmp_path, case):
    root = tmp_path / "seq"
    if INGEST_CASES[case] is None:
        root.mkdir()
    else:
        np.random.seed(0)
        _write_seq(root, **INGEST_CASES[case])
    got = [tuple(f) for f in TI.validate_dataroot(str(root))]
    want = [tuple(f) for f in JI.validate_dataroot(str(root))]
    assert got == want
    assert bool(want) == (case != "clean")
    if any(f[0] == "error" for f in want):
        for pkg in (TI, JI):
            with pytest.raises(pkg.IngestError):
                pkg.validate_or_raise(str(root))
    else:
        TI.validate_or_raise(str(root))
        assert case in ("clean", "normal_encoding", "normalized_corr")


@pytest.mark.parametrize("obj_scale", [None, 1.25])
def test_pose_npzs_are_byte_identical(tmp_path, obj_scale):
    rng = np.random.default_rng(0)
    ids = ["0000", "0001", "0002"]
    R = rng.standard_normal((3, 3, 3)).astype(np.float32)
    T = rng.standard_normal((3, 1, 3)).astype(np.float32)
    K = rng.standard_normal((3, 3)).astype(np.float32)
    TA.save_pose_npzs(str(tmp_path / "t"), ids, R, T, K, obj_scale)
    JA.save_pose_npzs(str(tmp_path / "j"), ids, R, T, K, obj_scale)
    for fid in ids:
        a, b = (tmp_path / d / "obj_infos" / f"{fid}.npz" for d in ("t", "j"))
        assert a.read_bytes() == b.read_bytes()
        got = JA.load_pose_npz(str(tmp_path / "t"), fid)
        mine = TA.load_pose_npz(str(tmp_path / "t"), fid)
        assert set(got) == set(mine) == ({"R", "T", "K"} | ({"obj_scale"} if obj_scale else set()))
        np.testing.assert_array_equal(got["R"], R[int(fid)].T)
        for k in got:
            np.testing.assert_array_equal(got[k], mine[k])
    assert TA.load_pose_npz(str(tmp_path / "t"), "0009") is None


def test_config_copy_and_board_tree(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("seq_name: q\n")
    for pkg, d in ((TA, "t"), (JA, "j")):
        pkg.copy_config(str(tmp_path / d), str(cfg))
        board = pkg.Board(str(tmp_path / d))
        board.add_history({"loss": np.array([1.0, 0.5])})
        board.add_scalar("outlier_score_px", 2.0, 0)
        board.close()
    for d in ("t", "j"):
        assert filecmp.cmp(cfg, tmp_path / d / "config.yaml", shallow=False)
        assert any(n.startswith("events.out.tfevents") for n in os.listdir(tmp_path / d / "board"))


def _flat(tree):
    return {k: np.asarray(v) for k, v in _items(tree)}


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _assert_params_equal(t_params, j_params):
    t = {k: v.numpy() for k, v in _items(t_params)}
    j = _flat(jax.tree.map(np.asarray, j_params))
    assert set(t) == set(j)
    for k in t:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_full_size_checkpoint_loads_equal_in_both(tmp_path, fmt):
    sd = official_state_dict(seed=3)
    path = tmp_path / f"ckpt.{fmt}"
    if fmt == "npz":
        np.savez(path, **sd)
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    t_params, t_cfg = TD.load_params(str(path), TD.config_for_model("dinov2_vitb14"))
    j_params, j_cfg = JD.load_params(str(path), JD.config_for_model("dinov2_vitb14"))
    _assert_params_equal(t_params, j_params)
    assert (t_cfg.embed_dim, t_cfg.depth, t_cfg.num_heads, t_cfg.pos_grid) == (
        j_cfg.embed_dim, j_cfg.depth, j_cfg.num_heads, j_cfg.pos_grid) == (768, 12, 12, 37)


def test_huggingface_names_and_inferred_architecture_match():
    """A small transformers-named state_dict (embed 128, depth 2, grid 3)
    configured as vitb14: both packages infer the same architecture."""
    rng = np.random.default_rng(1)
    d, depth, p = 128, 2, 14

    def r(*s):
        return rng.standard_normal(s).astype(np.float32)

    sd = {"embeddings.cls_token": r(1, 1, d), "embeddings.position_embeddings": r(1, 10, d),
          "embeddings.patch_embeddings.projection.weight": r(d, 3, p, p),
          "embeddings.patch_embeddings.projection.bias": r(d),
          "layernorm.weight": r(d), "layernorm.bias": r(d)}
    for i in range(depth):
        pre = f"encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            sd[pre + n + ".weight"], sd[pre + n + ".bias"] = r(d), r(d)
        for n in ("query", "key", "value"):
            sd[pre + f"attention.attention.{n}.weight"] = r(d, d)
            sd[pre + f"attention.attention.{n}.bias"] = r(d)
        sd[pre + "attention.output.dense.weight"], sd[pre + "attention.output.dense.bias"] = r(d, d), r(d)
        sd[pre + "layer_scale1.lambda1"], sd[pre + "layer_scale2.lambda1"] = r(d), r(d)
        sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"] = r(4 * d, d), r(4 * d)
        sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"] = r(d, 4 * d), r(d)
    t_params, t_cfg = TD.convert_torch_state_dict(sd)
    j_params, j_cfg = JD.convert_torch_state_dict(sd)
    _assert_params_equal(t_params, j_params)
    assert (t_cfg.embed_dim, t_cfg.depth, t_cfg.num_heads, t_cfg.pos_grid) == (
        j_cfg.embed_dim, j_cfg.depth, j_cfg.num_heads, j_cfg.pos_grid) == (128, 2, 2, 3)


def test_demo_data_twin_validates_and_reprojects(tmp_path):
    from dynhor_tpu_torch.tools import make_demo_data as MD
    from dynhor_tpu_torch.utils import camera as TC

    _write_box_obj(tmp_path / "box.obj")
    out = tmp_path / "seq"
    MD.main(["--out", str(out), "--obj", str(tmp_path / "box.obj"), "--frames", "3",
             "--height", "120", "--width", "160", "--device", "cpu"])
    assert sorted(os.listdir(out)) == [
        "correspondence_infos", "gt_poses.npz", "monocular_normal", "rgb", "sam_seg"]
    assert sorted(os.listdir(out / "rgb")) == ["0000.jpg", "0001.jpg", "0002.jpg"]
    JI.validate_or_raise(str(out))
    TI.validate_or_raise(str(out))
    assert not [f for f in TI.validate_dataroot(str(out)) if f.level != "info"]
    gt = np.load(out / "gt_poses.npz")
    assert gt["R"].shape == (3, 3, 3) and gt["T"].shape == (3, 3)
    # Each match is triangulated from both frames' rays under the GT poses;
    # the point must project back onto both pixels.
    K = torch.as_tensor(gt["K"])
    pairs = sorted(os.listdir(out / "correspondence_infos"))
    assert pairs == ["pairs_0000_0001.npz", "pairs_0001_0002.npz"]
    for name in pairs:
        d = np.load(out / "correspondence_infos" / name)
        i, j = int(str(d["frame_i"])), int(str(d["frame_j"]))
        Ri, Rj = gt["R"][i].T, gt["R"][j].T  # row convention
        pts = _triangulate(d["xy_i"], d["xy_j"], Ri, gt["T"][i], Rj, gt["T"][j], gt["K"])
        for R, T, xy in ((Ri, gt["T"][i], d["xy_i"]), (Rj, gt["T"][j], d["xy_j"])):
            uv = TC.batch_proj2d(torch.as_tensor(pts @ R + T)[None], K[None])[0].numpy()
            assert np.abs(uv - xy).max() < 0.5, name


def _triangulate(xy_a, xy_b, Ra, Ta, Rb, Tb, K):
    """Linear (DLT) triangulation of matched pixels of two posed views."""
    out = []
    for ua, ub in zip(xy_a.astype(np.float64), xy_b.astype(np.float64)):
        rows = []
        for (u, v), R, T in ((ua, Ra, Ta), (ub, Rb, Tb)):
            P = K.astype(np.float64) @ np.concatenate([R.T, T.reshape(3, 1)], axis=1)
            rows += [u * P[2] - P[0], v * P[2] - P[1]]
        _, _, vt = np.linalg.svd(np.stack(rows))
        out.append(vt[-1, :3] / vt[-1, 3])
    return np.asarray(out, np.float32)
