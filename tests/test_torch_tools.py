"""The port's tools (``dynhor_tpu_torch/tools/``) against the JAX package's
(``tools/``) on the CPU.

- Data and checkpoint tools on the same files: the same printed lines,
  arrays, exit codes, OBJ text, state_dict keys, shapes and dtypes, and
  converted parameters.
- Ablations with a recorder in place of ``track_sequence`` in both packages
  (canned results, no pipeline compute): each JAX tool's ``main`` and the
  port's on the same arguments hand the pipeline the same configs and print
  the same summaries.
- The probes' pieces at a tiny size against the whole function they split.
- ``weak_scaling`` and ``warm_cache`` at a tiny size.
"""
import copy
import dataclasses
import importlib.util
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dynhor_tpu_torch.tools import ab_prescreen as T_ab
from dynhor_tpu_torch.tools import ablate_fine_edge as T_edge
from dynhor_tpu_torch.tools import ablate_multihyp as T_mh
from dynhor_tpu_torch.tools import ablate_oracle_init as T_oracle
from dynhor_tpu_torch.tools import convert_dino_checkpoint as T_conv
from dynhor_tpu_torch.tools import eval_poses as T_eval
from dynhor_tpu_torch.tools import export_gt_poses as T_export
from dynhor_tpu_torch.tools import ingest_data as T_ingest
from dynhor_tpu_torch.tools import make_dino_checkpoint as T_mkckpt
from dynhor_tpu_torch.tools import make_kettle_mesh as T_kettle

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).parent))
from test_ingest import _write_seq  # noqa: E402


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(monkeypatch, capsys, name, argv: list[str]):
    """(return value, stdout) of the JAX tool's ``main`` on ``argv``; ``name``
    is the tool's name or its module."""
    mod = jax_tool(name) if isinstance(name, str) else name
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    out = mod.main()
    return out, capsys.readouterr().out


def run_port(capsys, main, argv):
    capsys.readouterr()
    out = main(argv)
    return out, capsys.readouterr().out


def _rotations(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


def _gt(path, n=6, seed=0):
    rng = np.random.default_rng(seed)
    np.savez(path, R=_rotations(n, seed), T=rng.standard_normal((n, 3)).astype(np.float32),
             K=np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32))


# ---------------------------------------------------------------------------
# Data and checkpoint tools
# ---------------------------------------------------------------------------

def test_eval_poses_matches(tmp_path, monkeypatch, capsys):
    _gt(tmp_path / "gt.npz", 6, 0)
    gt = np.load(tmp_path / "gt.npz")
    (tmp_path / "exp" / "obj_infos").mkdir(parents=True)
    near = _rotations(6, 1) * 0.02 + gt["R"]  # close to GT, one frame far off
    near[3] = _rotations(1, 2)[0]
    for i in range(6):
        u, _, vt = np.linalg.svd(near[i])
        np.savez(tmp_path / "exp" / "obj_infos" / f"{i:04d}.npz", R=(u @ vt).astype(np.float32),
                 T=(gt["T"][i] + 0.01 * i).astype(np.float32)[None], K=gt["K"])
    argv = ["--exp", str(tmp_path / "exp"), "--gt", str(tmp_path / "gt.npz")]
    _, want = run_jax(monkeypatch, capsys, "eval_poses", argv)
    got, text = run_port(capsys, T_eval.main, argv)
    assert text == want
    assert got["rot_deg"].shape == (6,) and got["rot_deg"][3] > 10 > got["rot_deg"][0]
    np.testing.assert_allclose(got["trans"], 0.01 * np.arange(6) * np.sqrt(3), rtol=1e-4)
    with pytest.raises(SystemExit, match="no poses"):
        T_eval.evaluate(str(tmp_path), str(tmp_path / "gt.npz"))


def test_export_gt_poses_matches(tmp_path, monkeypatch, capsys):
    data = tmp_path / "seq"
    data.mkdir()
    _gt(data / "gt_poses.npz", 5, 3)
    _, want = run_jax(monkeypatch, capsys, "export_gt_poses",
                      ["--data", str(data), "--out", str(tmp_path / "j")])
    _, got = run_port(capsys, T_export.main, ["--data", str(data), "--out", str(tmp_path / "t")])
    assert got == want.replace(str(tmp_path / "j"), str(tmp_path / "t"))
    for i in range(5):
        a, b = np.load(tmp_path / "j" / f"{i:04d}.npz"), np.load(tmp_path / "t" / f"{i:04d}.npz")
        assert sorted(a.files) == sorted(b.files) == ["K", "R", "T"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    monkeypatch.chdir(tmp_path)  # the default: exps/<seq>/gt/obj_infos
    assert T_export.export(str(data)) == (5, "exps/seq/gt/obj_infos")


@pytest.mark.parametrize("defect", [{}, {"obj_channel": 0, "soft_mask": True}, {"corr": None}],
                         ids=["ok", "miswired", "no-corr"])
def test_ingest_data_matches(tmp_path, monkeypatch, capsys, defect):
    _write_seq(tmp_path / "seq", **defect)
    rc_j, want = run_jax(monkeypatch, capsys, "ingest_data", [str(tmp_path / "seq")])
    rc_t, got = run_port(capsys, T_ingest.main, [str(tmp_path / "seq"), "--max-frames", "3"])
    assert (rc_t, got) == (rc_j, want)
    assert rc_t == (1 if defect.get("soft_mask") else 0)


def test_make_kettle_mesh_matches(tmp_path, monkeypatch, capsys):
    _, want = run_jax(monkeypatch, capsys, "make_kettle_mesh", ["--out", str(tmp_path / "j/k.obj")])
    _, got = run_port(capsys, T_kettle.main, ["--out", str(tmp_path / "t/k.obj")])
    assert got == want.replace("/j/", "/t/")
    assert (tmp_path / "t/k.obj").read_text() == (tmp_path / "j/k.obj").read_text()
    assert (REPO / "assets/kettle/kettle.obj").read_text() == (tmp_path / "t/k.obj").read_text()
    verts, faces = T_kettle.kettle_mesh()
    assert faces.shape == (2184, 3) and faces.max() == len(verts) - 1


def test_make_dino_checkpoint_matches(tmp_path, monkeypatch, capsys):
    sd_j = jax_tool("make_dino_checkpoint").official_state_dict(1)
    sd_t = T_mkckpt.official_state_dict(1)
    assert list(sd_t) == list(sd_j)
    for k in sd_j:
        assert sd_t[k].dtype == sd_j[k].dtype and sd_t[k].shape == sd_j[k].shape
        np.testing.assert_array_equal(sd_t[k], sd_j[k])
    mod = jax_tool("make_dino_checkpoint")
    for m in (mod, T_mkckpt):  # the files at depth 2: the same code, less to write
        monkeypatch.setattr(m, "DEPTH", 2)
    for ext, flag in ((".npz", []), (".pth", ["--pth"])):
        _, want = run_jax(monkeypatch, capsys, mod, [str(tmp_path / f"j{ext}")] + flag)
        _, got = run_port(capsys, T_mkckpt.main, [str(tmp_path / f"t{ext}")] + flag)
        assert got == want.replace(f"j{ext}", f"t{ext}")
    a = torch.load(tmp_path / "j.pth", weights_only=True)
    b = torch.load(tmp_path / "t.pth", weights_only=True)
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _tiny_official(seed=0, dim=64, depth=2, grid=4, patch=14):
    """An official-naming DINOv2 state_dict at a tiny width."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy((0.02 * rng.standard_normal(s)).astype(np.float32))  # noqa: E731
    sd = {"cls_token": t(1, 1, dim), "pos_embed": t(1, grid * grid + 1, dim),
          "mask_token": t(1, dim), "patch_embed.proj.weight": t(dim, 3, patch, patch),
          "patch_embed.proj.bias": t(dim), "norm.weight": t(dim), "norm.bias": t(dim)}
    shapes = {"norm1.weight": (dim,), "norm1.bias": (dim,), "attn.qkv.weight": (3 * dim, dim),
              "attn.qkv.bias": (3 * dim,), "attn.proj.weight": (dim, dim), "attn.proj.bias": (dim,),
              "ls1.gamma": (dim,), "norm2.weight": (dim,), "norm2.bias": (dim,),
              "mlp.fc1.weight": (4 * dim, dim), "mlp.fc1.bias": (4 * dim,),
              "mlp.fc2.weight": (dim, 4 * dim), "mlp.fc2.bias": (dim,), "ls2.gamma": (dim,)}
    for i in range(depth):
        sd.update({f"blocks.{i}.{k}": t(*s) for k, s in shapes.items()})
    return sd


@pytest.mark.parametrize("wrapped", [False, True], ids=["state_dict", "wrapped"])
def test_convert_dino_checkpoint_matches(tmp_path, monkeypatch, capsys, wrapped):
    import jax

    from dynhor_tpu.models import dino as JD

    sd = _tiny_official()
    torch.save({"state_dict": sd} if wrapped else sd, tmp_path / "src.pth")
    _, want = run_jax(monkeypatch, capsys, "convert_dino_checkpoint",
                      [str(tmp_path / "src.pth"), str(tmp_path / "j.npz")])
    got, text = run_port(capsys, T_conv.main, [str(tmp_path / "src.pth"), str(tmp_path / "t.npz")])
    assert text == want.replace("j.npz", "t.npz")
    a, b = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(a.files) == sorted(b.files) == sorted(sd)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    params_j, cfg_j = JD.convert_torch_state_dict(dict(a))
    params_t, cfg_t = T_conv.D.convert_torch_state_dict(dict(b))
    assert (cfg_t.embed_dim, cfg_t.depth, cfg_t.pos_grid) == (cfg_j.embed_dim, cfg_j.depth, 4)
    leaves_j = jax.tree_util.tree_leaves_with_path(params_j)
    assert len(leaves_j) == len(list(T_conv._leaves(params_t)))
    for path, leaf in leaves_j:
        node = params_t
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert got["params"] == sum(int(np.prod(leaf.shape)) for _, leaf in leaves_j)


# ---------------------------------------------------------------------------
# Ablations through a recorder
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for ``track_sequence``: records each call's config and
    ViT edge and hands back canned results, one per call in turn."""

    def __init__(self, results):
        self.results = results
        self.calls = []

    def __call__(self, config, seq, ann, mesh, dino_params=None, dino_cfg=None, **kw):
        cfg = copy.deepcopy(config)
        cfg.pop("_config_path")
        self.calls.append((cfg, dino_cfg.smaller_edge_size))
        return self.results[(len(self.calls) - 1) % len(self.results)]


def _canned(n_frames, gt_R, seed):
    """A result whose rotations are GT's with seeded perturbations."""
    rng = np.random.default_rng(seed)
    gt_row = np.swapaxes(gt_R, -1, -2)

    def near(scale):
        out = []
        for r in gt_row + scale * rng.standard_normal(gt_row.shape).astype(np.float32):
            u, _, vt = np.linalg.svd(r)
            out.append(u @ vt * np.linalg.det(u @ vt))
        return np.asarray(out, np.float32)

    return types.SimpleNamespace(
        rotations_row=near(0.05), init_rotations_row=near(0.3),
        selected_idx=rng.integers(0, 40, n_frames),
        history={"iou_object": np.array([0.5, 0.7 + 0.05 * seed], np.float32)},
    )


@pytest.fixture
def recorded(tmp_path, monkeypatch):
    """A config whose dataroot holds only gt_poses.npz, the loaders of both
    packages stubbed, and one Recorder per package."""
    import dynhor_tpu.models.dino as JD
    import dynhor_tpu.tracker.pipeline as JPL
    import dynhor_tpu.utils.compcache as JCC
    import dynhor_tpu_torch.models.dino as TD
    import dynhor_tpu_torch.tracker.pipeline as TPL

    data = tmp_path / "seq"
    data.mkdir()
    _gt(data / "gt_poses.npz", 5, 4)
    cfg = tmp_path / "c.yaml"
    cfg.write_text(yaml.safe_dump({"seq_name": "seq", "data_info": {
        "dataroot": str(data), "obj_path": "mesh.obj", "normalize_mesh": True},
        "system": {"prior": {"num_views": 77}}}))
    gt_R = np.load(data / "gt_poses.npz")["R"]
    canned = [_canned(5, gt_R, s) for s in range(4)]
    recs = {"jax": Recorder(canned), "torch": Recorder(canned)}
    monkeypatch.setattr(JCC, "enable_persistent_cache", lambda *a, **k: None)
    for mod, dino, rec in ((JPL, JD, recs["jax"]), (TPL, TD, recs["torch"])):
        monkeypatch.setattr(mod, "load_sequence", lambda root: "seq")
        monkeypatch.setattr(mod, "process_frames", lambda seq, s, e: "ann")
        monkeypatch.setattr(mod, "load_mesh", lambda path, normalize=True: "mesh")
        monkeypatch.setattr(mod, "track_sequence", rec)
        monkeypatch.setattr(dino, "load_params", lambda ckpt, cfg, *a, **k: ({}, cfg))
    return str(cfg), recs


def _unwalled(text):
    return re.sub(r"wall \d+\.\ds", "wall _s", re.sub(r"\(\d+\.\d\dx\)", "(_x)", text))


@pytest.mark.parametrize("name,main,argv", [
    ("ablate_oracle_init", T_oracle.main, ["--init-iters", "7", "--joint-iters", "9"]),
    ("ablate_oracle_init", T_oracle.main, ["--views", "33"]),
    ("ablate_multihyp", T_mh.main, ["--k", "3", "--tournament", "5", "--propagate-rounds", "2"]),
    ("ablate_multihyp", T_mh.main, ["--smooth-weight", "0.5", "--skip-k1"]),
    ("ab_prescreen", T_ab.main, ["--variants", "224:2:48,112:3:16"]),
    ("ablate_fine_edge", T_edge.main, ["--edges", "518", "252", "--views", "40"]),
], ids=["oracle", "oracle-views", "multihyp", "multihyp-skip-k1", "prescreen", "fine-edge"])
def test_ablation_configs_and_summaries_match(recorded, monkeypatch, capsys, name, main, argv):
    config, recs = recorded
    argv = ["--config", config] + argv
    _, want = run_jax(monkeypatch, capsys, name, argv)
    got, text = run_port(capsys, main, argv + ["--device", "cpu"])
    assert recs["torch"].calls == recs["jax"].calls
    assert len(recs["torch"].calls) >= 1
    assert _unwalled(text) == _unwalled(want)


def test_ab_prescreen_views_and_agreement(recorded, capsys):
    config, recs = recorded
    got, _ = run_port(capsys, T_ab.main, ["--config", config, "--views", "1000", "--device", "cpu"])
    assert [c["system"]["prior"]["num_views"] for c, _ in recs["torch"].calls] == [1000, 1000]
    assert [c["system"]["prior"]["prescreen"]["enabled"] for c, _ in recs["torch"].calls] == [
        False, True]
    same = int((got["single-stage"]["result"].selected_idx
                == got["two-stage e224/s2/k48"]["result"].selected_idx).sum())
    assert got["agreement"] == {"two-stage e224/s2/k48": same}


def test_ablation_errors_are_geodesic_degrees(recorded, capsys):
    config, _ = recorded
    got, _ = run_port(capsys, T_oracle.main, ["--config", config, "--device", "cpu"])
    gt = np.load(Path(config).parent / "seq" / "gt_poses.npz")["R"]
    for arm in ("dino-gate", "oracle-init"):
        r = got[arm]["result"]
        rel = np.einsum("fij,fkj->fik", r.rotations_row, np.swapaxes(gt, -1, -2))
        want = np.degrees(np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1)))
        np.testing.assert_allclose(got[arm]["joint_rot_err"], want, atol=1e-3)


# ---------------------------------------------------------------------------
# Probes: their pieces at a tiny size against the whole they split
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def box_obj(tmp_path_factory):
    """tests/test_pipeline_e2e.py's box (12 faces) as an OBJ file."""
    from test_pipeline_e2e import _write_box_obj

    path = tmp_path_factory.mktemp("box") / "box.obj"
    _write_box_obj(path)
    return str(path)


TINY_VIT = dict(patch_size=8, embed_dim=32, depth=1, num_heads=2, pos_grid=4, smaller_edge_size=32)


@pytest.fixture(autouse=True)
def _one_thread():
    """Loops of small ops on one torch thread: under the suite's workers
    torch's own threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_probe_vit_fused_pieces():
    from dynhor_tpu_torch.models import dino as TD
    from dynhor_tpu_torch.tools import probe_vit_fused as PV

    cfg = TD.DinoConfig(**TINY_VIT)
    ps = PV.pieces("cpu", cfg, frames=2, crop=24, dtype=torch.float32)
    assert list(ps) == ["remat='frozen'", "remat='dots'", "remat=False", "remat=True"]
    grads = {k: fn() for k, fn in ps.items()}
    params = TD.init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.rand((2, 3, 24, 24), generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    (TD.forward_tokens_from_crop(params, x, cfg).float() ** 2).mean().backward()
    for k, g in grads.items():
        torch.testing.assert_close(g, x.grad, rtol=1e-6, atol=1e-9, msg=k)


def test_probe_step_breakdown_pieces(box_obj):
    from dynhor_tpu_torch.models import dino as TD
    from dynhor_tpu_torch.tools import probe_step_breakdown as PS
    from dynhor_tpu_torch.tracker import refine as TR

    dcfg = TD.DinoConfig(**TINY_VIT)
    ps = PS.pieces("cpu", frames=2, crop=32, dcfg=dcfg, obj=box_obj)
    mesh, targets, rot, trans, cap, act, dp16 = ps.pop("_scene")
    assert cap >= 256 and act % 8 == 0
    assert ps["ViT f+b (fused front, frozen)"]().shape == (2, 3, 32, 32)
    for mode in ("coarse", "fine"):
        r6, t = ps[f"{mode} step" + (" (raster+sil+losses+adam)" if mode == "coarse" else " (all)")]()
        want = TR.refine_poses(mesh, targets, rot, trans, dp16, dcfg,
                               PS.step_config(mode, 32, cap, act), device="cpu")
        torch.testing.assert_close(r6, want.rot6d, rtol=0, atol=0)
        torch.testing.assert_close(t, want.translations, rtol=0, atol=0)
        assert float((r6 - TR.G.matrix_to_rot6d(rot)).abs().max()) > 0


def test_probe_raster_stages_pieces(box_obj):
    from dynhor_tpu_torch.ops.raster_fused import rasterize_silhouette
    from dynhor_tpu_torch.ops.rasterize_tiled import _detile
    from dynhor_tpu_torch.tools import probe_raster_stages as PR

    s, cap = 48, 16
    ps = PR.pieces("cpu", frames=2, s=s, cap=cap, obj=box_obj)
    rows, counts, tw = ps["bins+records+packing x2"]()
    mass, zmin, _ = ps["K1 on packed rows x2"]()
    vp, faces = PR.scene("cpu", 2, s, box_obj)
    frag, sil, overflow = rasterize_silhouette(vp, faces, (s, s), PR.SIGMA, PR.TILE, cap)
    assert int(overflow.max()) == 0
    th = -(-s // PR.TILE)
    torch.testing.assert_close(_detile(1.0 - torch.exp(-mass), th, tw, PR.TILE, s, s), sil,
                               rtol=0, atol=0)
    hit = zmin < 1e37
    torch.testing.assert_close(_detile(torch.where(hit, zmin, -1.0), th, tw, PR.TILE, s, s),
                               frag.zbuf, rtol=0, atol=0)
    assert ps["bin_faces x2"]().indices.shape[:2] == (2, th * tw)
    assert ps["fused f+b x2"]().shape == vp.shape
    bwd = PR.pieces("cpu", frames=2, s=s, cap=cap, obj=box_obj, bwd=True)
    assert bwd["K2 on packed rows x2"]().shape == rows.shape[:3] + (6,)
    g = bwd["gather+scatter f+b x2"]()
    assert g.shape == vp.shape and float(g[..., :2].abs().max()) > 0


@pytest.fixture(scope="module")
def box_mesh(box_obj):
    from dynhor_tpu_torch.tracker import pipeline as TPL

    return TPL._mesh_arrays(TPL.load_mesh(box_obj), torch.device("cpu"))


def test_probe_prior_stages_pieces(box_mesh):
    """Stage A's ranking and stage B's rescore, run as pieces, give the
    rescored columns and scores of ``prior_scores_two_stage``."""
    from dynhor_tpu_torch.models import dino as TD
    from dynhor_tpu_torch.tools import probe_prior_stages as PP
    from dynhor_tpu_torch.tracker import priors as TP

    dcfg = TD.DinoConfig(patch_size=14, embed_dim=32, depth=1, num_heads=2, pos_grid=4,
                         smaller_edge_size=56)
    dparams = TD.init_params(dcfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    crops = torch.rand((2, 3, 32, 32), generator=gen)
    masks = torch.zeros((2, 32, 32))
    masks[:, 8:24, 6:26] = 1.0
    cfg = TP.PriorConfig(num_views=24, render_h=96, render_w=96, crop_size=32, view_chunk=6,
                         dino_dtype="float32")
    rots = TP.prior_view_rotations(cfg, torch.Generator().manual_seed(0))
    c = PP.context(dparams, dcfg, box_mesh, crops, masks, cfg, rots, edge=28, scale=2, topk=2,
                   host_batch=12, device="cpu")
    ps = PP.pieces(c)
    for fn in ps.values():
        assert torch.isfinite(torch.as_tensor(fn()).float()).all()
    whole = TP.prior_scores_two_stage(
        dparams, dcfg, *box_mesh, rots, crops, masks, c.gt_feats, c.cos_masks, cfg, c.window,
        12, prescreen_edge=28, prescreen_scale=2, topk=2, device="cpu").numpy()
    idx = c.state["idx"]
    assert 2 <= len(idx) < 24
    np.testing.assert_array_equal(whole[:, idx], c.state["scores_b"].numpy())
    rest = np.setdiff1d(np.arange(24), idx)
    assert (whole[:, rest].max(1) < whole[:, idx].min(1)).all()


@pytest.mark.parametrize("encoder", ["pe", "hash"])
def test_probe_hash_step_pieces(encoder):
    """The step piece's logged loss is ``loss_fn`` at the field before the
    step; the loss-gradient piece differentiates the loss piece."""
    from dynhor_tpu_torch.neus import trainer as TT
    from dynhor_tpu_torch.neus.fields import SDFConfig
    from dynhor_tpu_torch.neus.rendering import RenderConfig
    from dynhor_tpu_torch.tools import probe_hash_step as PH
    from dynhor_tpu_torch.tools.bench_neus import synthetic_data

    sdf_cfg = SDFConfig(encoder=encoder, hidden=32, depth=2, skip_layer=1, feat_dim=16,
                        color_hidden=32, color_depth=2, hash_levels=4, hash_table_size=2**8,
                        hash_hidden=16)
    rcfg = RenderConfig(n_coarse=8, n_importance=8, up_sample_steps=2, n_shade=4)
    ps = PH.pieces("cpu", encoder, batch=16, sdf_cfg=sdf_cfg, rcfg=rcfg,
                   data=synthetic_data(frames=2, h=12, w=12))
    state, key, data, occ, rays, rgb_gt, rcfg, tcfg = ps.pop("_inputs")
    assert ps["render_rays fwd"]().shape == (16, 3)
    loss = ps["rgb+eik loss fwd"]()
    grads = ps["rgb+eik loss grad"]()
    assert torch.isfinite(loss) and any(float(g.abs().max()) > 0 for g in grads)
    want, _ = TT.loss_fn(state.field, state.bg, key, data, None, occ, rcfg, tcfg)
    got = ps["full train_step"]()
    torch.testing.assert_close(got, want.detach(), rtol=1e-6, atol=0)
    assert state.step == 1


def test_probe_hash_breakdown_pieces_match_jax():
    """The spatial gradient and the second-order gradient against the JAX
    probe's (vmap of grad, grad of the Eikonal) with the same parameters."""
    import jax
    import jax.numpy as jnp

    from dynhor_tpu.neus import fields as JF
    from dynhor_tpu_torch.tools import probe_hash_breakdown as PB

    ps = PB.pieces("cpu", points=48, table_log2=8, small=(6,), levels=4)
    field, x = ps.pop("_inputs")
    cfg_j = JF.SDFConfig(encoder="hash", hash_table_size=2**8, hash_levels=4)
    pj = JF.init_hash_params(jax.random.PRNGKey(0), cfg_j)
    sd = {"table": torch.as_tensor(np.array(pj["table"]))}
    for i, lyr in enumerate(pj["mlp"]):
        sd[f"mlp.{i}.weight"] = torch.as_tensor(np.asarray(lyr["w"]).T.copy())
        sd[f"mlp.{i}.bias"] = torch.as_tensor(np.asarray(lyr["b"]))
    field.sdf.load_state_dict(sd)
    xj = jnp.asarray(x.numpy())

    @jax.jit
    def spatial(p, q):
        return jax.vmap(jax.grad(lambda y: JF.sdf_hash_forward(p, y[None], cfg_j)[0][0]))(q)

    @jax.jit
    def eik(p, q):
        return ((jnp.linalg.norm(spatial(p, q), axis=-1) - 1.0) ** 2).mean()

    np.testing.assert_allclose(ps["4 spatial grad (one reverse pass)"]().numpy(),
                               np.asarray(spatial(pj, xj)), rtol=1e-5, atol=1e-6)
    g_t = dict(zip([n for n, _ in field.sdf.named_parameters()],
                   ps["5 grad(eikonal(grad-x)) [2nd order]"]()))
    g_j = jax.jit(jax.grad(eik))(pj, xj)
    pairs = [(g_t["table"].numpy(), np.asarray(g_j["table"]))] + [
        (g_t[f"mlp.{i}.weight"].numpy(), np.asarray(lyr["w"]).T) for i, lyr in enumerate(g_j["mlp"])]
    for got, want in pairs:
        # The table's gradient is a scatter-add, summed in another order
        # than XLA's where hashed corners collide: 1e-4 of its largest.
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    for name, fn in ps.items():
        assert PB._finite(fn()), name


# ---------------------------------------------------------------------------
# warm_cache and weak_scaling
# ---------------------------------------------------------------------------

def test_warm_cache_builds_into_its_directory_then_drives_the_pipeline(recorded, monkeypatch,
                                                                       tmp_path, capsys):
    from dynhor_tpu_torch import kernels
    from dynhor_tpu_torch.tools import warm_cache as TW

    config, recs = recorded
    built = []
    monkeypatch.setattr(kernels, "build", lambda build_dir=None: built.append(build_dir) or "")
    out, text = run_port(capsys, TW.main, ["--config", config, "--build-dir", str(tmp_path / "b")])
    assert built == [str(tmp_path / "b")]
    (cfg, _), = recs["torch"].calls
    assert (cfg["system"]["init_num_iterations"], cfg["system"]["joint_num_iterations"]) == (25, 50)
    assert "pipeline_s" in out and f"loaded from {tmp_path / 'b'}" in text


def test_weak_scaling_ranks_match_one_process(monkeypatch):
    """Two gloo ranks of one frame each take the same steps as one process
    refining both frames (a tiny ViT at a 32² crop)."""
    from dynhor_tpu_torch.tools import weak_scaling as TWS
    from dynhor_tpu_torch.tracker import refine as TR

    # Two torch threads for the whole group (``run`` gives each rank
    # cpu_count / ranks): beside the suite's workers, more threads stall
    # loops of small ops.
    monkeypatch.setattr(TWS.os, "cpu_count", lambda: 2)

    (row,) = TWS.run(devices=[2], edge=28, iters=1, device="cpu", crop=32, dino="tiny",
                     timeout=240, out=lambda s: None)
    assert row["devices"] == 2 and row["ms"] > 0 and row["efficiency"] == 1.0
    mesh, targets, rot, trans, dparams, dcfg, cfg = TWS.setup(2, 28, "cpu", 32, "tiny")
    whole = TR.refine_poses(mesh, targets, rot, trans, dparams, dcfg,
                            dataclasses.replace(cfg, num_iterations=1), device="cpu")
    np.testing.assert_allclose(row["losses"], whole.final_loss.numpy(), rtol=1e-5)
