"""The port's "ngp" NeuS field (instant-nsr-pl's hash-grid field,
``dynhor_tpu_torch/neus/fields.py``) against the plain reference
``portbench/reference/neus_ngp.py``, at a small size that keeps both kinds
of level: 4 levels from base 4 at scale 2 (s = 3, 7, 15, 31; R = 4, 8, 16,
32), T = 2^9, so levels 0 and 1 are dense (level 1 with R^3 = T exactly)
and 2 and 3 hashed; F = 2, MLPs 16 wide.

The JAX package has no such field; the reference is written from the
field's equations.  Held: the corner rows exactly and their weights bit
for bit (points on cell faces, at u = 0 and u = 1 among them); with the
same seeded random weights in both, the encoding, the SDF, the feature and
the colour, the first-order gradients to the table, g, v and the points,
and the Eikonal term's gradient (second order, through the trilinear
weights' derivative) to the table and the MLP; the same init from the same
key; 3 steps of ``make_train_step`` through ``render_rays`` against the
reference's trainer (the benchmark driver's own check, at a tiny size);
the spans and counters; and ``recon.main --device cpu`` with ``encoder:
ngp`` at the published widths for a few steps.
"""
import sys
from pathlib import Path

import pytest
import torch
import yaml

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dynhor_tpu_torch.neus import fields as TF  # noqa: E402
from dynhor_tpu_torch.neus.draws import Key  # noqa: E402
from dynhor_tpu_torch.utils import profiling as PF  # noqa: E402
from portbench.reference import neus as RN  # noqa: E402
from portbench.reference import neus_ngp as RG  # noqa: E402

REF_CFG = {"n_levels": 4, "n_features_per_level": 2, "log2_hashmap_size": 9, "base_resolution": 4,
           "per_level_scale": 2.0, "geo_n_neurons": 16, "geo_n_hidden_layers": 1, "feature_dim": 13,
           "sphere_init_radius": 0.5, "tex_n_neurons": 16, "tex_n_hidden_layers": 2, "radius": 1.0}
CFG = TF.SDFConfig(encoder="ngp", hash_levels=4, hash_features=2, hash_table_size=2**9, hash_base_res=4,
                   hash_max_res=32, hash_hidden=16, hash_depth=1, feat_dim=13, color_hidden=16,
                   color_depth=3)


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """Many small ops: under the suite's parallel workers torch's intra-op
    threads oversubscribe the cores, so torch runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(seed=11, randomize=True):
    """The port's and the reference's fields from one key; with
    ``randomize``, every parameter then set to the same seeded random
    values in both (the sphere init's zero columns would hide the table)."""
    port = TF.NeuSField(CFG, Key(seed))
    ref = RG.Field(REF_CFG, RN.Key(seed, "cpu"))
    if randomize:
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p, r in zip(port.parameters(), ref.parameters()):
                v = torch.randn(p.shape, generator=gen) * (1e-2 if p.numel() > 1000 else 0.3)
                if p is port.variance:
                    v = torch.tensor(0.3)
                p.copy_(v)
                r.copy_(v)
    return port, ref


def _points(n=96, seed=0):
    """Points in [-1, 1]^3 with some of each level's cell faces (p an
    integer), the domain's faces (u = 0 and 1) and the origin."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, 3), generator=gen) * 2 - 1
    faces = []
    for s in (3.0, 7.0, 15.0, 31.0):
        u = (torch.arange(1, 4, dtype=torch.float32) - 0.5) / s  # p = 1, 2, 3
        faces.append(u * 2 - 1)
    faces = torch.cat(faces)
    x[: faces.numel(), 0] = faces
    x[: faces.numel(), 1] = faces.flip(0)
    x[-4:] = torch.tensor([[1.0, 1.0, 1.0], [-1.0, -1.0, -1.0], [1.0, -1.0, 0.0], [0.0, 0.0, 0.0]])
    return x


def test_levels_dense_then_hashed():
    levels = TF.ngp_levels(CFG)
    assert [(lv.res, lv.rows, lv.dense) for lv in levels] == [
        (4, 64, True), (8, 512, True), (16, 512, False), (32, 512, False)]
    assert [lv.offset for lv in levels] == [0, 64, 576, 1088]
    assert [(lv["R"], lv["rows"], lv["first"], lv["dense"]) for lv in RG.levels(REF_CFG)] == [
        (lv.res, lv.rows, lv.offset, lv.dense) for lv in levels]
    # The published widths: levels 0-3 dense (R 32, 43, 56, 74), 53.3 MiB.
    full = TF.ngp_levels(TF.config_for("ngp"))
    assert [lv.res for lv in full[:5]] == [32, 43, 56, 74, 98] and full[-1].res == 2048
    assert [lv.dense for lv in full] == [True] * 4 + [False] * 12
    assert sum(lv.rows for lv in full) == 6_984_576


def test_corner_rows_exactly_the_reference():
    x = _points()
    u = TF.clip((x + 1.0) / 2.0, 0.0, 1.0)
    assert (u == 1.0).any() and (u == 0.0).any()
    rows, weights = TF.ngp_indices(u, TF.ngp_grid(CFG, "cpu"))
    ref = RG.corner_rows(u, REF_CFG)
    for lvl in range(4):
        for ci in range(8):
            r_row, r_w = ref[lvl][ci]
            assert torch.equal(rows[ci][:, lvl], r_row), (lvl, ci)
            assert torch.equal(weights[ci][:, lvl, 0], r_w), (lvl, ci)
    # Rows stay inside their level; at u = 1 the dense levels wrap.
    for lvl, lv in enumerate(TF.ngp_levels(CFG)):
        r = torch.stack([rw[:, lvl] for rw in rows])
        assert (r >= lv.offset).all() and (r < lv.offset + lv.rows).all()


def test_same_init_from_the_same_key():
    port, ref = _fields(randomize=False)
    for (name, p), r in zip(port.named_parameters(), ref.parameters()):
        assert p.shape == r.shape, name
        # g = |v| by norm() against sqrt(sum(v^2)): an ulp apart at most.
        assert torch.allclose(p, r, rtol=2e-7, atol=0), name
    # At the published width of 64 the sphere init is a rough sphere: the
    # origin inside, the sign of |x| - 0.5 at nine points in ten.
    wide = TF.NeuSField(TF.SDFConfig(**{**CFG.__dict__, "hash_hidden": 64}), Key(11))
    x = torch.rand((2000, 3), generator=torch.Generator().manual_seed(5)) * 2 - 1
    agree = ((wide.sdf(x)[0] > 0) == (x.norm(dim=-1) > 0.5)).float().mean()
    assert float(wide.sdf(torch.zeros(1, 3))[0].detach()) < -0.3 and agree >= 0.9


def test_encoding_sdf_feature_and_colour_match():
    port, ref = _fields()
    x = _points()
    d = torch.nn.functional.normalize(torch.randn((x.shape[0], 3), generator=torch.Generator().manual_seed(2)), dim=-1)
    n = torch.nn.functional.normalize(torch.randn((x.shape[0], 3), generator=torch.Generator().manual_seed(3)), dim=-1)
    # Same f32 operations in the same order but for the layers' products
    # (addmm against a matmul and an add) and the weight norm: a few ulps.
    assert (port.sdf.encode(x) - ref.encode(x)).abs().max() < 1e-6
    sdf_p, feat_p = port.sdf(x)
    sdf_r, feat_r = ref.sdf(x)
    assert (sdf_p - sdf_r).abs().max() < 1e-5 and (feat_p - feat_r).abs().max() < 1e-5
    assert torch.equal(sdf_p, feat_p[:, 0])
    assert (TF.sh4(d) - RG.sh4(d)).abs().max() < 1e-6
    rgb_p, rgb_r = port.color(x, d, n, feat_p), ref.rgb(x, d, n, feat_r)
    assert (rgb_p - rgb_r).abs().max() < 1e-5


def _grads(params, loss):
    return torch.autograd.grad(loss, params, allow_unused=True)


def test_first_order_gradients_match():
    port, ref = _fields()
    xp = _points().requires_grad_(True)
    xr = _points().requires_grad_(True)
    w = torch.randn((xp.shape[0], 13), generator=torch.Generator().manual_seed(4))
    sdf_p, feat_p = port.sdf(xp)
    sdf_r, feat_r = ref.sdf(xr)
    gp = _grads([*port.sdf.parameters(), xp], (feat_p * w).sum() + sdf_p.sum())
    gr = _grads([ref.table, ref.g0, ref.v0, ref.b0, ref.g1, ref.v1, ref.b1, xr],
                (feat_r * w).sum() + sdf_r.sum())
    names = ["table", "g0", "v0", "b0", "g1", "v1", "b1", "points"]
    for name, a, b in zip(names, gp, gr):
        # f32 sums of up to 96 points' terms in another order (the table's
        # index_add): 1e-5 of the largest entry.
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
        assert b.abs().max() > 0, name


def test_eikonal_gradient_second_order_matches():
    port, ref = _fields()
    x = _points()
    eik_p = ((TF.sdf_grad(port, x).norm(dim=-1) - 1.0) ** 2).mean()
    eik_r = ((ref.grad(x).norm(dim=-1) - 1.0) ** 2).mean()
    assert abs(float(eik_p.detach()) - float(eik_r.detach())) < 1e-5 * float(eik_r.detach())
    gp = _grads(list(port.sdf.parameters()), eik_p)
    gr = _grads([ref.table, ref.g0, ref.v0, ref.b0, ref.g1, ref.v1, ref.b1], eik_r)
    for name, a, b in zip(["table", "g0", "v0", "b0", "g1", "v1", "b1"], gp, gr):
        if name == "b1":  # the output bias leaves the SDF's gradient alone
            assert a is None and b is None
            continue
        # The second derivative runs through softplus'' (beta 100) and the
        # trilinear weights' derivative: 2e-5 of the largest entry.
        assert (a - b).abs().max() <= 2e-5 * b.abs().max(), name
        assert b.abs().max() > 0, name


def test_three_train_steps_match_the_reference():
    """The benchmark driver's set-up (3 steps of ``make_train_step``) and its
    check against ``reference/neus_ngp.py``, at a tiny size on the CPU."""
    from portbench.drivers import neus_ngp as DG
    from portbench.tests import tiny

    config = tiny.config("tiny_neus_hash")
    traffic = {"driver": "neus_ngp", "frames": 2, "batch_rays": 64, "checked_steps": 3, "trace_calls": 1}
    drv = DG.Driver(config, traffic, 2**33 + 17, torch.device("cpu"))
    assert isinstance(drv.state.field.sdf, TF.NGPSDF)
    checks = drv.check()
    assert drv.failed == 0
    for name, value, limit in checks:
        # Same draws, same f32 arithmetic but for the products' rounding:
        # each gap far below the cell's limit.
        assert value <= 0.05 * limit, (name, value)


def test_spans_and_counters():
    port, _ = _fields()
    x, y = _points(40), _points(24, seed=1)
    with PF.recording() as rec:
        sdf, _ = port.sdf(x)
        g = TF.sdf_grad(port, y)
        (sdf.sum() + ((g.norm(dim=-1) - 1) ** 2).mean()).backward()
    assert rec.counters["neus.encoded_points"] == 40 + 24
    assert rec.counters["neus.hash_lookups"] == (40 + 24) * 4 * 8
    totals = rec.totals()
    assert totals["neus.encode"][0] == 2
    # sdf_grad's first-order pass; then, in the backward, the second call's
    # double backward and both calls' backward: each closed, none overlapping.
    assert totals["neus.encode_bwd"][0] == 4
    bwd = sorted((s.start_ns, s.end_ns) for s in rec.spans if s.name == "neus.encode_bwd")
    assert all(e is not None for _, e in bwd)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(bwd, bwd[1:]))
    with PF.recording():
        pass
    port.sdf(x)  # the recorder off: nothing is counted, no hook is left
    assert not PF.active()


def test_recon_main_trains_the_ngp_field(tmp_path):
    """``python -m dynhor_tpu_torch.recon --device cpu`` with
    ``configs/neus_shoes_ngp.yaml``'s recipe (the published widths) cut to 3
    steps on a tiny twin: the ngp field trains and gives a mesh."""
    import numpy as np

    from dynhor_tpu_torch import recon as TREC
    from dynhor_tpu_torch.tools import make_demo_data as MD

    shoes = str(REPO / "assets" / "shoes" / "1229a2e6e97e_A_basketball_shoes_.obj")
    seq = tmp_path / "custom_shoes"
    MD.write_sequence(str(seq), shoes, frames=2, height=32, width=48, seed=0, device="cpu",
                      verbose=False)
    gt = np.load(seq / "gt_poses.npz")
    poses = tmp_path / "gt_obj_infos"
    poses.mkdir()
    for i in range(gt["R"].shape[0]):
        np.savez(poses / f"{i:04d}.npz", R=gt["R"][i].astype(np.float32),
                 T=gt["T"][i].astype(np.float32), K=gt["K"].astype(np.float32))
    recipe = yaml.safe_load((REPO / "configs" / "neus_shoes_ngp.yaml").read_text())
    assert recipe["system"]["recon"]["encoder"] == "ngp"
    recipe["data_info"] = {"dataroot": str(seq), "obj_path": shoes}
    recipe["system"]["recon"].update({
        "num_steps": 3, "batch_rays": 32, "n_candidates": 32, "n_occ_samples": 8, "occ_res": 16,
        "n_shade": 4, "poses_dir": str(poses), "mesh_resolution": 24, "log_every": 1,
        "checkpoint_every": 3, "gt_mesh": None})
    path = tmp_path / "ngp.yaml"
    path.write_text(yaml.safe_dump(recipe))
    res = TREC.main(["--config_path", str(path), "--exps_root", str(tmp_path / "exps"),
                     "--device", "cpu"])
    field = res.state.field
    assert isinstance(field.sdf, TF.NGPSDF) and isinstance(field.color, TF.SHTexture)
    assert field.sdf.table.shape == (6_984_576, 2)
    assert res.state.step == 3 and len(res.history["loss"]) == 3
    assert np.isfinite(res.history["psnr"]).all() and len(res.verts) > 0
    groups = {g["name"]: g for g in res.state.opt.param_groups}
    assert groups["grid"]["params"] == [field.sdf.table]  # at lr x grid_lr_mult
    assert len(groups["net"]["params"]) == len(list(field.parameters())) - 1
    assert Path(res.mesh_path).exists()
