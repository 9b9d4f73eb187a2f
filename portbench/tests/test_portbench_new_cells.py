"""The cells ``neus_hash.rays8192`` and ``track.prior_single`` on the CPU at
tiny sizes: the operation counts by hand, each cell's check reading near
zero against its reference, each control failing a limit, and the faults
of ``faults.py`` failing the hash-grid cell."""
import time

import pytest
import torch

from portbench import harness as H
from portbench.counts import neus_ngp as CG
from portbench.faults import FAULTS
from portbench.tests import tiny

CUTS = {
    "neus_hash.rays8192": ("tiny_neus_hash", {"frames": 2, "batch_rays": 64}),
    "track.prior_single": ("tiny_shoes", {"frames": 2, "views": 24, "scenes": 2, "check_views": 8}),
}


def cell(workload: str) -> H.Cell:
    full = H.find_cell(workload)
    name, cut = CUTS[workload]
    return full._replace(config=tiny.config(name), traffic={**full.traffic, **cut})


def run(workload: str, seed: int = 2**33 + 17) -> dict:
    return H.run_cell(cell(workload), seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                      log=lambda s: None)


def test_ngp_flops_by_hand():
    field = H.find_cell("neus_hash.rays8192").config["field"]
    sdf = 35 * 64 + 64 * 13  # 3,072 multiply-adds a point
    color = 32 * 64 + 64 * 64 + 64 * 3  # 6,336
    assert CG.sdf_macs(field) == sdf and CG.color_macs(field) == color
    cfg = H.find_cell("neus_hash.rays8192").config
    per_ray = 64 * 6 * sdf + 16 * (12 * sdf + 6 * color)
    extra = 256 * 12 * sdf + (128 + 16) * 6 * sdf
    occ = 64**3 * 2 * sdf / 250
    assert CG.step_flops(cfg, 8192) == pytest.approx(8192 * per_ray + extra + occ, rel=1e-12)
    assert CG.interp_flops(field, 10) == 10 * 16 * 8 * 2 * 2


@pytest.mark.parametrize("workload", list(CUTS))
def test_new_cell_agrees_with_its_reference(workload):
    result = run(workload)
    assert result["correct"] and result["failed"] == 0
    for name, c in result["checks"].items():
        assert c["value"] <= 0.05 * c["limit"], (name, c)


@pytest.mark.parametrize("workload", list(CUTS))
def test_new_cell_control_is_not_correct(workload):
    c = cell(workload)
    checks = H.load_driver(c.traffic).control(c.config, c.traffic, 2**34 + 5, torch.device("cpu"))
    for control in {n.split(".")[0] for n, _, _ in checks if "." in n} or {""}:
        assert any(v > lim for n, v, lim in checks if n.startswith(control)), checks


@pytest.mark.parametrize("fault", [f for f in FAULTS if f.startswith("neus-")])
def test_hash_cell_fails_the_neus_faults(fault, monkeypatch):
    FAULTS[fault][1](monkeypatch)
    assert run("neus_hash.rays8192")["correct"] is False


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_hash_cell_fails_a_table_gradient_of_another_size(scale, monkeypatch):
    """A table gradient scaled by 2 or 1/2 (a wrong weight derivative in
    the double backward, say) moves the table as Adam normalises it, so
    only Adam's first moment shows it."""
    from dynhor_tpu_torch.neus import trainer as NT

    init = NT.init_train_state

    def scaled(*a, **k):
        state = init(*a, **k)
        state.field.sdf.table.register_hook(lambda g: g * scale)
        return state

    monkeypatch.setattr(NT, "init_train_state", scaled)
    result = run("neus_hash.rays8192")
    assert result["correct"] is False
    moment = result["checks"]["moment_gap"]
    assert moment["value"] > 10 * moment["limit"], result["checks"]


def test_program_without_the_encoder_stops_at_set_up(monkeypatch):
    from dynhor_tpu_torch.neus import fields as NF

    monkeypatch.delattr(NF, "NGP_WIDTHS")  # as the parent's program
    with pytest.raises(SystemExit, match="no ngp encoder"):
        run("neus_hash.rays8192")
