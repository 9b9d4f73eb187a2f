"""The checks fail runs whose timed path is broken underneath: for each
cell, a step that returns its state unchanged, half of the batch left
out (the mean over the rest), and an answer altered where it is made; and
the control, the reference in the precision below the configuration's in
the program's place.  (No cell runs across chips, so none can leave out an
exchange between them.)  The harness runs on the CPU at the tiny sizes."""
import pytest
import torch

from portbench import harness as H
from portbench.faults import FAULTS
from portbench.tests import tiny


@pytest.mark.parametrize("fault", list(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    workload, plant = FAULTS[fault]
    plant(monkeypatch)
    assert tiny.run(workload)["correct"] is False


@pytest.mark.parametrize("workload", list(tiny.CUTS))
def test_control_is_not_correct(workload):
    cell = tiny.cell(workload)
    checks = H.load_driver(cell.traffic).control(cell.config, cell.traffic, 2**34 + 5,
                                                 torch.device("cpu"))
    assert any(v > lim for _, v, lim in checks), checks
