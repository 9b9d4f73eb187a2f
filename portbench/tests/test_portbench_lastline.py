"""The result line's keys, and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness as H
from portbench.tests import tiny


def test_result_keys_and_order():
    result = tiny.run("neus.rays8192")
    keys = list(result)
    assert keys[:4] == ["correct", "attempted", "failed", "metrics"]
    assert keys[-1] == "checks"
    assert set(result["metrics"]) == {"neus_rays_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert isinstance(m["value"], float) and m["value"] > 0 and m["unit"]
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


def test_traced_result_reports_per_layer_metrics():
    result = tiny.run("neus.rays8192", trace=True)
    assert "breakdown" in result and list(result)[-1] == "checks"
    assert set(result["metrics"]) <= {m["name"] for m in tiny.cell("neus.rays8192").per_layer}
    assert "mfu.neus" in result["metrics"]


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "neus.rays8192",
                          "--seed", str(2**40), "--seconds", "1", "--trace", "0"],
                         cwd=H.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(tiny.CUTS))
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                          str(2**36 + 1), "--seconds", "2", "--trace", "0"], cwd=H.ROOT,
                         capture_output=True, text=True, timeout=360,
                         env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
