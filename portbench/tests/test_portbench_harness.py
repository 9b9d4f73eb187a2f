"""BENCHMARK.json against the benchmark's contract, and the harness
finding each cell's configuration, traffic and metrics by name."""
import json
import os
import re

import pytest

from portbench import harness as H

BENCH = json.load(open(os.path.join(H.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(H.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_budget_fits_full_benchmark():
    # 2 + 14 runs a cell at 24 cells, run_seconds + 60 a run, 2 x 90 a cell,
    # 1200 spare, within 43200 seconds.
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    lines = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:
        lines.append(entry["source"])
    for text in lines:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in WORKLOADS and w in e2e[m["moves"]].get("workloads", WORKLOADS)
        assert os.path.exists(os.path.join(H.HERE, "metrics", m["name"] + ".py"))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_find_cell(workload):
    cell = H.find_cell(workload)
    assert cell.chips == 1
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert H.load_driver(cell.traffic).Driver
    for m in cell.per_layer:
        assert callable(H.load_reader(m["name"]).read)


def test_configs_files_and_widths():
    widths = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = json.load(open(os.path.join(H.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not widths.search(key)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_traffic_mixes_are_data():
    for w in BENCH["workloads"]:
        path = os.path.join(H.HERE, "traffic", w["traffic"] + ".json")
        traffic = json.load(open(path))
        assert os.path.exists(os.path.join(H.HERE, "drivers", traffic["driver"] + ".py"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
