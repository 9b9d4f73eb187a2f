"""The benchmark's one run: find the cell, set it up, measure a window of
its traffic, trace a stretch when asked, check what the window produced
against the plain reference, and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by name:

  configs/<config>.json   the configuration (sizes, settings, its source)
  traffic/<traffic>.json  the traffic mix's parameters; its ``driver``
                          names the module of ``drivers/`` that drives it
  metrics/<metric>.py     the reader of one per-layer metric: ``read(run)``

A driver module has ``Driver(config, traffic, seed, device)`` whose
set-up builds the program's state, warms every shape of the cell and runs
the first steps that the check follows; ``unit()`` runs one unit of
traffic and returns the work it did (in the cell's end-to-end unit);
``trace_units()`` says how many units the traced stretch takes;
``layer_stats(trace)`` gives the readers what the driver counts; and
``check()`` frees the program's state and returns the compared numbers as
``[(name, value, limit)]``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from typing import NamedTuple

import torch

from . import trace as TR

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_NAMES = ("jax", "jaxlib", "flax", "dynhor_tpu")


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic and metrics."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reported(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reported(m, workload) and m["moves"] in e2e_names]
    return Cell(workload, config, traffic, int(w["chips"]), e2e, layer)


def load_driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def load_reader(metric: str):
    """The reader module ``metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run(NamedTuple):
    """What a reader reads: the window's totals, the traced stretch and
    what the driver counts."""

    cell: Cell
    units: int  # units of traffic in the window
    work: float  # their work, in the end-to-end metric's unit
    window_s: float
    trace: TR.TraceStats | None
    stats: dict


def jax_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


def device_info(chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    driver_mod = load_driver(cell.traffic)
    t_start = time.perf_counter()
    torch.zeros(1, device=device)  # the device's context
    t_ctx = time.perf_counter()
    drv = driver_mod.Driver(cell.config, cell.traffic, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.3f} s: {t_start - t0:.3f} s to the harness, {t_ctx - t_start:.3f} s the "
        f"device's context, {t0 + setup_s - t_ctx:.3f} s the driver")
    # The window: units back to back until --seconds have passed; it ends at
    # the first unit boundary after that, closed by a synchronize.
    units, work = 0, 0.0
    start = time.perf_counter()
    while True:
        work += drv.unit()
        units += 1
        if time.perf_counter() - start >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stats = {"peak_bytes": peak}
    tstats = None
    if trace:
        n = drv.trace_units()
        tstats = TR.profile(lambda: [drv.unit() for _ in range(n)], n)
        stats.update(drv.layer_stats(tstats))
    run = Run(cell, units, work, window_s, tstats, stats)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        rate = {m["name"]: m for m in cell.end_to_end if m["name"] != "setup_s"}
        for name, m in rate.items():
            metrics[name] = {"value": work / window_s, "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    failed = drv.failed
    t_check = time.perf_counter()
    checks = drv.check()
    log(f"check {time.perf_counter() - t_check:.3f} s; window {window_s:.3f} s, {units} units")
    found = jax_modules()
    if found:
        raise SystemExit(f"JAX or the JAX package was loaded in this process: {', '.join(found)}")
    correct = failed == 0 and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    for name, v, lim in checks:
        log(f"check {name}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}")
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics}
    if device.type == "cuda":
        result["device"] = {**device_info(cell.chips), "memory_peak_bytes": int(peak)}
        if trace:
            result["device"]["busy_s"] = tstats.busy_s
            result["device"]["window_s"] = tstats.window_s
    if trace:
        result["breakdown"] = TR.breakdown(tstats)
    result["checks"] = {name: {"value": float(v), "limit": float(lim)} for name, v, lim in checks}
    return result
