"""Tiny cells for the CPU tests: each benchmark cell with its configuration
and traffic cut to a size the CPU runs in seconds (``cuts/``)."""
from __future__ import annotations

import json
import os
import time

import torch

from portbench import harness as H

HERE = os.path.dirname(os.path.abspath(__file__))
CUTS = {
    "track.refine16": ("tiny_shoes", {"frames": 2, "steps_per_call": 2, "refines_drawn": 2,
                                      "checked_steps": 2}),
    "track.prior6000": ("tiny_shoes", {"frames": 2, "views": 120, "scenes": 2}),
    "neus.rays8192": ("tiny_neus", {"frames": 2, "batch_rays": 64}),
}


def config(name: str) -> dict:
    """The tiny configuration ``cuts/<name>.json``."""
    with open(os.path.join(HERE, "cuts", name + ".json")) as f:
        return json.load(f)


def cell(workload: str) -> H.Cell:
    full = H.find_cell(workload)
    name, cut = CUTS[workload]
    return full._replace(config=config(name), traffic={**full.traffic, **cut})


def run(workload: str, seed: int = 2**33 + 17, seconds: float = 0.2, trace: bool = False) -> dict:
    return H.run_cell(cell(workload), seed, seconds, trace, torch.device("cpu"),
                      time.perf_counter(), log=lambda s: None)
