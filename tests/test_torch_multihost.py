"""The port's multi-process input pipeline (``parallel/multihost.py``) on a
2-process gloo group on the CPU: the counterpart of tests/test_multihost.py.

Each process (``tests/torch_dist_worker.py``, no JAX) loads only its slice
of 8 frame files (``process_local_range``: frames 0-3 and 4-7), keeps it as
its shard (``global_batch``, a replicated scalar beside it), and computes a
per-frame reduction whose sum crosses the process boundary: every rank
holds the global sum and the gathered per-frame values of one process.
The same demo as ``python -m dynhor_tpu_torch.tools.multihost_input_demo``,
two processes started as tests/test_multihost.py starts the JAX tool.  In
one process: the whole range, ``init_from_env`` doing nothing without the
launcher's variables, and NCCL refused without a card.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynhor_tpu_torch.parallel import mesh as PM
from dynhor_tpu_torch.parallel import multihost as MH

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_dist_worker.py")


def launch(world: int, cases: str, inputs: dict, work: Path):
    """Start a ``world``-rank gloo group on ``cases``; returns a function
    that waits for it and returns each rank's results."""
    work.mkdir(parents=True, exist_ok=True)
    path = work / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    # A file rendezvous in this group's own directory: no port to race for.
    rendezvous = f"file://{work.resolve() / 'rendezvous'}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), "--rank", str(r), "--world", str(world), "--rendezvous",
         rendezvous, "--inputs", str(path), "--out", str(work / f"out{r}.pkl"), "--cases", cases],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(world)]

    def wait():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        out = []
        for r in range(world):
            with open(work / f"out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out

    return wait


def test_two_process_input_pipeline(tmp_path):
    rng = np.random.default_rng(0)
    n, h, w = 8, 16, 16
    frames = rng.uniform(size=(n, h, w)).astype(np.float32)
    data = tmp_path / "frames"
    data.mkdir()
    for i in range(n):
        np.save(data / f"frame_{i:04d}.npy", frames[i])
    outs = launch(2, "multihost", {"multihost": {"data": str(data)}}, tmp_path / "g")()
    expected_pf = (frames**2).mean(axis=(1, 2)) * (np.arange(n) + 1.0)
    for rank, res in enumerate(outs):
        assert not res["jax_imported"]
        d = res["multihost"]
        assert "error" not in d, d.get("error")
        assert int(d["world"]) == 2 and int(d["n_global"]) == n
        # Each process loaded a DISJOINT contiguous slice...
        assert (int(d["lo"]), int(d["hi"])) == ((0, 4) if rank == 0 else (4, 8))
        # ...yet holds the GLOBAL reduction.
        np.testing.assert_allclose(float(d["total"]), expected_pf.sum(), rtol=1e-5)
        np.testing.assert_allclose(d["per_frame"], expected_pf, rtol=1e-5)


def test_two_process_input_demo_tool(tmp_path):
    """``python -m dynhor_tpu_torch.tools.multihost_input_demo`` started
    twice, as tests/test_multihost.py starts the JAX tool: each process
    writes its slice's range and the global reduction."""
    rng = np.random.default_rng(0)
    n = 8
    frames = rng.uniform(size=(n, 16, 16)).astype(np.float32)
    data = tmp_path / "frames"
    data.mkdir()
    for i in range(n):
        np.save(data / f"frame_{i:04d}.npy", frames[i])
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    rdv = f"file://{tmp_path.resolve() / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dynhor_tpu_torch.tools.multihost_input_demo", "--coordinator",
         rdv, "--rank", str(r), "--world", "2", "--data", str(data),
         "--out", str(tmp_path / f"out{r}.npz")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    ) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    expected_pf = (frames**2).mean(axis=(1, 2)) * (np.arange(n) + 1.0)
    for rank in range(2):
        d = np.load(tmp_path / f"out{rank}.npz")
        assert int(d["rank"]) == rank and int(d["process_count"]) == 2
        assert (int(d["lo"]), int(d["hi"])) == ((0, 4) if rank == 0 else (4, 8))
        np.testing.assert_allclose(float(d["total"]), expected_pf.sum(), rtol=1e-5)
        np.testing.assert_allclose(d["per_frame"], expected_pf, rtol=1e-5)
        assert f"rank {rank}: total=" in logs[rank]


def test_one_process_defaults(monkeypatch):
    assert PM.world() == (0, 1)
    assert MH.process_local_range(7) == (0, 7)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert MH.init_from_env("gloo") is False
    mesh = PM.make_mesh(axis_name="frames")
    assert mesh.shape == {"frames": 1} and mesh.is_member
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(PM.shard_leading(x, mesh), x)
    assert torch.equal(PM.gather_leading(x, mesh), x)
    assert torch.equal(PM.halo_prev(x, mesh), torch.zeros(2))
    batch = MH.global_batch({"f": x}, 3, mesh)
    assert (batch.lo, batch.hi, batch.n_global) == (0, 3, 3)
    with pytest.raises(ValueError, match="devices must divide evenly"):
        PM.make_seq_frame_mesh(2)


def test_nccl_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        MH.init_distributed("localhost:1", 1, 0)
    assert not torch.distributed.is_initialized()
