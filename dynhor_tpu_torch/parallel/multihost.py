"""Process group start-up and the multi-process input pipeline.

Port of ``dynhor_tpu/parallel/multihost.py`` to ``torch.distributed``, one
process per card.  Each process joins the group over TCP or a shared file
(``init_distributed``), loads only its own contiguous slice of the frame
files (``process_local_range``), and keeps that slice as its shard of the
global batch (``global_batch``); the sharded steps then reduce across the
processes with the collectives of ``parallel/mesh.py``.

Launch one process per card with torch's own launcher, which sets RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

    python -m torch.distributed.run --nproc-per-node N -m dynhor_tpu_torch.run \\
        --config_path cfg.yaml        # with system.devices: N

or call ``init_distributed("localhost:29500", num_processes=2,
process_id=rank, backend="gloo")`` in each process yourself (or
``init_distributed("file:///shared/dir/rendezvous", ...)``, a file that no
earlier group used, where no port is known to be free).
"""
from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .mesh import Mesh, _axis, world


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str | None = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group at ``coordinator_address``: "host:port" (TCP,
    process 0 listening there) or an init URL such as
    "file:///path/rendezvous" (a shared file that no earlier group used,
    which needs no free port); a second call in a process does nothing.

    ``backend``: "nccl" (the default; needs a card) or "gloo" (the CPU, or
    ranks sharing one card).  When a card is present each process takes
    card ``LOCAL_RANK`` (``process_id`` without it) modulo the card count.
    """
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("backend 'nccl' needs a CUDA device; pass backend='gloo' for the CPU")
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=timeout_s),
    )


def init_from_env(backend: str | None = None) -> bool:
    """``init_distributed`` from the variables torch's launcher sets (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT); False, and nothing done, when
    WORLD_SIZE is absent or 1."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return False
    addr = f"{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ['MASTER_PORT']}"
    init_distributed(addr, n, int(os.environ["RANK"]), backend)
    return True


def process_local_range(n_items: int) -> tuple[int, int]:
    """[lo, hi) of the global item axis that THIS process loads: equal
    contiguous slices in rank order, the last process taking the
    remainder."""
    rank, n_world = world()
    per = n_items // n_world
    lo = rank * per
    hi = n_items if rank == n_world - 1 else lo + per
    return lo, hi


class GlobalBatch(NamedTuple):
    """This process's shard of a global batch: ``local`` (the tree: each
    sharded leaf holds items [lo, hi) of ``n_global``; the other leaves are
    replicated, as given)."""

    local: Any
    n_global: int
    lo: int
    hi: int


def global_batch(local_tree: Any, n_global: int, mesh: Mesh, axis_name: str = "frames") -> GlobalBatch:
    """Assemble process-local leaves into this process's shard of the global
    batch.  A leaf whose leading axis is this process's
    ``process_local_range`` slice is a shard; any other leaf is replicated,
    and every process must pass the same values for it.  The mesh axis has
    one rank a process."""
    lo, hi = process_local_range(n_global)
    index, size, _ = _axis(mesh, axis_name)
    rank, n_world = world()
    if size != n_world or index != rank:
        raise ValueError(f"axis {axis_name!r} must hold every process once, in rank order")
    return GlobalBatch(local_tree, int(n_global), lo, hi)
