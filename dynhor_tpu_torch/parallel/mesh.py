"""Device meshes and sharding over ``torch.distributed``: one process per card.

Port of ``dynhor_tpu/parallel/mesh.py``.  The JAX package shards with
``NamedSharding`` under ``jit`` and XLA inserts every psum, gather and halo.
Here the program is SPMD: each rank holds its contiguous slice of a sharded
axis (``shard_leading``) and replicated copies of the rest, and every
exchange is an explicit collective of this module.  The axes are the JAX
package's: ``frames`` (refine, joint), ``views`` (prior scoring), ``rays``
(NeuS) and ``seq`` x ``frames`` (the multi-sequence pool).

Every collective is built from ``all_reduce`` and ``broadcast`` alone: a
gather of the leading axis is an ``all_reduce(SUM)`` of a zero buffer into
which each rank writes its slice (adding zeros is exact), and the one-row
halo is the same.  These are the two collectives gloo supports for CUDA
tensors as well as CPU ones, so one code runs with NCCL on several cards,
with gloo on the CPU, and with gloo on ranks that share one card.  Under
gloo, tensors travel through host memory.

Without an initialized process group every mesh has one rank and every
collective returns its input.
"""
from __future__ import annotations

import itertools
import math
import warnings
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh(NamedTuple):
    """A mesh of ranks: ``axis_names``, ``shape`` ({axis: size}, in order),
    ``ranks`` (the global ranks in row-major order), this process's
    ``coords`` ({axis: index}, None when it is not in the mesh), and
    ``groups``: for each axis and for the tuple of all axes, this process's
    group along it (None = the default group, ``_SELF`` this rank alone)."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    ranks: tuple[int, ...]
    coords: dict[str, int] | None
    groups: dict[Any, Any]

    @property
    def is_member(self) -> bool:
        return self.coords is not None


def _build(axis_names: tuple[str, ...], dims: tuple[int, ...]) -> Mesh:
    rank, n_world = world()
    n = math.prod(dims)
    if n > n_world:
        raise ValueError(f"a mesh of {n} ranks needs as many processes; the world has {n_world}")
    ranks = tuple(range(n))
    grid = np.arange(n).reshape(dims)
    coords = None
    if rank < n:
        coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, dims))))
    groups: dict[Any, Any] = {}
    # dist.new_group is collective over the default group: every process
    # creates every group, in the same order.
    for a, name in enumerate(axis_names):
        others = [range(d) for i, d in enumerate(dims) if i != a]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(a, slice(None))
            members = [int(r) for r in grid[tuple(idx)]]
            g = _new_group(members, n_world)
            if rank in members:
                groups[name] = g
    if len(axis_names) > 1:
        g = _new_group(list(ranks), n_world)
        if rank < n:
            groups[axis_names] = g
    return Mesh(tuple(axis_names), dict(zip(axis_names, dims)), ranks, coords, groups)


# The group of an axis that holds this rank alone: collectives along it are
# the identity.
_SELF = "self"


def _new_group(members: list[int], n_world: int):
    if len(members) == n_world:
        return None  # the default group
    if len(members) == 1:
        return _SELF
    return dist.new_group(members)


def _live(group) -> bool:
    """Whether collectives along ``group`` communicate (a group of one
    process that was initialized still does, so a one-rank NCCL group runs
    every collective)."""
    return group is not _SELF and dist.is_initialized()


def make_mesh(num_devices: int | None = None, axis_name: str = "frames") -> Mesh:
    """1-D mesh over ranks 0 .. num_devices - 1 (None = every rank).  Every
    process calls it; a rank past ``num_devices`` gets a mesh it is not in."""
    n = world()[1] if num_devices is None else int(num_devices)
    return _build((axis_name,), (n,))


def make_seq_frame_mesh(num_sequences: int, axis_names=("seq", "frames")) -> Mesh:
    """2-D mesh over every rank: sequences x frames within a sequence."""
    n = world()[1]
    if n % num_sequences:
        raise ValueError("devices must divide evenly")
    return _build(tuple(axis_names), (num_sequences, n // num_sequences))


def _axis(mesh: Mesh, axis_name) -> tuple[int, int, Any]:
    """(this rank's index along ``axis_name``, its size, its group).  A
    tuple names several axes flattened in row-major order."""
    if not mesh.is_member:
        raise ValueError("this rank is not in the mesh")
    names = axis_name if isinstance(axis_name, tuple) else (axis_name,)
    if names == mesh.axis_names or (len(names) == 1 and names[0] in mesh.axis_names):
        key = names if len(names) > 1 else names[0]
    else:
        raise ValueError(f"axis {axis_name!r} is not an axis of the mesh {mesh.axis_names}")
    size = math.prod(mesh.shape[a] for a in names)
    index = 0
    for a in names:
        index = index * mesh.shape[a] + mesh.coords[a]
    return index, size, mesh.groups.get(key)


def axis_index(mesh: Mesh | None, axis_name="frames") -> int:
    return 0 if mesh is None else _axis(mesh, axis_name)[0]


def axis_size(mesh: Mesh | None, axis_name="frames") -> int:
    return 1 if mesh is None else _axis(mesh, axis_name)[1]


def _comm_device(x: Tensor) -> torch.device:
    """NCCL reduces on the card; gloo through host memory."""
    if dist.get_backend() == "nccl":
        return x.device
    return torch.device("cpu")


def _reduce_(buf: Tensor, group, op) -> Tensor:
    """In-place all_reduce of ``buf`` (a fresh tensor) over ``group``."""
    wire = buf.to(_comm_device(buf))
    is_bool = wire.dtype == torch.bool
    if is_bool:
        wire = wire.to(torch.uint8)
    dist.all_reduce(wire, op=op, group=group)
    if is_bool:
        wire = wire.bool()
    return wire.to(buf.device)


def all_reduce(x: Tensor, mesh: Mesh | None, axis_name="frames", op: str = "sum") -> Tensor:
    """The sum (or "max", "min") of ``x`` over the ranks along
    ``axis_name``, on every one of them; a new tensor, ``x`` is not
    written."""
    if mesh is None:
        return x
    group = _axis(mesh, axis_name)[2]
    if not _live(group):
        return x
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    return _reduce_(x.detach().clone(), group, ops[op])


def _leaves_map(fn, tree):
    """Map ``fn`` over the tensor and array leaves of a tree of tuples,
    lists, named tuples and dicts; other leaves pass through."""
    if isinstance(tree, (Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_leaves_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_leaves_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _leaves_map(fn, v) for k, v in tree.items()}
    return tree


def shard_leading(tree: Any, mesh: Mesh, axis_name: str | tuple[str, ...] = "frames") -> Any:
    """This rank's contiguous slice of every leaf's LEADING axis.

    ``axis_name`` may be a tuple of mesh axes (``("seq", "frames")``): the
    flat pooled axis over the 2-D mesh, in row-major rank order.

    Scalars and axes not divisible by the mesh are replicated (returned
    whole), with a warning for non-trivial axes, so a "sharded" run that
    fell back to replication is visible.  ``pad_to_multiple`` the axis
    first to shard it."""
    index, n, _ = _axis(mesh, axis_name)

    def put(x):
        if x.ndim >= 1 and x.shape[0] % n == 0 and x.shape[0] > 0:
            per = x.shape[0] // n
            return x[index * per:(index + 1) * per]
        if x.ndim >= 1 and x.shape[0] > 1 and n > 1:
            warnings.warn(
                f"shard_leading: leading axis {x.shape[0]} not divisible"
                f" by mesh axis '{axis_name}'={n}; REPLICATING this array"
                " (pad_to_multiple the axis to shard it)",
                stacklevel=3,
            )
        return x

    return _leaves_map(put, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every tensor leaf as rank ``mesh.ranks[0]`` holds it, on every rank
    of the mesh (a broadcast); new tensors."""
    group = _axis(mesh, mesh.axis_names)[2]

    def put(x):
        if not _live(group):
            return x
        wire = x.detach().clone().to(_comm_device(x))
        is_bool = wire.dtype == torch.bool
        if is_bool:
            wire = wire.to(torch.uint8)
        dist.broadcast(wire, src=mesh.ranks[0], group=group)
        if is_bool:
            wire = wire.bool()
        return wire.to(x.device)

    return _leaves_map(put, tree)


def pad_to_multiple(x: Tensor, multiple: int, axis: int = 0):
    """Pad ``axis`` up to a multiple by repeating its last entry; returns
    (padded, original size)."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x, size
    idx = torch.cat([torch.arange(size), torch.full((pad,), size - 1)])
    return torch.index_select(x, axis, idx.to(x.device)), size


def gather_leading(tree: Any, mesh: Mesh | None, axis_name="frames") -> Any:
    """The whole leading axis of every sharded tensor leaf, on every rank:
    the ranks' slices in rank order (they may differ in length).  Each leaf
    must be a shard; a replicated leaf would be repeated."""
    if mesh is None:
        return tree
    index, size, group = _axis(mesh, axis_name)
    if not _live(group):
        return tree

    def put(t):
        lengths = torch.zeros(size, dtype=torch.int64, device=t.device)
        lengths[index] = t.shape[0]
        lengths = _reduce_(lengths, group, dist.ReduceOp.SUM).tolist()
        lo = sum(lengths[:index])
        buf = torch.zeros((sum(lengths),) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        buf[lo:lo + t.shape[0]] = t.detach()
        return _reduce_(buf, group, dist.ReduceOp.SUM)

    return _leaves_map(put, tree)


def halo_prev(x: Tensor, mesh: Mesh | None, axis_name="frames") -> Tensor:
    """The previous rank's last row of ``x`` (x.shape[1:]), zeros on the
    first rank.  Differentiable: the backward returns the row's gradient to
    the rank that owns it, added to the gradient of its ``x[-1]``.  Every
    rank along the axis calls it, in the forward and in the backward."""
    if mesh is None or not _live(_axis(mesh, axis_name)[2]):
        return torch.zeros_like(x[-1])
    index, size, group = _axis(mesh, axis_name)
    return _HaloPrevFn.apply(x, index, size, group)


class _HaloPrevFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, size, group):
        ctx.index, ctx.size, ctx.group, ctx.n_rows = index, size, group, x.shape[0]
        buf = x.new_zeros((size,) + tuple(x.shape[1:]))
        buf[index] = x[-1].detach()
        buf = _reduce_(buf, group, dist.ReduceOp.SUM)
        return buf[index - 1].clone() if index > 0 else torch.zeros_like(x[-1])

    @staticmethod
    def backward(ctx, g):
        # Each rank sends the gradient of the row it received to the rank
        # that owns that row, whose x[-1] it is.
        buf = g.new_zeros((ctx.size,) + tuple(g.shape))
        if ctx.index > 0:
            buf[ctx.index] = g
        buf = _reduce_(buf, ctx.group, dist.ReduceOp.SUM)
        gx = g.new_zeros((ctx.n_rows,) + tuple(g.shape))
        if ctx.index + 1 < ctx.size:
            gx[-1] = buf[ctx.index + 1]
        return gx, None, None, None
