"""Random draws of the reconstruction stage, labelled as a JAX key tree.

The JAX package draws from ``jax.random`` keys that it splits and folds: the
field's init from ``PRNGKey(seed)``, each train step from ``fold_in(key,
step)`` split five ways, each importance round from ``fold_in(k_imp, i)``.
Torch cannot reproduce those values.  So every draw of the port goes
through ``draw``, with a ``Key`` that records the same tree as a path:
``Key.split`` and ``Key.fold_in`` mirror ``jax.random.split`` and
``jax.random.fold_in``.  A test that replaces ``draw`` can rebuild the JAX
key from ``key.path`` and hand the port the JAX package's own values.

Each node of the tree draws from a ``torch.Generator`` of its own, seeded
from the root seed and the node's path, so a draw depends on its path and
not on the order of calls, as a JAX draw depends on its key: a resumed run
draws what an uninterrupted one would.
"""
from __future__ import annotations

import hashlib

import torch

Tensor = torch.Tensor


class Key:
    """A node of the key tree: the root seed, the device the draws land on
    and the path of ``("split", n, j)`` / ``("fold_in", i)`` steps from the
    root.  ``rows`` = (lo, hi, n) marks a key of rows lo:hi of an n-ray
    batch (a rank's shard of the rays): a per-ray draw at it
    (``draw_rows``) is the whole batch's draw, sliced, and its children
    keep the mark."""

    def __init__(self, seed: int, device: str | torch.device = "cpu", path: tuple = (),
                 rows: tuple[int, int, int] | None = None):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.path = tuple(path)
        self.rows = rows
        self._gen: torch.Generator | None = None

    def split(self, n: int = 2) -> list[Key]:
        return [Key(self.seed, self.device, self.path + (("split", n, j),), self.rows)
                for j in range(n)]

    def fold_in(self, i: int) -> Key:
        return Key(self.seed, self.device, self.path + (("fold_in", int(i)),), self.rows)

    def for_rows(self, lo: int, hi: int, n: int) -> Key:
        return Key(self.seed, self.device, self.path, (int(lo), int(hi), int(n)))

    def generator(self) -> torch.Generator:
        if self._gen is None:
            digest = hashlib.sha256(repr((self.seed, self.path)).encode()).digest()
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
        return self._gen


def draw(key: Key, kind: str, shape: tuple, low: float = 0.0, high: float = 1.0) -> Tensor:
    """One draw at ``key``: ``"uniform"`` f32 in [low, high), ``"normal"``
    f32, or ``"randint"`` int64 in [low, high), on ``key.device``.  Every
    random value of the stage comes from here (tests replace it)."""
    gen, dev = key.generator(), key.device
    if kind == "uniform":
        return low + (high - low) * torch.rand(shape, generator=gen, device=dev)
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=dev)
    if kind == "randint":
        return torch.randint(int(low), int(high), shape, generator=gen, device=dev)
    raise ValueError(f"unknown draw kind {kind!r}")


def draw_rows(key: Key, kind: str, shape: tuple, low: float = 0.0, high: float = 1.0) -> Tensor:
    """``draw`` of a per-ray shape (rays first).  At a key with ``rows`` =
    (lo, hi, n) it draws the whole batch's (n, ...) values and keeps rows
    lo:hi, so a rank's shard of the rays gets what one process draws for
    them."""
    if key.rows is None:
        return draw(key, kind, shape, low, high)
    lo, hi, n = key.rows
    return draw(key, kind, (n,) + tuple(shape[1:]), low, high)[lo:hi]
