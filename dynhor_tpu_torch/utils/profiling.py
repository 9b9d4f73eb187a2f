"""Phase timing and device traces (PyTorch).

Port of ``dynhor_tpu/utils/profiling.py``: per-phase wall-clock seconds
and an optional ``torch.profiler`` trace of each phase.

Usage:
    prof = Profiler(device=dev)              # or trace_dir=... for traces
    with prof.phase("prior-scoring"):
        scores = ...
    prof.summary()   # prints and returns {phase: seconds}

A phase on a CUDA device ends with ``torch.cuda.synchronize()``, so its
seconds include the device work it queued (the JAX package blocks on its
results inside each phase for the same reason).  Set ``trace_dir`` (or
env DYNHOR_TRACE_DIR) to write a Chrome trace per phase,
``<trace_dir>/<phase>.json``.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class Profiler:
    def __init__(
        self,
        trace_dir: str | None = None,
        enabled: bool = True,
        device: str | torch.device | None = None,
    ):
        self.trace_dir = trace_dir or os.environ.get("DYNHOR_TRACE_DIR")
        self.enabled = enabled
        self.device = torch.device(device) if device is not None else None
        self.times: dict[str, float] = {}
        self._tracing = False

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        trace = None
        if self.trace_dir and not self._tracing:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device is not None and self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            trace = profile(activities=acts)
            self._tracing = True
        self._sync()
        t0 = time.time()
        try:
            with trace if trace is not None else contextlib.nullcontext():
                yield
                self._sync()
        finally:
            self.times[name] = self.times.get(name, 0.0) + (time.time() - t0)
            if trace is not None:
                self._tracing = False
                os.makedirs(self.trace_dir, exist_ok=True)
                trace.export_chrome_trace(os.path.join(self.trace_dir, f"{name}.json"))

    def summary(self, printer=print) -> dict[str, float]:
        if self.enabled and self.times:
            total = sum(self.times.values())
            for k, v in self.times.items():
                printer(f"[profile] {k}: {v:.2f}s ({100 * v / total:.0f}%)")
            printer(f"[profile] total: {total:.2f}s")
        return dict(self.times)
