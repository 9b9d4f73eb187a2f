"""The spans and counters that the program records itself
(``dynhor_tpu_torch.utils.profiling``), read in a ``--trace 1`` run.

After the harness's own traced stretches and the driver's ``layer_stats``,
and before the check, two more stretches of ``trace_units()`` units run
on the run's driver with the recorder on:

1. no profiler: host seconds and self seconds per span name, the spans
   opened, the counters' deltas (each unit's too) and the deltas of the
   ``.launches`` counts of ``kernels.py``'s wrappers;
2. under a host and device ``torch.profiler``: the device time and the
   kernel launches under each span, each device idle gap (the gaps
   ``trace.py`` finds) put down to the innermost span open on the host at
   its midpoint (or ``outside``), and the share of device time and of
   launches that fell under any span.

A device operation belongs to the innermost span open on its launching
thread when it was launched (the time of its runtime call), or else to
the innermost span open on any thread then: the backward runs on
autograd's thread, inside the span that called it on the main thread.
Its time counts for that span and for each span above it, by the
recorder's parent links (``refine.vit_bwd`` lies on autograd's thread
below ``refine.backward``).  The profiler's annotation of each span is
matched to the recorder's span by name and order: both are on the Unix
clock.

The per-layer readers call ``stats(run)``; the first runs the stretches
and keeps the result in ``run.stats["spans"]`` for the others.  The
harness hands a reader the run alone, so the driver is taken from the
frame of ``harness.run_cell`` that called it.  A program without the
recorder gives None, and the readers then report nothing.  A ``--trace
0`` run calls no reader and so never imports this module.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import NamedTuple

import torch

from . import trace as TR


class SpanStats(NamedTuple):
    units: int  # units of traffic in each stretch
    host_s: dict  # span name -> host seconds (stretch 1)
    self_s: dict  # span name -> host seconds less its child spans' (stretch 1)
    spans: dict  # span name -> spans opened (stretch 1)
    counters: dict  # counter -> its delta over stretch 1
    unit_counters: list  # [{counter: delta}] a unit of stretch 1
    wrapper_launches: dict  # kernels.py wrapper -> launches in stretch 1
    device_s: dict  # span name -> device seconds under it, its child spans' included (stretch 2)
    device_self_s: dict  # span name -> device seconds whose innermost span it is
    launches: dict  # span name -> kernel launches under it, its child spans' included
    idle_s: dict  # span name or "outside" -> device idle seconds put down to it
    spans2: dict  # span name -> spans opened (stretch 2)
    counters2: dict  # counter -> its delta over stretch 2
    busy_share: float | None  # share of the device time under any span (stretch 2)
    launch_share: float | None  # share of the launches under any span
    stretch_s: tuple  # (stretch 1, stretch 2) seconds, each ending in a synchronize


def stats(run) -> SpanStats | None:
    """The run's span statistics, collected on first use (None where the
    run was not traced, the driver is not found, or the program has no
    recorder)."""
    if "spans" not in run.stats:
        run.stats["spans"] = None
        drv = _harness_driver()
        if run.trace is not None and drv is not None:
            run.stats["spans"] = collect(drv, run.trace.units)
            if run.stats["spans"] is not None:
                for line in lines(run.stats["spans"]):
                    print(line, file=sys.stderr, flush=True)
    return run.stats["spans"]


def _harness_driver():
    """The driver of the ``harness.run_cell`` call on this thread's stack."""
    from . import harness as H

    f = sys._getframe(1)
    while f is not None:
        if f.f_code is H.run_cell.__code__:
            return f.f_locals.get("drv")
        f = f.f_back
    return None


def _wrappers() -> dict:
    from dynhor_tpu_torch import kernels as KN

    return {n: f for n, f in vars(KN).items()
            if callable(f) and isinstance(getattr(f, "launches", None), int)}


def collect(drv, units: int) -> SpanStats | None:
    """Run the two stretches of ``units`` units on ``drv``."""
    from dynhor_tpu_torch.utils import profiling as PF

    if not hasattr(PF, "recording"):
        return None
    cuda = drv.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(drv.device)

    wrappers = _wrappers()
    before = {n: f.launches for n, f in wrappers.items()}
    per_unit = []
    sync()
    t0 = time.perf_counter()
    with PF.recording() as rec:
        for _ in range(units):
            c0 = dict(rec.counters)
            drv.unit()
            per_unit.append({k: v - c0.get(k, 0) for k, v in rec.counters.items()})
        sync()
    s1 = time.perf_counter() - t0
    fired = {n: f.launches - before[n] for n, f in wrappers.items() if f.launches != before[n]}
    totals = rec.totals()

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with PF.recording() as rec2:
            for _ in range(units):
                drv.unit()
            sync()
        s2 = time.perf_counter() - t0
    dev = attribute(list(prof.profiler.kineto_results.events()), rec2.spans)
    return SpanStats(
        units, {k: v[1] for k, v in totals.items()}, {k: v[2] for k, v in totals.items()},
        {k: v[0] for k, v in totals.items()}, dict(rec.counters), per_unit, fired,
        dev["device_s"], dev["device_self_s"], dev["launches"], dev["idle_s"],
        {k: v[0] for k, v in rec2.totals().items()}, dict(rec2.counters),
        dev["busy_share"], dev["launch_share"], (s1, s2))


class _Ann(NamedTuple):
    start: int
    end: int
    thread: int
    name: str
    span: object  # the recorder's Span, or None


class _Timeline:
    """The innermost annotation open at a time, on one thread: annotations
    on a thread nest, so a sweep over their starts and ends gives the
    segments between boundaries with the innermost one of each."""

    def __init__(self, anns):
        self.times, self.inner = [], []
        stack = []

        def close_until(t):
            while stack and stack[-1].end <= t:
                top = stack.pop()
                self.times.append(top.end)
                self.inner.append(stack[-1] if stack else None)

        for a in sorted(anns, key=lambda a: (a.start, -a.end)):
            close_until(a.start)
            stack.append(a)
            self.times.append(a.start)
            self.inner.append(a)
        close_until(float("inf"))

    def at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        return self.inner[i] if i >= 0 else None


def _match(anns, spans):
    """Each annotation with the recorder's span of its name and order (none
    where the profiler kept another number of them than the recorder)."""
    by_name = defaultdict(list)
    for s in spans:
        if s.end_ns is not None:
            by_name[s.name].append(s)
    groups = defaultdict(list)
    for a in anns:
        groups[a.name].append(a)
    out = []
    for name, group in groups.items():
        group.sort(key=lambda a: a.start)
        rec = sorted(by_name[name], key=lambda s: s.start_ns)
        out += [a._replace(span=s) for a, s in zip(group, rec)] if len(rec) == len(group) else group
    return out


def _chain(a: _Ann) -> list[str]:
    """The names of the span and of those above it, each once."""
    if a.span is None:
        return [a.name]
    names, s = [], a.span
    while s is not None:
        if s.name not in names:
            names.append(s.name)
        s = s.parent
    return names


def attribute(events, spans) -> dict:
    """Device time, launches and idle gaps by span from the profiler's raw
    events (``kineto_results.events()``, times in Unix ns) and the
    recorder's spans of the same stretch."""
    names = {s.name for s in spans}
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    anns, dev, launch_ns = [], [], {}
    for e in events:
        if e.device_type() == cpu:
            if e.is_user_annotation() and e.name() in names:
                anns.append(_Ann(e.start_ns(), e.end_ns(), e.start_thread_id(), e.name(), None))
            elif e.linked_correlation_id() > 0:  # a runtime call: a launch, a copy
                launch_ns[e.correlation_id()] = e.start_ns()
        elif e.device_type() == gpu and not e.is_user_annotation():
            dev.append((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id(), e.correlation_id()))
    anns = _match(anns, spans)
    by_thread = defaultdict(list)
    for a in anns:
        by_thread[a.thread].append(a)
    lines = {t: _Timeline(v) for t, v in by_thread.items()}

    def innermost(t, thread=None):
        if thread in lines:
            a = lines[thread].at(t)
            if a is not None:
                return a
        hits = [a for a in (tl.at(t) for tl in lines.values()) if a is not None]
        return max(hits, key=lambda a: a.start, default=None)

    device_s, device_self_s, launches = defaultdict(float), defaultdict(float), defaultdict(int)
    total_s = covered_s = 0.0
    total_n = covered_n = 0
    for start, end, name, thread, corr in dev:
        secs = (end - start) * 1e-9
        kernel = not name.startswith(("Memcpy", "Memset"))
        total_s += secs
        total_n += kernel
        a = innermost(launch_ns.get(corr, start), thread)
        if a is None:
            continue
        covered_s += secs
        covered_n += kernel
        device_self_s[a.name] += secs
        for n in _chain(a):
            device_s[n] += secs
            launches[n] += kernel
    idle_s = defaultdict(float)
    _, gaps = TR._union([(s, e, n) for s, e, n, _, _ in dev])
    for s, e in gaps:
        a = innermost(0.5 * (s + e))
        idle_s["outside" if a is None else a.name] += (e - s) * 1e-9
    return {"device_s": dict(device_s), "device_self_s": dict(device_self_s),
            "launches": dict(launches), "idle_s": dict(idle_s),
            "busy_share": covered_s / total_s if total_s > 0 else None,
            "launch_share": covered_n / total_n if total_n else None}


def lines(sp: SpanStats) -> list[str]:
    """``span`` lines for standard error: a line per span name, by device
    time (ms a stretch), the counters, the wrappers' launches and the
    coverage."""
    out = []
    names = sorted(set(sp.host_s) | set(sp.device_s),
                   key=lambda n: (-sp.device_s.get(n, 0.0), -sp.host_s.get(n, 0.0)))
    for n in names:
        out.append(
            f"span {n}: host {1e3 * sp.host_s.get(n, 0.0):.3f} ms, self {1e3 * sp.self_s.get(n, 0.0):.3f} ms,"
            f" device {1e3 * sp.device_s.get(n, 0.0):.3f} ms (self {1e3 * sp.device_self_s.get(n, 0.0):.3f}),"
            f" launches {sp.launches.get(n, 0)}, idle {1e3 * sp.idle_s.get(n, 0.0):.3f} ms,"
            f" count {sp.spans.get(n, 0)}")
    if "outside" in sp.idle_s:
        out.append(f"span outside: idle {1e3 * sp.idle_s['outside']:.3f} ms")
    for k, v in sorted(sp.counters.items()):
        out.append(f"span counter {k}: {v} (a unit: {[u.get(k, 0) for u in sp.unit_counters]})")
    if sp.wrapper_launches:
        out.append("span wrappers: " + ", ".join(f"{k} {v}" for k, v in sorted(sp.wrapper_launches.items())))

    def pct(x):
        return "none" if x is None else f"{100 * x:.2f} %"

    out.append(f"span coverage: device time {pct(sp.busy_share)}, launches {pct(sp.launch_share)};"
               f" {sp.units} unit(s) a stretch, {sp.stretch_s[0]:.3f} s without and"
               f" {sp.stretch_s[1]:.3f} s under the profiler")
    return out


def per_step(sp: SpanStats | None, span: str, step: str):
    """Device ms under ``span`` a ``step`` span (stretch 2)."""
    if sp is None or not sp.spans2.get(step) or span not in sp.device_s:
        return None
    return 1e3 * sp.device_s[span] / sp.spans2[step]
