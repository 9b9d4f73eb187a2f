"""Stretches of the run under ``torch.profiler``, reduced to what the
metric readers take.  A first stretch traces the host's operations too,
which slows the host, and serves only to name the longest idle gaps by the
host operation that was running in them.  The second, of as many units,
traces the device alone, so that the host runs nearer its untraced pace:
the device's busy time (the union of its kernel, copy and fill
intervals), the stretch's length, each kernel's time and launches by
name.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import NamedTuple

import torch


class TraceStats(NamedTuple):
    busy_s: float  # union of the device's activity intervals
    window_s: float  # host clock from the stretch's start to its final synchronize
    kernels: dict  # name -> (seconds, launches)
    idle_gaps: dict  # host operation -> seconds of device idle time under it (first stretch)
    launches: int  # kernel launches in the stretch
    units: int  # units of the cell's traffic in each stretch
    host_traced_s: float  # length of the first stretch, the host traced


def _intervals(prof):
    """(device intervals [(start_us, end_us, name)], host ops [(start, end, name)])."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    return dev, host


def _union(iv):
    total, cur_s, cur_e = 0.0, None, None
    gaps = []
    for s, e, _ in sorted(iv):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def _host_op_at(host, starts, t):
    """The innermost host operation running at time ``t`` (the one that
    started last among those that span it); ``host`` sorted by start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 500, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host"


def _trace(fn, host: bool):
    """(profiler, seconds) of ``fn()`` traced, ending in a synchronize."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host or not cuda else []) + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    return prof, window


def profile(fn, units: int) -> TraceStats:
    """Run ``fn()`` (``units`` units of traffic) twice under the profiler:
    with the host's operations, then the device alone, so that the last
    ``units`` units run are those whose device time the stats give."""
    prof, host_window = _trace(fn, host=True)
    dev, host = _intervals(prof)
    _, gaps = _union(dev)
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        idle[_host_op_at(host, starts, 0.5 * (s + e))] += (e - s) * 1e-6

    prof, window = _trace(fn, host=False)
    dev, _ = _intervals(prof)
    busy_us, _ = _union(dev)
    kernels = defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        kernels[name][0] += (e - s) * 1e-6
        kernels[name][1] += 1
    n_kernels = sum(1 for _, _, name in dev if not name.startswith(("Memcpy", "Memset")))
    return TraceStats(busy_us * 1e-6, window, {k: tuple(v) for k, v in kernels.items()},
                      dict(idle), n_kernels, units, host_window)


def breakdown(stats: TraceStats) -> dict:
    """The ten device operations that took most time and the ten host
    operations under which the device idled longest."""
    ops = sorted(((k, v[0]) for k, v in stats.kernels.items()), key=lambda kv: -kv[1])[:10]
    gaps = sorted(stats.idle_gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def kernel_seconds(stats: TraceStats, *parts: str) -> tuple[float, int]:
    """Seconds and launches of the kernels whose names contain any of
    ``parts``."""
    secs = n = 0
    for name, (s, c) in stats.kernels.items():
        if any(p in name for p in parts):
            secs += s
            n += c
    return secs, n
