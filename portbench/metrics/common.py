"""Arithmetic the per-layer readers share.  Each reader returns None where
its run has nothing to read, and the metric is then left out."""
from __future__ import annotations


def idle_share(run):
    """Per cent of the device's time idle at the untraced pace: 1 - the
    traced stretch's busy time a unit over the window's time a unit.  The
    stretch's own length is not the base: the profiler slows the host (a
    prior sequence's 154,000 launches by half), not the device."""
    t = run.trace
    if t is None or t.busy_s <= 0 or not t.units or not run.units or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.units) / (run.window_s / run.units))


def mfu(run, unit_work: float):
    """Per cent of the peak: the algorithm's FLOPs a unit of work times the
    window's rate (all its work over all its time), over the peak of the
    configuration's compute type."""
    flops = run.stats.get("unit_flops")
    if flops is None or run.window_s <= 0:
        return None
    return 100.0 * (run.work / run.window_s / unit_work) * flops / run.stats["peak_flops"]


def roofline(run, bound_key: str, *kernel_parts: str):
    """Per cent of a kernel's roofline: the least time the card could take
    for the traced work over the time its kernels (the named parts, their
    work-list pre-passes and merges included) took in the trace."""
    from portbench.trace import kernel_seconds

    bound = run.stats.get(bound_key)
    if run.trace is None or bound is None:
        return None
    secs, n = kernel_seconds(run.trace, *kernel_parts)
    if n == 0 or secs <= 0:
        return None
    return 100.0 * bound / secs


def launches_per_step(run):
    steps = run.stats.get("steps")
    if run.trace is None or not steps:
        return None
    return run.trace.launches / steps
