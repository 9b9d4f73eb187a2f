"""Host ms of the program's ``prior.rescore`` span (stage B: the top-K
union at full resolution, through its scores' copy to the host) over the
views it rescored (``prior.views_rescored``), without the profiler."""
from portbench import spans


def read(run):
    sp = spans.stats(run)
    if sp is None or "prior.rescore" not in sp.host_s:
        return None
    views = sp.counters.get("prior.views_rescored")
    return 1e3 * sp.host_s["prior.rescore"] / views if views else None
