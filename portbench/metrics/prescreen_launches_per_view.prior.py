"""Kernel launches under the program's ``prior.prescreen`` span (its
chunks' spans included) over the views it prescreened
(``prior.views_prescreened``), in the span stretch under the profiler."""
from portbench import spans


def read(run):
    sp = spans.stats(run)
    if sp is None or not sp.launches.get("prior.prescreen"):
        return None
    views = sp.counters2.get("prior.views_prescreened")
    return sp.launches["prior.prescreen"] / views if views else None
