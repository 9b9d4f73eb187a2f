"""Views rescored at full resolution a sequence: the program's
``prior.views_rescored`` counter (the union of the frames' top-K) over
the sequences of the span stretch without the profiler."""
from portbench import spans


def read(run):
    sp = spans.stats(run)
    if sp is None or "prior.views_rescored" not in sp.counters or not sp.units:
        return None
    return sp.counters["prior.views_rescored"] / sp.units
