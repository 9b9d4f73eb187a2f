"""Host ms a sequence of the program's ``prior.prescreen`` span (stage A
of the two-stage scoring, through its scores' copy to the host), in the
span stretch without the profiler."""
from portbench import spans


def read(run):
    sp = spans.stats(run)
    if sp is None or "prior.prescreen" not in sp.host_s or not sp.units:
        return None
    return 1e3 * sp.host_s["prior.prescreen"] / sp.units
