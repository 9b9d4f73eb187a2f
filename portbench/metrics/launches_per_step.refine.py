"""Kernel launches a refine step in the trace."""
from portbench.metrics.common import launches_per_step


def read(run):
    return launches_per_step(run)
