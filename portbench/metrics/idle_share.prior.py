"""Idle share of the device at the window's pace, its busy time from the
traced prior sequence."""
from portbench.metrics.common import idle_share


def read(run):
    return idle_share(run)
