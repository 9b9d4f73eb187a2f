"""Idle share of the device at the window's pace, its busy time from the
traced NeuS steps."""
from portbench.metrics.common import idle_share


def read(run):
    return idle_share(run)
