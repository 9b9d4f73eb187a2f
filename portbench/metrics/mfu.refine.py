"""The refine step's share of the bf16 peak: the ViT's forward and
input backward over the frames and K1/K2's work, at the window's rate."""
from portbench.metrics.common import mfu


def read(run):
    s = run.stats
    if "frames" not in s:
        return None
    # frames/s -> steps/s: every step refines all frames by 1 / steps_per_unit.
    return mfu(run, s["frames"] / s["steps_per_unit"])
