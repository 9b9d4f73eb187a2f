"""The NeuS step's share of the f32 peak (the port computes it in f32
without TF32), at the window's rate."""
from portbench.metrics.common import mfu


def read(run):
    return mfu(run, float(run.cell.traffic["batch_rays"]))
