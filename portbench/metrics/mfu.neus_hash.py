"""The NeuS step's share of the f32 peak (the port computes it in f32
without TF32), at the window's rate: the MLPs' operations a step
(``counts/neus_ngp.py``) and the grid's interpolation over the points the
program encoded a step (its ``neus.encoded_points`` over its ``neus.step``
spans, in the span stretch without the profiler)."""
from portbench import spans
from portbench.counts import neus_ngp as CN
from portbench.metrics.common import mfu


def read(run):
    sp = spans.stats(run)
    if sp is None or "unit_flops" not in run.stats:
        return None
    points, steps = sp.counters.get("neus.encoded_points"), sp.spans.get("neus.step")
    if not points or not steps:
        return None
    flops = run.stats["unit_flops"] + CN.interp_flops(run.cell.config["field"], points / steps)
    return mfu(run._replace(stats={**run.stats, "unit_flops": flops}),
               float(run.cell.traffic["batch_rays"]))
