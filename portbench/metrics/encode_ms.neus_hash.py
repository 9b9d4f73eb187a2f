"""The hash-grid encoder's forward in the NeuS step: device ms under the
program's ``neus.encode`` spans a ``neus.step``, from the span stretch
under the profiler."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "neus.encode", "neus.step")
