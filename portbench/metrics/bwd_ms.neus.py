"""The NeuS step's backward: device ms under the program's
``neus.backward`` span a ``neus.step``, from the span stretch under the
profiler."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "neus.backward", "neus.step")
