"""The NeuS field's forward, its analytic gradient and its colour head in
the render: device ms under the program's ``neus.field`` spans a
``neus.step``, from the span stretch under the profiler."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "neus.field", "neus.step")
