"""The hash-grid encoder's backward and double backward in the NeuS step:
device ms under the program's ``neus.encode_bwd`` spans (autograd's
thread, from the encoding's gradient to the table's or the points') a
``neus.step``, from the span stretch under the profiler."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "neus.encode_bwd", "neus.step")
