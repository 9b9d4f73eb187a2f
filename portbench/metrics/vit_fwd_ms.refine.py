"""The ViT's forward inside the real refine step: device ms under the
program's ``refine.vit_fwd`` span a ``refine.step``, from the span
stretch under the profiler (``portbench/spans.py``)."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "refine.vit_fwd", "refine.step")
