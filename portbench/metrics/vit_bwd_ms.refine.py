"""The ViT's backward inside the real refine step, its recomputation
included: device ms under the program's ``refine.vit_bwd`` span (from the
gradient of the ViT's output to that of its input) a ``refine.step``."""
from portbench import spans


def read(run):
    return spans.per_step(spans.stats(run), "refine.vit_bwd", "refine.step")
