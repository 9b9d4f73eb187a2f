"""Kernel launches of the hash-grid encoder a NeuS step: those under the
program's ``neus.encode`` and ``neus.encode_bwd`` spans over the
``neus.step`` spans, in the span stretch under the profiler."""
from portbench import spans


def read(run):
    sp = spans.stats(run)
    if sp is None or not sp.spans2.get("neus.step") or "neus.encode" not in sp.launches:
        return None
    n = sp.launches["neus.encode"] + sp.launches.get("neus.encode_bwd", 0)
    return n / sp.spans2["neus.step"]
