"""The window's share of the bf16 peak: every sequence's operations (the
ViT at both edges over its own rescored union, and K3) over the window's
time."""


def read(run):
    flops = run.stats.get("seq_flops")
    if not flops or run.window_s <= 0:
        return None
    return 100.0 * sum(flops[:run.units]) / run.window_s / run.stats["peak_flops"]
