"""The ViT's forward and backward alone on the cell's crops at its
edge, dtype and recomputation policy, ms by CUDA events."""


def read(run):
    return run.stats.get("vit_fb_ms")
