"""K1 and K2 (csrc/raster_fused.cu: the fused raster's forward and its
silhouette backward) against their roofline in the traced refine steps."""
from portbench.metrics.common import roofline


def read(run):
    return roofline(run, "k1k2_bound_s", "mass_fwd_kernel", "mass_merge_kernel",
                    "chunk_prefix_kernel", "sil_bwd_kernel")
