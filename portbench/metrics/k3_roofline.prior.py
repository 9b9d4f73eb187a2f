"""K3 (csrc/raster_fused.cu: the prior views' depth raster) against its
roofline over both stages of the traced sequence."""
from portbench.metrics.common import roofline


def read(run):
    return roofline(run, "k3_bound_s", "depth_fwd_kernel", "depth_merge_kernel",
                    "chunk_prefix_kernel")
