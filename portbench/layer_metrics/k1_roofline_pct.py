"""k1_roofline_pct: K1's (``ops/csrc/segment_agg.cu``) share of its
roofline over the traced window."""
from portbench.harness import roofline
from portbench.layer_metrics._kernel_roofline import share


def read(ctx):
    return share(ctx, "k1", roofline.K1_KERNELS)
