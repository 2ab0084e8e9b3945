"""k2_roofline_pct: K2's (``ops/csrc/expand_positions.cu``) share of its
roofline over the traced window."""
from portbench.harness import roofline
from portbench.layer_metrics._kernel_roofline import share


def read(ctx):
    return share(ctx, "k2", roofline.K2_KERNELS)
