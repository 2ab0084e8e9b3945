"""The device's (H100) idle share over the traced window, in percent."""
from portbench.layer_metrics._idle import idle_pct


def read(ctx):
    return idle_pct(ctx)
