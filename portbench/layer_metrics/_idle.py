"""The device's idle share of the traced window: 1 - the union of the
kernels' and copies' intervals over the window's wall time, in percent."""


def idle_pct(ctx):
    t = ctx.trace
    if t is None or t.wall_s <= 0 or not t.ops:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s() / t.wall_s)
