"""count_device_ms_per_query: the device's busy time in the traced
window (the union of its kernels' and copies' intervals) per count
answered: the card's own work of a count, without the host's gaps."""


def read(ctx):
    t = ctx.trace
    n = len(ctx.answered())
    if t is None or not n or not t.ops:
        return None
    return t.busy_s() * 1e3 / n
