"""The share of a kernel's roofline over the traced window: the least
time the card could take for the window's calls (``harness/roofline``)
over the device time of the kernel's launches, in percent."""


def share(ctx, which: str, pattern: str):
    rec = ctx.recorders.get(which)
    if ctx.trace is None or rec is None or not rec.calls:
        return None
    spent_us = sum(o.end_us - o.start_us
                   for o in ctx.trace.matching(pattern))
    if spent_us <= 0:
        return None
    return 100.0 * rec.least_s() * 1e6 / spent_us
