"""join_device_ms_per_query: the device time of the kernels and copies
launched inside a ``caps_tpu_torch.Join`` operator range (the innermost
operator range open at the launch; not the range's span), per answered
request.  Nothing is read where the trace holds no such range."""


def read(ctx):
    t = ctx.trace
    n = len(ctx.answered())
    if t is None or not n:
        return None
    ops = t.owned_by("Join")
    if not ops:
        return None
    return sum(o.end_us - o.start_us for o in ops) / 1e3 / n
