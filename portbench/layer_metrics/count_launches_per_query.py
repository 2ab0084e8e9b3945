"""count_launches_per_query: device launches (kernels and copies) in the
traced window per count answered."""


def read(ctx):
    t = ctx.trace
    n = len(ctx.answered())
    if t is None or not n or not t.ops:
        return None
    return len(t.ops) / n
