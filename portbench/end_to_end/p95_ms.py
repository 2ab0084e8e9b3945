"""p95_ms: the 95th percentile (nearest rank) of the latency of every
request sent in the window, from its submit to its rows in hand; a
request that failed or answered wrong counts as slower than any other."""
import math


def p95_ms(records):
    ranked = sorted((not r.ok, r.latency_s if r.latency_s is not None
                     else math.inf) for r in records)
    if not ranked:
        return None
    _failed, s = ranked[max(0, math.ceil(0.95 * len(ranked)) - 1)]
    return s * 1e3 if math.isfinite(s) else None


def read(ctx):
    return p95_ms(ctx.sent())
