"""serve_queue_wait_p50_ms: the median of the served requests' wait in
the server's queue (``QueryHandle.info["queue_wait_s"]``), traced window."""
import statistics


def read(ctx):
    waits = [r.info["queue_wait_s"] for r in ctx.answered()
             if "queue_wait_s" in r.info]
    return statistics.median(waits) * 1e3 if waits else None
