"""serve_batch_occupancy: requests per micro-batch over the traced
window (the change in ``server.stats()["batching"]``)."""


def read(ctx):
    b = ctx.batching
    return b["members"] / b["batches"] if b.get("batches") else None
