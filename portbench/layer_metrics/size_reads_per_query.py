"""size_reads_per_query: the window's size reads (the change in
``session.backend.syncs``) per answered request."""


def read(ctx):
    n = len(ctx.answered())
    return ctx.syncs / n if n else None
