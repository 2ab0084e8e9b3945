"""setup_s: seconds from the process's start to the first timed request
(imports, the kernel libraries, data made from the seed and ingested,
statistics, server start, the warm-up of the cell's query families)."""


def read(ctx):
    return ctx.setup_s
