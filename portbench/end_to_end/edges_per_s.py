"""edges_per_s: 3 |E| for each count completed, over the time from the
window's start to the end of the last count begun inside it (the run
waits for that count): edges joined per second."""


def read(ctx):
    begun = [r for r in ctx.sent() if r.ok]
    if not begun:
        return None
    span = max(r.t_done for r in begun) - ctx.window_start
    return 3 * ctx.data_info["edges"] * len(begun) / span
