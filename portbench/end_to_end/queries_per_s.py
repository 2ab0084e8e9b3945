"""queries_per_s: requests completed inside the window with the
reference's rows, over the window's seconds."""


def read(ctx):
    done = [r for r in ctx.sent()
            if r.ok and r.t_done is not None and r.t_done <= ctx.window_end]
    return len(done) / ctx.seconds
