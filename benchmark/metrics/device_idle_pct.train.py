"""Share of the traced training window in which no operation ran on the
device."""


def read(ctx):
    if ctx.work["kind"] != "train" or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
