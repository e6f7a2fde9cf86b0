"""The device's idle share of the traced window: 1 - (union of the
device's intervals) / window, in %."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
