"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, on the fullest card."""


def read(ctx):
    return ctx.window.peak_bytes / 2 ** 30 if ctx.window.peak_bytes else None
