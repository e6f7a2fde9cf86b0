"""Tokens of every step completed in the window over the time from the
window's start to the end of its last step: the paper's throughput T."""


def read(ctx):
    return ctx.window.tokens_per_s()
