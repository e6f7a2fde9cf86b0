"""From process start to the first timed step: imports, the kernel
library, weights and AdamW state, the checked (warm-up) steps."""


def read(ctx):
    return ctx.window.setup_s
