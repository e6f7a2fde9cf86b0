"""Device ms a step of the gradient sync: CUDA events around
``sync_grads`` as ``launch.train`` calls it."""


def read(ctx):
    ms = ctx.trace.spans.get("sync_grads")
    return sum(ms) / ctx.trace.steps if ms else None
