"""Device ms a step of the model's forward and backward: CUDA events
around ``value_and_grad`` as ``launch.train`` calls it."""


def read(ctx):
    ms = ctx.trace.spans.get("value_and_grad")
    return sum(ms) / ctx.trace.steps if ms else None
