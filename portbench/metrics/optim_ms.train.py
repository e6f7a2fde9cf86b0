"""Device ms a step of clipping and the optimizer: CUDA events around
``clip_by_global_norm`` and the optimizer's ``update``."""


def read(ctx):
    ms = ctx.trace.spans.get("clip_by_global_norm", []) + ctx.trace.spans.get("update", [])
    return sum(ms) / ctx.trace.steps if ms else None
