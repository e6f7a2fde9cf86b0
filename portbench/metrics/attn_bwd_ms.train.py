"""Device ms a step of the attention backward: the program's ``attn.backward``
spans (``models/attention._FlashKernelFn.backward``: the plain recompute and
its gradient); nothing where attention does not take the kernel."""
from portbench.harness import program_spans


def read(ctx):
    return program_spans.ms_a_step(ctx, "attn.backward")
