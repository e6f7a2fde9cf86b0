"""Device ms a step of the gradient sync's copies: the program's
``sync.pack`` and ``sync.unpack`` spans (``parallel/grad_sync``), each
bucket's leaves packed into one float32 slab and the synced slab cut back
into leaves."""
from portbench.harness import program_spans


def read(ctx):
    return program_spans.ms_a_step(ctx, "sync.pack", "sync.unpack")
