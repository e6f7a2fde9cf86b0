"""MiB a step that the gradient sync hands to ``all_gather``: the change of
the program's counter ``sync.bytes_gathered`` (``parallel/grad_sync``) over
a step; under int8 the codes and one float32 scale a row of 256."""
from portbench.harness import program_spans


def read(ctx):
    n = program_spans.count_a_step(ctx, "sync.bytes_gathered")
    return None if n is None else n / 2 ** 20
