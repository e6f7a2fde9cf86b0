"""Device ms a step of the checkpointed layers run again by backward: the
program's ``layer.recompute`` spans (``models/transformer.forward``);
nothing under a mix without remat."""
from portbench.harness import program_spans


def read(ctx):
    return program_spans.ms_a_step(ctx, "layer.recompute")
