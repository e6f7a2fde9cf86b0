"""Device ms a step of the model's forward: the program's ``step.forward``
spans (``utils/tree.value_and_grad``, around the loss function)."""
from portbench.harness import program_spans


def read(ctx):
    return program_spans.ms_a_step(ctx, "step.forward")
