"""Device ms a step of the model's backward: the program's ``step.backward``
spans (``utils/tree.value_and_grad``, around ``torch.autograd.grad``), the
layers' recompute and the attention backward inside."""
from portbench.harness import program_spans


def read(ctx):
    return program_spans.ms_a_step(ctx, "step.backward")
