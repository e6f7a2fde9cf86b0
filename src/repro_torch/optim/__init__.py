"""Optimizers (SGD/momentum/AdamW) + LR schedules and gradient clipping."""
from repro_torch.optim.optimizers import OptState, Optimizer, get_optimizer  # noqa: F401
from repro_torch.optim.schedule import clip_by_global_norm, get_schedule  # noqa: F401
