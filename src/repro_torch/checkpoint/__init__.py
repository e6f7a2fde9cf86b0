"""Dependency-free checkpointing of parameter and optimizer-state trees."""
from repro_torch.checkpoint.store import latest_step, restore, save  # noqa: F401
