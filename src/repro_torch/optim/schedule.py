"""Learning-rate schedules and gradient clipping."""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup -> cosine decay to ``final_frac * peak_lr``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return lr


def constant(lr_value: float) -> Callable:
    return lambda step: torch.as_tensor(lr_value, dtype=torch.float32)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in leaves))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Returns (clipped grads, pre-clip norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def get_schedule(name: str, peak_lr: float, warmup: int, total: int) -> Callable:
    if name == "cosine":
        return warmup_cosine(peak_lr, warmup, total)
    if name == "constant":
        return constant(peak_lr)
    raise ValueError(name)
