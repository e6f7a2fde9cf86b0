"""Carry parameters between the JAX package and the port, as numpy arrays.

The two packages share key paths and shapes, so a conversion is a walk over
the tree.  bfloat16 leaves travel as float32 numpy arrays (numpy has no
bfloat16) and are cast on arrival; the cast is exact in both directions.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.utils.tree import tree_map


def params_from_jax(tree_of_numpy: Any, cfg: ModelConfig, device="cpu") -> Any:
    """Nested dict of numpy arrays -> the port's parameter tree on ``device``;
    floating leaves take ``cfg.dtype``."""
    dtype = torch_dtype(cfg.dtype)

    def one(a):
        t = torch.from_numpy(np.array(a, copy=True))     # own memory: the optimizer writes in place
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(one, tree_of_numpy)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays (bfloat16 widened to float32)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
