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
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths


def params_from_jax(tree_of_numpy: Any, cfg: ModelConfig, device="cpu") -> Any:
    """Nested dict of numpy arrays -> the port's parameter tree on ``device``.

    Each leaf takes the dtype of the same leaf of the port's own tree for
    ``cfg`` (built on the meta device), not ``cfg.dtype`` for all: RWKV keeps
    its decay and mixing leaves in float32 in a bfloat16 model."""
    from repro_torch.models.registry import get_model

    return _from_template(tree_of_numpy, get_model(cfg).init(None, device="meta"),
                          cfg.name, device)


def _from_template(tree_of_numpy: Any, template: Any, name: str, device) -> Any:
    if tree_paths(tree_of_numpy) != tree_paths(template):
        raise ValueError(f"the tree does not have the key paths of {name}'s parameters")
    shapes = [tuple(np.shape(a)) for a in tree_leaves(tree_of_numpy)]
    if shapes != [tuple(t.shape) for t in tree_leaves(template)]:
        raise ValueError(f"the tree does not have the leaf shapes of {name}'s parameters")

    def one(a, like):
        t = torch.from_numpy(np.array(a, copy=True))     # own memory: the optimizer writes in place
        if t.is_floating_point():
            t = t.to(like.dtype)
        return t.to(device)

    return tree_map(one, tree_of_numpy, template)


def cnn_params_from_jax(tree_of_numpy: Any, name: str, num_classes: int = 1000,
                        width_mult: float = 1.0, device="cpu") -> Any:
    """The CNN counterpart of :func:`params_from_jax`: the template is
    ``models.cnn.get_cnn(name, ...)`` on the meta device (every leaf
    float32; conv weights HWIO, as in JAX)."""
    from repro_torch.models.cnn import get_cnn

    template, _ = get_cnn(name, None, num_classes, width_mult, device="meta")
    return _from_template(tree_of_numpy, template, name, device)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse: tensors -> numpy arrays (bfloat16 widened to float32)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)
