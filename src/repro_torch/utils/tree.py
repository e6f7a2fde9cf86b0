"""Parameter trees: plain nested dicts whose leaves are tensors.

Leaf order is the one ``jax.tree_util.tree_flatten`` gives the same dict:
keys sorted at every level, depth first.  That order is semantics, not
style: the bucket plan of ``parallel.grad_sync`` packs leaves in it.
Tuples and lists (``OptState``) are walked in field order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch


def _is_leaf(node: Any) -> bool:
    return not isinstance(node, (dict, list, tuple))


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in flatten order (dict keys sorted)."""
    if _is_leaf(tree):
        return [tree]
    children = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else tree
    return [leaf for c in children for leaf in tree_leaves(c)]


def tree_paths(tree: Any, prefix: str = "") -> List[str]:
    """Dotted key path of every leaf, in flatten order."""
    if _is_leaf(tree):
        return [prefix]
    items = ([(k, tree[k]) for k in sorted(tree)] if isinstance(tree, dict)
             else list(enumerate(tree)))
    return [p for k, c in items
            for p in tree_paths(c, f"{prefix}.{k}" if prefix else str(k))]


def _build(node: Any, it) -> Any:
    # a module-level function, not a recursive closure: a closure that names
    # itself is a reference cycle, and it would keep every leaf alive until
    # the cycle collector runs (26 GB of weights for a served model)
    if _is_leaf(node):
        return next(it)
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}                # keep insertion order
    children = [_build(c, it) for c in node]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)                      # NamedTuple
    return type(node)(children)


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """Rebuild a tree shaped like ``like`` from leaves in flatten order."""
    return _build(like, iter(leaves))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def value_and_grad(fn: Callable, params: Any, *args) -> Tuple[Tuple[torch.Tensor, Any], Any]:
    """``((loss, aux), grads)`` of ``fn(params, *args) -> (loss, aux)`` with
    respect to every leaf of ``params``; the counterpart of
    ``jax.value_and_grad(fn, has_aux=True)``."""
    leaves = tree_leaves(params)
    had = [leaf.requires_grad for leaf in leaves]
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        loss, aux = fn(params, *args)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for leaf, h in zip(leaves, had):
            leaf.requires_grad_(h)
    aux = tree_map(lambda a: a.detach(), aux)
    return (loss.detach(), aux), tree_unflatten(params, list(grads))
