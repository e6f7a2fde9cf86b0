"""Optimizers as functions over the parameter tree: SGD, momentum, AdamW.

Same signatures as the JAX package: ``opt.update(params, state, grads, lr)
-> (params, state)``.  State mirrors the parameter tree leaf by leaf, in
float32.  The update runs **in place** on the parameter and state tensors
it is given and returns them (the counterpart of buffer donation under
``jit``): at 2.8 B parameters a second copy of parameters plus Adam state
would not fit beside the first, so callers must not keep the old values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

Params = Any


class OptState(NamedTuple):
    count: torch.Tensor
    mu: Params          # first moment (or momentum); scalar zeros for sgd
    nu: Params          # second moment; scalar zeros for sgd/momentum


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], OptState]
    update: Callable[[Params, OptState, Params, float], Tuple[Params, OptState]]


def _zeros_like_f32(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _empty(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros((), dtype=torch.float32, device=p.device), params)


def _count0(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _as_f32(lr, device) -> torch.Tensor:
    return torch.as_tensor(lr, dtype=torch.float32, device=device)


def sgd() -> Optimizer:
    def init(params):
        return OptState(_count0(params), _empty(params), _empty(params))

    @torch.no_grad()
    def update(params, state, grads, lr):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_(p.float() - _as_f32(lr, p.device) * g.float())
        return params, state._replace(count=state.count + 1)

    return Optimizer("sgd", init, update)


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return OptState(_count0(params), _zeros_like_f32(params), _empty(params))

    @torch.no_grad()
    def update(params, state, grads, lr):
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu)):
            m.mul_(beta).add_(g.float())
            p.copy_(p.float() - _as_f32(lr, p.device) * m)
        return params, OptState(state.count + 1, state.mu, state.nu)

    return Optimizer("momentum", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return OptState(_count0(params), _zeros_like_f32(params), _zeros_like_f32(params))

    @torch.no_grad()
    def update(params, state, grads, lr):
        count = state.count + 1
        c = count.float()
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state.mu), tree_leaves(state.nu)):
            g = g.float()
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(torch.square(g), alpha=1 - b2)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.float()
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                step.add_(pf, alpha=weight_decay)
            p.copy_(pf - _as_f32(lr, p.device) * step)
        return params, OptState(count, state.mu, state.nu)

    return Optimizer("adamw", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)
