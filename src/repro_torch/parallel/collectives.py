"""The collectives the gradient sync is written against, and one backend.

``sync_grads`` needs four things of a world of data-parallel ranks:
``size``, ``all_gather``, ``all_reduce_sum`` and ``reduce_scatter_sum``.
This module's backend is the **in-process world**: ``size`` ranks whose
per-rank tensors all live on one device, and whose collectives are tensor
operations.  Every collective takes a list with one tensor per rank and
returns such a list.  ``size = 1`` is what the single-device trainer uses;
``size > 1`` lets the K-way reduction run on one card at a real bucket size
and is how the tests check the mean semantics.  A ``torch.distributed``
backend (one rank per process and device) is future work.

Ranks are laid out as ``n_nodes x node_size``, rank ``r`` being slot
``r % node_size`` of node ``r // node_size``.  ``axis`` selects the groups
a collective runs over: ``"world"`` (all ranks), ``"node"`` (ranks of one
node, the fast links) or ``"cross"`` (same slot across nodes, the slow
links).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

PerRank = List[torch.Tensor]


class InProcessWorld:
    def __init__(self, size: int = 1, node_size: Optional[int] = None):
        node_size = size if node_size is None else node_size
        if size < 1 or node_size < 1 or size % node_size:
            raise ValueError(f"size {size} is not a multiple of node_size {node_size}")
        self.size = size
        self.node_size = node_size
        self.n_nodes = size // node_size

    def groups(self, axis: str) -> List[List[int]]:
        if axis == "world":
            return [list(range(self.size))]
        if axis == "node":
            return [list(range(n * self.node_size, (n + 1) * self.node_size))
                    for n in range(self.n_nodes)]
        if axis == "cross":
            return [list(range(s, self.size, self.node_size))
                    for s in range(self.node_size)]
        raise ValueError(f"unknown axis {axis!r}")

    def _check(self, xs: Sequence[torch.Tensor]) -> None:
        if len(xs) != self.size:
            raise ValueError(f"expected one tensor per rank ({self.size}), got {len(xs)}")

    def all_gather(self, xs: Sequence[torch.Tensor], axis: str = "world") -> PerRank:
        """Every rank receives its group's tensors stacked along a new
        leading dim, in rank order.  Ranks of a group share one result
        tensor (they would hold equal copies)."""
        self._check(xs)
        out: PerRank = [None] * self.size  # type: ignore[list-item]
        for group in self.groups(axis):
            stacked = torch.stack([xs[r] for r in group])
            for r in group:
                out[r] = stacked
        return out

    def all_reduce_sum(self, xs: Sequence[torch.Tensor], axis: str = "world") -> PerRank:
        self._check(xs)
        out: PerRank = [None] * self.size  # type: ignore[list-item]
        for group in self.groups(axis):
            total = xs[group[0]].clone()
            for r in group[1:]:
                total += xs[r]
            for r in group:
                out[r] = total
        return out

    def reduce_scatter_sum(self, xs: Sequence[torch.Tensor], axis: str = "node") -> PerRank:
        """``xs[r]`` is ``(group_size, m)``; the rank at position ``i`` of
        its group receives the group's sum of row ``i``."""
        self._check(xs)
        out: PerRank = [None] * self.size  # type: ignore[list-item]
        for group in self.groups(axis):
            total = xs[group[0]].clone()
            for r in group[1:]:
                total += xs[r]
            for i, r in enumerate(group):
                out[r] = total[i]
        return out
