"""The collectives the gradient sync is written against, and two backends.

``sync_grads`` needs four things of a world of data-parallel ranks:
``size``, ``all_gather``, ``all_reduce_sum`` and ``reduce_scatter_sum``.
Every collective takes a list with one tensor per rank the process holds
(``local_ranks`` of them) and returns such a list.

- :class:`InProcessWorld` holds all ``size`` ranks in one process, their
  tensors on one device, and its collectives are tensor operations.
  ``size = 1`` is the single-device trainer; ``size > 1`` lets the K-way
  reduction run on one card at a real bucket size and is how the tests
  check the mean semantics.
- :class:`DistributedWorld` is one rank of a ``torch.distributed`` process
  group a process (``local_ranks = 1``): NCCL when the tensors are on CUDA,
  gloo on the CPU, as the caller initialised the group.  K > 1 ranks run as
  K processes, which ``torchrun`` starts::

      python -m torch.distributed.run --standalone --nproc_per_node N \\
          -m repro_torch.launch.train --device cuda ...   # NCCL; --device cpu: gloo

Ranks are laid out as ``n_nodes x node_size``, rank ``r`` being slot
``r % node_size`` of node ``r // node_size``.  ``axis`` selects the groups
a collective runs over: ``"world"`` (all ranks), ``"node"`` (ranks of one
node, the fast links) or ``"cross"`` (same slot across nodes, the slow
links).  Both backends give the same results for the same per-rank inputs:
gathers bit for bit, sums up to the order of the additions.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import torch

PerRank = List[torch.Tensor]


class World:
    """The rank layout both backends share."""

    backend = ""
    local_ranks = 1
    rank = 0            # the first of the ``local_ranks`` ranks this process holds

    def __init__(self, size: int, node_size: Optional[int] = None):
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
        if len(xs) != self.local_ranks:
            raise ValueError(f"expected one tensor per local rank ({self.local_ranks}), "
                             f"got {len(xs)}")


class InProcessWorld(World):
    backend = "in-process"

    def __init__(self, size: int = 1, node_size: Optional[int] = None):
        super().__init__(size, node_size)
        self.local_ranks = size

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


class DistributedWorld(World):
    """This process's rank of the initialised default process group.

    ``node_size`` defaults to ``LOCAL_WORLD_SIZE`` (set by ``torchrun``),
    else to the world size.  The ``"node"`` and ``"cross"`` groups are
    ``dist.new_group`` handles, made here by every rank for every group in
    the same order (a rank that skipped a group it is not in would hang the
    others); a group of all ranks is the default group.  Collectives are
    synchronous: on NCCL the communication stream waits for the work
    already queued on the current stream, and the current stream for the
    collective.  Gathers and reduce-scatters take the tensor forms on flat
    views (gloo refuses a stacked output): they write into the output, where
    the list forms copy through a flat buffer, 1.9 ms of a full-width int8
    sync on one H100.
    """

    def __init__(self, node_size: Optional[int] = None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistributedWorld needs torch.distributed.init_process_group first")
        if node_size is None:
            node_size = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
        super().__init__(dist.get_world_size(), node_size)
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self._dist = dist
        # PyTorch 2.13 renamed the tensor forms and deprecated the old names
        self._gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        self._scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                              or dist.reduce_scatter_tensor)
        self._mine = {}           # axis -> (ranks of this rank's group, handle)
        for axis in ("world", "node", "cross"):
            for ranks in self.groups(axis):
                handle = None if len(ranks) == self.size else dist.new_group(ranks)
                if self.rank in ranks:
                    self._mine[axis] = (ranks, handle)

    def _group(self, axis: str):
        if axis not in self._mine:
            raise ValueError(f"unknown axis {axis!r}")
        return self._mine[axis]

    def all_gather(self, xs: Sequence[torch.Tensor], axis: str = "world") -> PerRank:
        """This rank's group's tensors stacked along a new leading dim, in
        rank order."""
        self._check(xs)
        ranks, handle = self._group(axis)
        x = xs[0].contiguous()
        out = x.new_empty((len(ranks), *x.shape))
        self._gather_flat(out.view(-1), x.view(-1), group=handle)
        return [out]

    def all_reduce_sum(self, xs: Sequence[torch.Tensor], axis: str = "world") -> PerRank:
        self._check(xs)
        _, handle = self._group(axis)
        total = xs[0].clone()
        self._dist.all_reduce(total, op=self._dist.ReduceOp.SUM, group=handle)
        return [total]

    def reduce_scatter_sum(self, xs: Sequence[torch.Tensor], axis: str = "node") -> PerRank:
        """``xs[0]`` is ``(group_size, m)``; returns the group's sum of the
        row at this rank's position in its group."""
        self._check(xs)
        ranks, handle = self._group(axis)
        x = xs[0]
        if x.shape[0] != len(ranks):
            raise ValueError(f"expected {len(ranks)} rows, got {x.shape[0]}")
        out = x.new_empty(x.shape[1:])
        self._scatter_flat(out.view(-1), x.contiguous().view(-1), op=self._dist.ReduceOp.SUM,
                           group=handle)
        return [out]

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Overwrite ``tensors`` in place with rank ``src``'s values."""
        for t in tensors:
            self._dist.broadcast(t, src=src)

    def barrier(self) -> None:
        self._dist.barrier()
