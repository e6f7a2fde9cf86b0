"""Sharding rules: where a batch's rows live across the data-parallel ranks.

The start of the port's counterpart of the JAX package's sharding rules,
reduced to the one data axis the trainer has (a world of ranks, no ``pod``
or ``model`` axis).  The rule is the reference's ``data_batch_spec``:
the batch goes over the data axis when the world size divides it, and is
replicated otherwise.  The JAX train-step spec states that rule; the JAX
launcher does not apply it (every device computes the whole batch), and
the port's launcher does.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.parallel.collectives import World


def batch_shardable(world: World, batch: int) -> Optional[Tuple[str, ...]]:
    """The axes the batch dim is split over, or None (replicated)."""
    return ("data",) if batch % world.size == 0 else None


def data_batch_spec(world: World, batch: int) -> Tuple[Optional[Tuple[str, ...]], None]:
    """Per-dim placement of a ``(batch, seq)`` array, as a partition spec's
    entries: ``(("data",), None)`` or ``(None, None)``."""
    return (batch_shardable(world, batch), None)


def shard_batch(batch: Dict[str, np.ndarray], world: World) -> Dict[str, np.ndarray]:
    """This process's rows of a global batch: rows ``[r*B/K, (r+1)*B/K)``
    for rank ``r`` of ``K`` when ``K`` divides ``B``, else all of them."""
    if world.local_ranks != 1:
        raise ValueError("shard_batch is for a process that holds one rank")
    B = len(next(iter(batch.values())))
    if batch_shardable(world, B) is None:
        return batch
    n = B // world.size
    return {k: v[world.rank * n:(world.rank + 1) * n] for k, v in batch.items()}
