"""Comm-schedule IR: buckets -> collective ops, in the order the runtime issues them.

The port's own copy of the scheduler half of the JAX package's
``core/schedule.py``: :class:`CommOp`, :class:`CommPlan`, the three
registered schedulers and :func:`lower_buckets`.  A :class:`CommPlan` is an
ordered set of :class:`CommOp` (bucket -> collective op with priority and
chunking) produced by a named scheduler from the bucket description that
``parallel.grad_sync.BucketPlan`` emits; ``sync_grads`` executes its
collectives in the plan's :meth:`CommPlan.bucket_order`, which is the order
the simulator of the JAX package prices.  The flow lowering onto the
discrete-event engine (rails, codecs, link profiles) is not ported yet.

Schedulers:

- ``fifo``      one op per bucket, served in flush order (Horovod's
                one-collective-in-flight semantics, the paper's baseline);
- ``priority``  ByteScheduler-style: k chunks per bucket, buckets flushed
                *later* (the model's front layers; backward runs
                last-layer-first) are served first;
- ``chunked``   (alias ``chunked-pipelined``) k chunks per bucket in flush
                order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

DEFAULT_CHUNKS = 4


DEFAULT_CHUNKS = 4


@dataclass(frozen=True)
class CommOp:
    """One collective (or one chunk of one) over a bucket's bytes.

    ``op_id`` equals the op's position in the plan by construction, and is
    stable under rail assignment.  ``priority`` orders service within the
    plan's job (smaller first, ties by ``op_id``); ``ready`` is the
    bucket's flush time.  ``channel`` is the rail the op transmits on (0, the
    only rail, until a rail-assignment pass stamps another) and ``codec``
    the compression codec its bytes go through on the wire (``"none"``
    until a codec-assignment pass stamps one); ``size`` stays the *uncompressed* byte count (the IR's conserved
    quantity), compression enters through the per-codec cost model at
    lowering time.
    """

    op_id: int
    bucket_id: int
    chunk: int                      # chunk index within the bucket
    n_chunks: int                   # total chunks of this bucket
    size: float                     # bytes moved by this op
    n_tensors: int                  # tensors whose negotiation cost this op carries
    ready: float                    # earliest start (the bucket's flush time)
    priority: float                 # smaller = served first
    channel: int = 0                # rail id
    codec: str = "none"             # codec name


@dataclass(frozen=True)
class CommPlan:
    """An executable communication schedule for one sync.

    Produced by a registered scheduler from flushed buckets
    (:func:`lower_buckets`) and executed by the runtime via
    :meth:`bucket_order`.  Plans are immutable.
    """

    scheduler: str
    ops: Tuple[CommOp, ...]
    n_buckets: int

    @property
    def total_bytes(self) -> float:
        return float(sum(op.size for op in self.ops))

    def bucket_order(self) -> Tuple[int, ...]:
        """Bucket ids in first-service order — the runtime execution order."""
        order: List[int] = []
        for op in sorted(self.ops, key=lambda o: (o.priority, o.op_id)):
            if op.bucket_id not in order:
                order.append(op.bucket_id)
        return tuple(order)

    @property
    def serialized_fifo(self) -> bool:
        """True when the plan is one op per bucket, served in op order.

        This is the structural precondition for the simulator's closed-form
        fifo fast path: service order ``(priority, op_id)`` must equal op
        order, which holds when priorities are non-decreasing (ties fall
        back to ``op_id``, increasing by construction)."""
        if self.scheduler != "fifo" or len(self.ops) != self.n_buckets:
            return False
        prev = -float("inf")
        for op in self.ops:
            if op.priority < prev:
                return False
            prev = op.priority
        return True


# ---------------------------------------------------------------------------
# schedulers: (ready, size, n_tensors) buckets -> CommPlan
# ---------------------------------------------------------------------------

BucketLike = Tuple[float, float, int]        # (ready_time, bytes, n_tensors)

SchedulerFn = Callable[[Sequence[BucketLike], int, int], CommPlan]

SCHEDULERS: Dict[str, SchedulerFn] = {}

_ALIASES = {"chunked-pipelined": "chunked", "bytescheduler": "priority"}


def canonical_scheduler(name: str) -> str:
    name = _ALIASES.get(name, name)
    if name not in SCHEDULERS:
        known = sorted(SCHEDULERS) + sorted(_ALIASES)
        raise KeyError(f"unknown scheduler {name!r}; known: {', '.join(known)}")
    return name


def _register(name: str):
    def deco(fn: SchedulerFn) -> SchedulerFn:
        SCHEDULERS[name] = fn
        return fn
    return deco


def _chunk(ops: List[CommOp], bucket_id: int, ready: float, size: float,
           n_tensors: int, n_chunks: int, priority_of: Callable[[int, int], float],
           channel: int) -> None:
    """Append ``n_chunks`` equal chunks of one bucket (bytes conserved).

    The per-tensor negotiation cost is paid once per bucket, on its first
    chunk (Horovod negotiates per fused tensor, not per wire chunk).
    """
    k = max(1, min(int(n_chunks), max(int(size), 1)))
    base = size / k
    for c in range(k):
        chunk_size = size - base * (k - 1) if c == k - 1 else base
        ops.append(CommOp(
            op_id=len(ops), bucket_id=bucket_id, chunk=c, n_chunks=k,
            size=chunk_size, n_tensors=n_tensors if c == 0 else 0,
            ready=ready, priority=priority_of(bucket_id, c), channel=channel))


@_register("fifo")
def _sched_fifo(buckets: Sequence[BucketLike], n_chunks: int,
                channel: int = 0) -> CommPlan:
    """Today's Horovod semantics: flush order, no chunking."""
    ops = [CommOp(op_id=i, bucket_id=i, chunk=0, n_chunks=1, size=size,
                  n_tensors=n_tensors, ready=ready, priority=float(i),
                  channel=channel)
           for i, (ready, size, n_tensors) in enumerate(buckets)]
    return CommPlan("fifo", tuple(ops), n_buckets=len(ops))


@_register("chunked")
def _sched_chunked(buckets: Sequence[BucketLike], n_chunks: int,
                   channel: int = 0) -> CommPlan:
    """Flush order at chunk granularity; reduction overlaps transmission."""
    ops: List[CommOp] = []
    for i, (ready, size, n_tensors) in enumerate(buckets):
        _chunk(ops, i, ready, size, n_tensors, n_chunks,
               lambda b, c: float(b), channel)
    return CommPlan("chunked", tuple(ops), n_buckets=len(buckets))


@_register("priority")
def _sched_priority(buckets: Sequence[BucketLike], n_chunks: int,
                    channel: int = 0) -> CommPlan:
    """First-layer-first (ByteScheduler): backward emits the *last* layers
    first, so later-flushed buckets hold the front of the model and preempt
    earlier ones at chunk boundaries."""
    ops: List[CommOp] = []
    n = len(buckets)
    for i, (ready, size, n_tensors) in enumerate(buckets):
        _chunk(ops, i, ready, size, n_tensors, n_chunks,
               lambda b, c: float(n - 1 - b), channel)
    return CommPlan("priority", tuple(ops), n_buckets=len(buckets))


def lower_buckets(buckets: Sequence[BucketLike], *, scheduler: str = "fifo",
                  n_chunks: int = DEFAULT_CHUNKS, channel: int = 0) -> CommPlan:
    """Lower flushed buckets into a :class:`CommPlan` via a named scheduler."""
    return SCHEDULERS[canonical_scheduler(scheduler)](buckets, n_chunks,
                                                      channel)
