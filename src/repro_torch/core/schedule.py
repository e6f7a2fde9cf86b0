"""Comm-schedule IR: buckets -> collective ops, shared by simulator & runtime.

The paper's claim is that *scheduling* — not link capacity — is what keeps
distributed training from scaling.  This module makes the schedule a
first-class object: a :class:`CommPlan` is an ordered set of
:class:`CommOp` (bucket -> collective op with priority, chunking and
channel), produced by a registered *scheduler* from the same bucket
description the runtime's ``BucketPlan`` and the simulator's
``fuse_buckets`` both emit.  The analytic layer lowers a plan onto the
discrete-event engine (:mod:`repro_torch.core.events`); the runtime executes its
collectives in the plan's bucket order — so the simulator predicts exactly
what the runtime does.

Schedulers:

- ``fifo``               one op per bucket, served in flush order with the
                         reduction serialized behind the wire (Horovod's
                         one-collective-in-flight semantics — the paper's
                         measured baseline, bit-exact with the legacy loop);
- ``priority``           ByteScheduler-style: k chunks per bucket, buckets
                         flushed *later* (the model's front layers — backward
                         runs last-layer-first) preempt at chunk boundaries,
                         reductions overlap the next chunk's transmission;
- ``chunked``            (alias ``chunked-pipelined``) k chunks per bucket in
                         flush order, transmission pipelined with reduction
                         — Sun et al.'s fused+pipelined all-reduce.

Rail assignment (multi-NIC hosts) is a separate pass over a finished plan:
:func:`assign_rails` maps each op's ``channel`` onto one of ``n_rails``
rails under a named policy, and :func:`plan_to_flows` lowers channels onto
the engine's per-rail links (``n_rails`` scales each flow's wire work to
the per-rail share of the aggregate bandwidth).  Keeping assignment out of
the schedulers means every scheduler composes with every rail policy, and
an ``n_rails=1`` plan is the *same object* — bit-exact with a run that
never heard of rails.

Codec assignment (gradient compression) follows the same pass idiom:
:func:`assign_codec` stamps each op's ``codec`` (uniformly, or per bucket
under the Hivemind-style ``size-adaptive`` policy), and
:func:`plan_to_flows` — given a ``codecs`` cost table — lowers each op
into an **encode -> wire -> decode** pipeline: encode serializes on the
job's GPU (a closed-form chain that shifts the wire flow's ready time;
the encoder doesn't contend for the NIC), the wire flow carries the
codec's compressed wire time, and decode rides as post-wire latency.
Each op stays one engine flow, so codecs compose with every scheduler,
rail policy, contention, and jitter unchanged.

Exactness contract: ``fifo`` lowered with ``n_rails=1`` onto an
uncontended link reproduces the legacy serialized loop bit-for-bit (the
``duration`` passed to the engine is the legacy loop's exact float
expression); all schedulers conserve bytes exactly per bucket,
:func:`assign_rails` permutes nothing — it only stamps channels — and a
``codecs=None`` (or all-``none``) lowering takes the pre-codec code path
verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import (Callable, Dict, List, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.core.codec import SIZE_ADAPTIVE_THRESHOLD, Codec
from repro_torch.core.events import (DEFAULT_JOB, FlowBatch, FlowSpec, _EMPTY_BATCH,
                               _intern, serialized_chain)
from repro_torch.core.transport import LinkProfile

DEFAULT_CHUNKS = 4


@dataclass(frozen=True)
class CommOp:
    """One collective (or one chunk of one) over a bucket's bytes.

    ``op_id`` equals the op's position in the plan by construction, and is
    stable under rail assignment.  ``priority`` orders service within the
    plan's job (smaller first, ties by ``op_id``); ``ready`` is the
    bucket's flush time.  ``channel`` is the rail the op transmits on —
    0 (the only rail) until :func:`assign_rails` stamps a multi-rail
    assignment.  ``codec`` names the compression codec the op's bytes go
    through on the wire — ``"none"`` until :func:`assign_codec` stamps
    one; ``size`` stays the *uncompressed* byte count (the IR's conserved
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
    channel: int = 0                # rail id (stamped by assign_rails)
    codec: str = "none"             # codec name (stamped by assign_codec)


@dataclass(frozen=True)
class CommPlan:
    """An executable communication schedule for one sync.

    Produced by a registered scheduler from flushed buckets
    (:func:`lower_buckets`); executed by the analytic layer via
    :func:`plan_to_flows` + the event engine, and by the runtime via
    :meth:`bucket_order`.  Plans are immutable: passes like
    :func:`assign_rails` return a new plan.
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


# ---------------------------------------------------------------------------
# rail assignment: CommPlan -> CommPlan with channels stamped
# ---------------------------------------------------------------------------

RAIL_POLICIES = ("round-robin", "size-balanced")


def assign_rails(plan: CommPlan, n_rails: int,
                 policy: str = "round-robin") -> CommPlan:
    """Stamp each op's ``channel`` with one of ``n_rails`` rails.

    Policies:

    - ``round-robin``    op ``i`` transmits on rail ``i % n_rails``.  Over a
      chunked plan this *stripes* every bucket across all rails (chunks of
      one bucket alternate rails), which is how NCCL-style multi-channel
      collectives aggregate NICs; over a fifo plan it deals whole buckets
      out to rails — a serialized stream cannot stripe, which is precisely
      the multirail grid's finding.
    - ``size-balanced``  greedy: each op (in op order) goes to the rail
      with the least accumulated bytes, ties to the lowest rail index.
      Better when op sizes are skewed (e.g. a small tail bucket).

    ``n_rails <= 1`` returns ``plan`` itself (the same object): a one-rail
    run is bit-exact with a run that never heard of rails.  Assignment
    never reorders, splits, or resizes ops — only ``channel`` changes.
    """
    if n_rails <= 1:
        return plan
    if policy not in RAIL_POLICIES:
        raise KeyError(f"unknown rail policy {policy!r}; "
                       f"known: {', '.join(RAIL_POLICIES)}")
    if policy == "round-robin":
        chans = [i % n_rails for i in range(len(plan.ops))]
    else:
        load = [0.0] * n_rails
        chans = []
        for op in plan.ops:
            r = min(range(n_rails), key=load.__getitem__)
            chans.append(r)
            load[r] += op.size
    ops = tuple(replace(op, channel=c) for op, c in zip(plan.ops, chans))
    return replace(plan, ops=ops)


# ---------------------------------------------------------------------------
# codec assignment: CommPlan -> CommPlan with codecs stamped
# ---------------------------------------------------------------------------

CODEC_POLICIES = ("uniform", "size-adaptive")


def assign_codec(plan: CommPlan, codec: str = "none",
                 policy: str = "uniform", *,
                 threshold: Optional[float] = None) -> CommPlan:
    """Stamp each op's ``codec`` under a named policy.

    - ``uniform``        every op gets ``codec``;
    - ``size-adaptive``  Hivemind's idiom: a *bucket* whose total bytes
      reach ``threshold`` (default :data:`~repro_torch.core.codec.
      SIZE_ADAPTIVE_THRESHOLD`) gets ``codec``, smaller buckets stay
      uncompressed — their wire time is negotiation-dominated and the
      encode/decode compute would be pure loss.  The decision is per
      bucket (all chunks of a bucket agree), since the runtime compresses
      the fused bucket before chunking it onto the wire.

    ``codec="none"`` under ``uniform`` returns ``plan`` itself (the same
    object): a codec-free plan is bit-exact with a run that never heard
    of codecs.  Assignment never reorders, splits, or resizes ops.
    """
    if policy not in CODEC_POLICIES:
        raise KeyError(f"unknown codec policy {policy!r}; "
                       f"known: {', '.join(CODEC_POLICIES)}")
    if policy == "uniform":
        if codec == "none":
            return plan
        ops = tuple(replace(op, codec=codec) for op in plan.ops)
        return replace(plan, ops=ops)
    thr = SIZE_ADAPTIVE_THRESHOLD if threshold is None else threshold
    bucket_bytes: Dict[int, float] = {}
    for op in plan.ops:
        bucket_bytes[op.bucket_id] = bucket_bytes.get(op.bucket_id, 0.0) \
            + op.size
    ops = tuple(replace(op, codec=codec
                        if bucket_bytes[op.bucket_id] >= thr else "none")
                for op in plan.ops)
    return replace(plan, ops=ops)


class CodecLowering(NamedTuple):
    """One codec's lowering bundle: the priced :class:`Codec` plus a cost
    model whose wire term already divides by the codec's wire ratio (built
    by the simulator via ``make_cost_model(compression_ratio=
    codec.wire_ratio)``)."""

    codec: Codec
    cost: object


def _codec_stage_seconds(op: CommOp, codec: Codec) -> Tuple[float, float]:
    """(encode, decode) seconds for one op.  Launch overheads are charged
    once per bucket per stage, on the bucket's first chunk (mirroring how
    the negotiation cost rides on chunk 0)."""
    if codec.is_free:
        return 0.0, 0.0
    launch = codec.launch_overhead if op.chunk == 0 else 0.0
    return (launch + codec.encode_seconds(op.size),
            launch + codec.decode_seconds(op.size))


def codec_compute_seconds(plan: CommPlan,
                          codecs: Optional[Mapping[str, CodecLowering]]
                          ) -> float:
    """Total encode+decode compute the plan spends on compression — the
    per-worker GPU-seconds the byte-divisor shortcut pretends are free."""
    if codecs is None:
        return 0.0
    t = 0.0
    for op in plan.ops:
        enc, dec = _codec_stage_seconds(op, codecs[op.codec].codec)
        t += enc + dec
    return t


# ---------------------------------------------------------------------------
# lowering a plan onto the event engine
# ---------------------------------------------------------------------------

def _apply_link(flows: List[FlowSpec],
                lp: Optional[LinkProfile]) -> List[FlowSpec]:
    """Deterministic lossy-link pricing over a lowered flow list.

    The fluid-model mean of a :class:`~repro_torch.core.transport.LinkProfile`:
    wire work inflates by the expected retransmission factor
    ``1/(1-loss)`` and the propagation RTT joins the fixed post-wire
    latency (``duration`` keeps its ``work + latency`` identity).  The
    stochastic tail — RTO stalls — is priced separately by
    :func:`repro_torch.core.transport.retx_events`.  A null (or absent) profile
    returns the *same object*: the zero-loss bypass is bitwise, which is
    what keeps every pre-WAN golden artifact stable.  The elementwise
    float64 arithmetic here and in :func:`_apply_link_batch` is identical
    op for op, preserving the tuple-vs-columnar bit-identity contract.
    """
    if lp is None or lp.is_null:
        return flows
    fac = 1.0 / (1.0 - lp.loss)
    rtt = lp.rtt
    new = tuple.__new__
    out: List[FlowSpec] = []
    for f in flows:
        w = f[2] * fac
        dur = None if f[8] is None else f[8] + (w - f[2]) + rtt
        out.append(new(FlowSpec, (f[0], f[1], w, f[3] + rtt, f[4], f[5],
                                  f[6], f[7], dur, f[9], f[10], f[11])))
    return out


def _apply_link_batch(batch: FlowBatch,
                      lp: Optional[LinkProfile]) -> FlowBatch:
    """Columnar :func:`_apply_link` — same float ops, elementwise."""
    if lp is None or lp.is_null:
        return batch
    fac = 1.0 / (1.0 - lp.loss)
    rtt = lp.rtt
    work = batch.work * fac
    return batch._replace(
        work=work, latency=batch.latency + rtt,
        duration=batch.duration + (work - batch.work) + rtt)


def plan_to_flows(plan: CommPlan, cost, per_tensor_overhead: float = 0.0, *,
                  job: str = "job0", link: str = "nic",
                  op_id_base: int = 0, n_rails: int = 1,
                  codecs: Optional[Mapping[str, CodecLowering]] = None,
                  link_profile: Optional[LinkProfile] = None
                  ) -> List[FlowSpec]:
    """CommOps -> engine flows under a cost model.

    ``cost`` is any all-reduce cost model from :mod:`repro_torch.core.network_model`
    — ``time(size)`` is the serialized duration; ``wire_time(size)`` (when
    present) is the transmission share of it, the part that scales with link
    contention.  The remainder (vector adds + per-tensor negotiation) is a
    fixed latency.  ``fifo`` flows hold the job through the latency and
    carry the legacy loop's exact duration expression, so an uncontended
    fifo schedule is bit-identical with the pre-engine serialized loop.

    ``n_rails > 1`` lowers each op's ``channel`` (stamped by
    :func:`assign_rails`) onto a rail of an aggregate-bandwidth link: the
    cost model still prices wire time at the *aggregate* bandwidth, so each
    rail serves ``1/n_rails`` of it and the flow's wire work scales by
    ``n_rails``; each rail also gets its own serialization lane
    (``job@r<k>``) — a NIC's rails have independent DMA engines, so one
    job's flows on different rails overlap.  Run the result with
    ``run_flows(flows, rails={link: n_rails})``.

    ``codecs`` (a ``{codec name: CodecLowering}`` table covering every
    ``op.codec`` in the plan) turns each op into an encode -> wire ->
    decode pipeline while keeping it ONE engine flow:

    - **encode** runs on the job's GPU, which never contends for the NIC,
      so encode completions are a closed-form serialized chain
      (``end_i = max(ready_i, end_{i-1}) + t_enc_i`` in op order) computed
      right here; the wire flow's ``ready`` becomes its op's encode end;
    - **wire** uses the op's codec's cost model — its wire term divides
      by the codec's wire ratio;
    - **decode** is post-wire compute with no link share: it folds into
      the flow's fixed ``latency`` (and ``duration``, so fifo holds the
      job through it).

    ``codecs=None`` — or a table whose codecs are all free — takes the
    pre-codec arithmetic path for each op: a ``none`` plan is
    bit-identical with a build that never heard of codecs.

    ``link_profile`` (a non-null
    :class:`~repro_torch.core.transport.LinkProfile`) prices the lossy-link
    mean as a final elementwise pass (:func:`_apply_link`); ``None`` or
    the null profile leaves the lowering untouched, object for object.
    """
    hold = plan.scheduler == "fifo"
    flows: List[FlowSpec] = []
    if codecs is not None:
        enc_clock: Optional[float] = None
        for op in plan.ops:
            cl = codecs[op.codec]
            enc, dec = _codec_stage_seconds(op, cl.codec)
            c = cl.cost
            total = c.time(op.size) + per_tensor_overhead * op.n_tensors
            wire = min(getattr(c, "wire_time", c.time)(op.size), total)
            if enc > 0.0:
                start = op.ready if enc_clock is None \
                    else max(op.ready, enc_clock)
                enc_clock = start + enc
                ready = enc_clock
            else:
                ready = op.ready
            lat = max(0.0, total - wire) + dec
            if n_rails <= 1:
                flows.append(FlowSpec(
                    op_id=op_id_base + op.op_id, ready=ready, work=wire,
                    latency=lat, priority=op.priority, job=job,
                    link=f"{link}{op.channel}" if op.channel else link,
                    hold=hold, duration=total + dec))
            else:
                rail_work = wire * n_rails
                flows.append(FlowSpec(
                    op_id=op_id_base + op.op_id, ready=ready,
                    work=rail_work, latency=lat, priority=op.priority,
                    job=job if op.channel == 0 else f"{job}@r{op.channel}",
                    link=link, hold=hold, duration=lat + rail_work,
                    rail=op.channel))
        return _apply_link(flows, link_profile)
    wire_time = getattr(cost, "wire_time", cost.time)
    if n_rails <= 1:
        for op in plan.ops:
            total = cost.time(op.size) + per_tensor_overhead * op.n_tensors
            wire = min(wire_time(op.size), total)
            flows.append(FlowSpec(
                op_id=op_id_base + op.op_id, ready=op.ready, work=wire,
                latency=max(0.0, total - wire), priority=op.priority,
                job=job, link=f"{link}{op.channel}" if op.channel else link,
                hold=hold, duration=total))
        return _apply_link(flows, link_profile)
    for op in plan.ops:
        total = cost.time(op.size) + per_tensor_overhead * op.n_tensors
        wire = min(wire_time(op.size), total)
        lat = max(0.0, total - wire)
        rail_work = wire * n_rails           # per-rail bw = aggregate / n
        flows.append(FlowSpec(
            op_id=op_id_base + op.op_id, ready=op.ready, work=rail_work,
            latency=lat, priority=op.priority,
            job=job if op.channel == 0 else f"{job}@r{op.channel}",
            link=link, hold=hold, duration=lat + rail_work,
            rail=op.channel))
    return _apply_link(flows, link_profile)


def _time_col(cost, sizes: np.ndarray) -> np.ndarray:
    """``cost.time`` over a size column — ``time_v`` when the model has one
    (bit-identical per element by contract), scalar loop otherwise."""
    tv = getattr(cost, "time_v", None)
    if tv is not None:
        return tv(sizes)
    return np.array([cost.time(s) for s in sizes.tolist()], dtype=np.float64)


def _wire_col(cost, sizes: np.ndarray) -> np.ndarray:
    """``getattr(cost, "wire_time", cost.time)`` over a size column."""
    wv = getattr(cost, "wire_time_v", None)
    if wv is not None:
        return wv(sizes)
    wt = getattr(cost, "wire_time", None)
    if wt is not None:
        return np.array([wt(s) for s in sizes.tolist()], dtype=np.float64)
    return _time_col(cost, sizes)


def _channel_names(chans: np.ndarray, fmt) -> Tuple[Tuple[str, ...],
                                                    np.ndarray]:
    """Intern a channel column into (name table, codes) under a naming rule,
    with the table in first-appearance order — the same order a per-op loop
    building names would produce, which :class:`FlowBatch` requires."""
    if not chans.any():
        return (fmt(0),), np.zeros(len(chans), dtype=np.intp)
    u, first, inv = np.unique(chans, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(u), dtype=np.intp)
    rank[order] = np.arange(len(u), dtype=np.intp)
    return tuple(fmt(int(c)) for c in u[order]), rank[inv]


def plan_to_flow_batch(plan: CommPlan, cost,
                       per_tensor_overhead: float = 0.0, *,
                       job: str = "job0", link: str = "nic",
                       op_id_base: int = 0, n_rails: int = 1,
                       codecs: Optional[Mapping[str, CodecLowering]] = None,
                       link_profile: Optional[LinkProfile] = None
                       ) -> FlowBatch:
    """Columnar :func:`plan_to_flows`: one vectorized pass over the plan
    producing a :class:`FlowBatch` instead of a FlowSpec list.

    Bit-identity is the contract, not an aspiration: every column holds
    exactly the float values the per-op loop would put in the tuples.  The
    pieces that make that true:

    - cost models expose ``time_v``/``wire_time_v`` twins whose elementwise
      numpy arithmetic performs the scalar expressions' operations in the
      same order (models without the twins fall back to a scalar loop);
    - the codec encode chain — serialized on the job's GPU with a running
      ``enc_clock`` — is the max-plus recurrence, solved exactly by
      :func:`repro_torch.core.events.serialized_chain` over the subsequence of
      ops with nonzero encode cost (a ``np.maximum.accumulate`` cumsum
      would re-associate the adds and drift);
    - job/link name tables come out in first-appearance order, the
      :class:`FlowBatch` invariant the engine's tie-breaking relies on.

    ``plan_to_flows(...)`` and ``FlowBatch.from_flows`` round-trip through
    this equivalence; the property suite pins it element-wise.
    """
    ops = plan.ops
    if not ops:
        return _EMPTY_BATCH
    op_col, size_col, nt_col, rdy_col, pr_col, ch_col, chunk_col = zip(
        *((o.op_id, o.size, o.n_tensors, o.ready, o.priority, o.channel,
           o.chunk) for o in ops))
    n = len(ops)
    sizes = np.asarray(size_col, dtype=np.float64)
    nt = np.asarray(nt_col, dtype=np.float64)
    ready = np.asarray(rdy_col, dtype=np.float64)
    pr = np.asarray(pr_col, dtype=np.float64)
    chans = np.asarray(ch_col, dtype=np.intp)
    op_ids = np.asarray(op_col, dtype=np.intp) + op_id_base
    hold = np.full(n, plan.scheduler == "fifo")
    pto = per_tensor_overhead

    if codecs is not None:
        ctab, ccode = _intern([o.codec for o in ops])
        totals = np.empty(n)
        wires = np.empty(n)
        enc = np.zeros(n)
        dec = np.zeros(n)
        chunk0 = np.asarray(chunk_col, dtype=np.intp) == 0
        for k, cname in enumerate(ctab):
            cl = codecs[cname]
            idx = np.flatnonzero(ccode == k)
            s = sizes[idx]
            tg = _time_col(cl.cost, s) + pto * nt[idx]
            totals[idx] = tg
            wires[idx] = np.minimum(_wire_col(cl.cost, s), tg)
            cd = cl.codec
            if not cd.is_free:
                launch = np.where(chunk0[idx], cd.launch_overhead, 0.0)
                enc[idx] = launch + cd.encode_seconds(s)
                dec[idx] = launch + cd.decode_seconds(s)
        m = enc > 0.0
        if m.any():
            # the encode chain runs across ALL ops in op order, skipping
            # zero-cost ops — exactly the scalar loop's enc_clock updates
            _, ends = serialized_chain(ready[m], enc[m])
            ready = ready.copy()
            ready[m] = ends
        lat = np.maximum(0.0, totals - wires) + dec
        if n_rails <= 1:
            links, lcode = _channel_names(
                chans, lambda c: f"{link}{c}" if c else link)
            return _apply_link_batch(FlowBatch(
                op_id=op_ids, ready=ready, work=wires, latency=lat,
                priority=pr, duration=totals + dec, hold=hold,
                jobs=(job,), job=np.zeros(n, dtype=np.intp),
                links=links, link=lcode, rail=np.zeros(n, dtype=np.intp),
                worker=np.zeros(n, dtype=np.intp)), link_profile)
        rail_work = wires * n_rails
        jobs, jcode = _channel_names(
            chans, lambda c: job if c == 0 else f"{job}@r{c}")
        return _apply_link_batch(FlowBatch(
            op_id=op_ids, ready=ready, work=rail_work, latency=lat,
            priority=pr, duration=lat + rail_work, hold=hold,
            jobs=jobs, job=jcode, links=(link,),
            link=np.zeros(n, dtype=np.intp), rail=chans,
            worker=np.zeros(n, dtype=np.intp)), link_profile)

    totals = _time_col(cost, sizes) + pto * nt
    wires = np.minimum(_wire_col(cost, sizes), totals)
    lat = np.maximum(0.0, totals - wires)
    if n_rails <= 1:
        links, lcode = _channel_names(
            chans, lambda c: f"{link}{c}" if c else link)
        return _apply_link_batch(FlowBatch(
            op_id=op_ids, ready=ready, work=wires, latency=lat,
            priority=pr, duration=totals, hold=hold,
            jobs=(job,), job=np.zeros(n, dtype=np.intp),
            links=links, link=lcode, rail=np.zeros(n, dtype=np.intp),
            worker=np.zeros(n, dtype=np.intp)), link_profile)
    rail_work = wires * n_rails                # per-rail bw = aggregate / n
    jobs, jcode = _channel_names(
        chans, lambda c: job if c == 0 else f"{job}@r{c}")
    return _apply_link_batch(FlowBatch(
        op_id=op_ids, ready=ready, work=rail_work, latency=lat,
        priority=pr, duration=lat + rail_work, hold=hold,
        jobs=jobs, job=jcode, links=(link,),
        link=np.zeros(n, dtype=np.intp), rail=chans,
        worker=np.zeros(n, dtype=np.intp)), link_profile)


def clone_flows(flows: Sequence[FlowSpec], op_id_base: int, job: str, *,
                old_job: str = DEFAULT_JOB) -> List[FlowSpec]:
    """Relabel an already-lowered flow list for another identical job.

    :func:`plan_to_flows` is pure in everything except ``job`` and
    ``op_id_base``: two co-located jobs running the same plan under the
    same cost model differ only in those labels.  Cloning skips the
    cost-model calls and duration arithmetic entirely and the result is
    bit-identical to a fresh ``plan_to_flows`` call — the same float
    objects, relabeled — which is what lets ``simulate_contention`` lower
    an n-job contention cell once instead of n times.  Rail lanes
    (``job@r<k>``, stamped by :func:`plan_to_flows` under multi-rail
    lowering) are relabeled consistently; job names not starting with
    ``old_job`` are left untouched.
    """
    if op_id_base == 0 and job == old_job:
        return list(flows)
    shift = len(old_job)
    names: dict = {}
    new = tuple.__new__
    out: List[FlowSpec] = []
    for f in flows:
        nm = names.get(f[5])
        if nm is None:
            nm = job + f[5][shift:] if f[5].startswith(old_job) else f[5]
            names[f[5]] = nm
        out.append(new(FlowSpec, (f[0] + op_id_base, f[1], f[2], f[3], f[4],
                                  nm, f[6], f[7], f[8], f[9], f[10], f[11])))
    return out
