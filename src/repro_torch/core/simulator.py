"""The paper's §3.1 what-if simulator, on the discrete-event network engine.

Two logical processes communicate through a queue:

- the **backward process** replays the gradient-ready timeline and batches
  gradients into a Horovod-style fusion buffer (64 MB size limit OR 5 ms
  timeout from the first pending gradient, whichever fires first);
- the **communication process** lowers the flushed buckets into a
  :class:`~repro_torch.core.schedule.CommPlan` under a named scheduler and
  executes it on the event engine (:mod:`repro_torch.core.events`):

  * ``fifo``      — FIFO, one serialized collective in flight (Horovod's
                    semantics; bit-exact with the legacy serialized loop);
  * ``priority``  — first-layer-first with preemption at chunk boundaries
                    (ByteScheduler-style);
  * ``chunked``   — k chunks per bucket, transmission pipelined with
                    reduction (Sun et al.'s fused+pipelined all-reduce).

The ``topology``/``transport`` cost models become per-flow durations (a
wire part that scales under link sharing plus a fixed reduction latency),
so multi-job contention — two timelines on one link — is expressible via
:func:`simulate_contention`.

Two scenario axes the paper's testbed could not sweep ride on the same
lowering:

- ``n_rails`` splits the link into that many rails at ``1/n_rails`` of the
  aggregate bandwidth each (:func:`~repro_torch.core.schedule.assign_rails`
  stamps ops onto rails; the engine runs one fluid clock per rail), so a
  2x50G multi-rail host and a single 100G NIC are different cells at equal
  aggregate bandwidth;
- ``jitter`` perturbs every flow's flush time by a seeded exponential draw
  (:func:`~repro_torch.core.events.perturb_flows`) — the straggler axis.  Both
  default off and the default path is bit-exact with a build that never
  had them.

Outputs: t_sync, t_overhead = max(0, t_sync - t_back), and
f_sim = t_batch / (t_batch + t_overhead)   (paper Eq. in §3.1).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import CommConfig
from repro_torch.core.addest import AddEst
from repro_torch.core.codec import NONE_CODEC, SIZE_ADAPTIVE, Codec, get_codec
from repro_torch.core import events as _ev
from repro_torch.core.events import (DEFAULT_LINK, FlowBatch, FlowResult, FlowSpec,
                               ResultBatch, concat_batches, perturb_batch,
                               perturb_flows, run_flow_batch, run_flows,
                               serialized_chain)
from repro_torch.core.fabric import resolve_fabric
from repro_torch.core.faults import (FaultModel, apply_faults_batch,
                               apply_faults_flows, churn_events,
                               parse_fault_model, worker_codes)
from repro_torch.core.network_model import RingAllReduce, make_cost_model
from repro_torch.core.schedule import (CodecLowering, CommPlan, assign_codec,
                                 assign_rails, canonical_scheduler,
                                 clone_flows, codec_compute_seconds,
                                 lower_buckets, plan_to_flow_batch,
                                 plan_to_flows)
from repro_torch.core.timeline import GradTimeline
from repro_torch.core.transport import (LinkProfile, Transport, get_transport,
                                  parse_link_profile, retx_events)


BUCKET_FIELDS = ("flush_time", "size", "n_tensors", "start", "end")

# scalar SimResult fields, in stable serialization order (artifact schema)
RESULT_FIELDS = ("name", "n_workers", "bandwidth", "effective_bw", "t_batch",
                 "t_back", "t_sync", "t_overhead", "scaling_factor",
                 "wire_bytes_per_worker", "network_utilization")


@dataclass(frozen=True)
class Bucket:
    flush_time: float        # when the backward process hands it over
    size: float              # bytes
    n_tensors: int = 1       # gradient tensors fused into this bucket
    start: float = 0.0       # all-reduce start (filled by the engine)
    end: float = 0.0

    def to_dict(self) -> dict:
        return {f: getattr(self, f) for f in BUCKET_FIELDS}

    @staticmethod
    def from_dict(d: dict) -> "Bucket":
        return Bucket(**{f: d[f] for f in BUCKET_FIELDS})


@dataclass(frozen=True)
class SimResult:
    name: str
    n_workers: int
    bandwidth: float                  # physical link bandwidth, bytes/s
    effective_bw: float               # after the transport curve
    t_batch: float
    t_back: float
    t_sync: float
    t_overhead: float
    scaling_factor: float
    buckets: Tuple[Bucket, ...]
    wire_bytes_per_worker: float      # actual bytes each worker moved
    network_utilization: float        # avg wire throughput / physical bw
    scheduler: str = "fifo"           # comm schedule the result was run under
    codec: str = "none"               # compression codec the run was under
    codec_compute_s: float = 0.0      # encode+decode GPU seconds spent

    def summary(self) -> str:
        return (f"{self.name}: n={self.n_workers} bw={self.bandwidth*8/1e9:.0f}Gbps "
                f"sched={self.scheduler} f_sim={self.scaling_factor:.3f} "
                f"overhead={self.t_overhead*1e3:.1f}ms "
                f"util={self.network_utilization:.2f}")

    def to_dict(self, include_buckets: bool = False) -> dict:
        """Stable JSON-ready form (the experiment-artifact cell schema).

        Buckets are summarized by count unless ``include_buckets``; full
        float repr round-trips through JSON bit-exactly either way.  The
        codec fields are elided at their defaults so codec-free artifacts
        keep their exact pre-codec bytes.
        """
        d = {f: getattr(self, f) for f in RESULT_FIELDS}
        d["scheduler"] = self.scheduler
        d["n_buckets"] = len(self.buckets)
        if self.codec != "none":
            d["codec"] = self.codec
            d["codec_compute_s"] = self.codec_compute_s
        if include_buckets:
            d["buckets"] = [b.to_dict() for b in self.buckets]
        return d

    @staticmethod
    def from_dict(d: dict) -> "SimResult":
        buckets = tuple(Bucket.from_dict(b) for b in d.get("buckets", ()))
        return SimResult(**{f: d[f] for f in RESULT_FIELDS}, buckets=buckets,
                         scheduler=d.get("scheduler", "fifo"),
                         codec=d.get("codec", "none"),
                         codec_compute_s=d.get("codec_compute_s", 0.0))


def fuse_buckets(timeline: GradTimeline, comm: CommConfig) -> List[Bucket]:
    """The backward process: fusion-buffer batching of the gradient stream.

    Faithful to Horovod semantics as described in the paper: a bucket is
    flushed when it reaches the size limit, or when ``timeout_ms`` has
    elapsed since its first pending gradient.  The tail bucket flushes when
    the last gradient arrives (backward completion ends the cycle — Horovod
    does not idle out the final timeout window).

    A gradient larger than the buffer flushes in ``limit``-sized slabs; the
    split tensor stays pending in the remainder bucket and is counted there
    (``n_pend = 1``), so per-tensor negotiation overhead is charged once per
    bucket the tensor occupies rather than undercounting every flush after
    a slab split.
    """
    limit = comm.fusion_buffer_mb * 1024 * 1024
    timeout = comm.timeout_ms / 1e3
    buckets: List[Bucket] = []
    pending, n_pend = 0.0, 0
    first_t: Optional[float] = None

    for t, size in zip(timeline.ready_times, timeline.sizes):
        if first_t is not None and t > first_t + timeout:
            buckets.append(Bucket(first_t + timeout, pending, n_pend))
            pending, n_pend, first_t = 0.0, 0, None
        if first_t is None:
            first_t = t
        pending += size
        n_pend += 1
        while pending >= limit:
            # a gradient larger than the buffer flushes in `limit` slabs
            buckets.append(Bucket(t, min(pending, limit), max(n_pend, 1)))
            pending -= min(pending, limit)
            n_pend = 0 if pending == 0.0 else 1   # the split tensor's tail
            first_t = None if pending == 0.0 else t
    if pending > 0.0 and first_t is not None:
        buckets.append(Bucket(timeline.t_back, pending, n_pend))
    return buckets


# The max-plus chain solver moved to repro_torch.core.events (serialized_chain):
# the columnar lowering's codec encode chain needs it too.  Re-exported
# under its old name for the fifo fast path and the tests pinning its
# exactness against the serial loop.
_serialized_closed_form = serialized_chain


def _fifo_fast_results(plan: CommPlan, flows: Sequence[FlowSpec]
                       ) -> Optional[List[FlowResult]]:
    """Closed-form results for a single-job, unit-capacity fifo plan.

    A serialized fifo plan can never contend — one ``hold`` flow in flight
    on a dedicated link — so the event loop degenerates to the max-plus
    recurrence that :func:`_serialized_closed_form` vectorizes.  Dispatch
    is *checked*, not assumed: every precondition the closed form relies on
    (hold semantics with precomputed durations, one job, one link, ready
    times non-decreasing along service order) is verified on the actual
    flow list, and anything else returns ``None`` to take the engine path.
    The caller guarantees unit link capacity by constructing the default
    engine (``run_flows`` with no ``capacities``).
    """
    if not plan.serialized_fifo:
        return None
    if not flows:
        return []
    if len(flows) < _FASTPATH_MIN_OPS:
        return None     # numpy's fixed costs exceed the calendar's below this
    job = flows[0].job
    link = flows[0].link
    prev_ready = -float("inf")
    for f in flows:
        if (not f.hold or f.duration is None or f.job != job
                or f.link != link or f.ready < prev_ready):
            return None
        prev_ready = f.ready
    ready = np.array([f.ready for f in flows])
    dur = np.array([f.duration for f in flows])
    starts, ends = _serialized_closed_form(ready, dur)
    wire_ends = starts + np.array([f.work for f in flows])
    new = tuple.__new__
    return [new(FlowResult, (f.op_id, job, s, w, e, False))
            for f, s, w, e in zip(flows, starts.tolist(), wire_ends.tolist(),
                                  ends.tolist())]


def _fifo_fast_batch(plan: CommPlan, batch: FlowBatch
                     ) -> Optional[ResultBatch]:
    """Columnar twin of :func:`_fifo_fast_results`.

    Same dispatch checks, run on the columns instead of per tuple: hold
    semantics with precomputed durations, one job, one link, ready times
    non-decreasing.  Anything else returns ``None`` for the engine path.
    """
    if not plan.serialized_fifo:
        return None
    n = batch.n
    if n < _FASTPATH_MIN_OPS:
        return None
    if len(batch.jobs) != 1 or len(batch.links) != 1:
        return None
    dur = batch.duration
    if (not batch.hold.all() or np.isnan(dur).any()
            or not (batch.ready[1:] >= batch.ready[:-1]).all()):
        return None
    starts, ends = serialized_chain(batch.ready, dur)
    return ResultBatch(batch.op_id, batch.jobs, batch.job, starts,
                       starts + batch.work, ends, np.zeros(n, dtype=bool))


# below ~2 dozen ops the event calendar is cheaper than numpy dispatch; the
# closed form pays off on the long serialized plans large sweeps generate
_FASTPATH_MIN_OPS = 24


def _fastpath_enabled() -> bool:
    return os.environ.get("REPRO_SIM_FASTPATH", "1") != "0"


def _resolve_codec(codec: str, compression_ratio: float,
                   error_feedback: bool) -> Tuple[str, Codec]:
    """Resolve the simulate-level codec knobs into an assignment policy
    plus a priced :class:`~repro_torch.core.codec.Codec`.

    ``size-adaptive[:base]`` selects the Hivemind per-bucket policy with
    ``base`` (default ``int8``) on large buckets; anything else is a
    uniform stamp.  The legacy ``compression_ratio`` float rides along:
    ``codec="none"`` with a non-unit ratio resolves to the free parametric
    ``ratio`` codec, which reproduces the deprecated byte-divisor path
    bit-identically.
    """
    if codec == SIZE_ADAPTIVE or codec.startswith(SIZE_ADAPTIVE + ":"):
        base = codec.partition(":")[2] or "int8"
        resolved = get_codec(base, compression_ratio=compression_ratio)
        policy = "size-adaptive"
    else:
        resolved = get_codec(codec, compression_ratio=compression_ratio)
        policy = "uniform"
    if error_feedback:
        resolved = resolved.with_error_feedback()
    return policy, resolved


def _codec_lowerings(plan: CommPlan, resolved: Codec, base_cost, codec_cost
                     ) -> dict:
    """The ``codecs`` table for a stamped plan: the resolved codec plus the
    ``none`` passthrough (present under size-adaptive plans)."""
    table = {resolved.name: CodecLowering(resolved, codec_cost)}
    if any(op.codec == "none" for op in plan.ops):
        table["none"] = CodecLowering(NONE_CODEC, base_cost)
    return table


def _serve_from_batch(plan: CommPlan, buckets: Sequence[Bucket],
                      rb: ResultBatch) -> Tuple[List[Bucket], float, float]:
    """Columnar twin of :func:`_serve_plan`'s result-mapping loop.

    Bucket chunks are contiguous in op order under every scheduler, so the
    per-bucket min(start)/max(end) are segment reductions; ``busy`` stays a
    strict left fold over op order (``sum`` of a list — ``np.sum`` is
    pairwise and would re-associate the adds).  Bucket fields are cast back
    to python floats at this boundary so downstream JSON writers never see
    ``np.float64``.
    """
    if rb.n == 0:
        return [], 0.0, 0.0
    bid = np.fromiter((op.bucket_id for op in plan.ops), dtype=np.intp,
                      count=rb.n)
    seg = np.concatenate(([0], np.flatnonzero(bid[1:] != bid[:-1]) + 1))
    ids = bid[seg]
    s_min = np.minimum.reduceat(rb.start, seg)
    e_max = np.maximum.reduceat(rb.end, seg)
    nb = plan.n_buckets
    start = np.full(nb, np.inf)
    end = np.zeros(nb)
    np.minimum.at(start, ids, s_min)       # tolerates non-contiguous ids
    np.maximum.at(end, ids, e_max)
    occ = rb.end - rb.start if plan.scheduler == "fifo" \
        else rb.wire_end - rb.start
    busy = sum(occ.tolist())
    served = [Bucket(b.flush_time, b.size, b.n_tensors,
                     float(start[i]) if start[i] != np.inf else b.flush_time,
                     float(end[i]))
              for i, b in enumerate(buckets)]
    t_sync = max((b.end for b in served), default=0.0)
    return served, t_sync, busy


def _fault_horizon(ready: np.ndarray, work: np.ndarray,
                   latency: np.ndarray) -> float:
    """The iteration span churn arrivals are drawn over.

    An upper-bound proxy (max over ``ready + work + latency`` of the
    already-perturbed flows) — any deterministic positive scale works,
    but computing it identically from columns and from tuple-built arrays
    keeps both lowering paths' churn draws bit-identical.
    """
    return float(np.max(ready + work + latency))


def _serve_plan(plan: CommPlan, buckets: Sequence[Bucket], cost,
                tr: Transport, *, job: str = "job0",
                results: Optional[Sequence[FlowResult]] = None,
                n_rails: int = 1, jitter: float = 0.0, jitter_seed: int = 0,
                stream: int = 0,
                codecs: Optional[dict] = None,
                fault: Optional[FaultModel] = None,
                fault_seed: int = 0, n_workers: int = 1,
                path: Tuple[str, ...] = (),
                capacities: Optional[dict] = None,
                link: Optional[LinkProfile] = None
                ) -> Tuple[List[Bucket], float, float]:
    """Map per-op flow results back to per-bucket (start, end) + busy time.

    ``plan`` must already carry its rail assignment (channels); ``n_rails``
    only sizes the per-rail links.  ``jitter``/``jitter_seed``/``stream``
    perturb flow ready times via :func:`~repro_torch.core.events.perturb_flows`
    — the fifo fast path stays dispatch-checked on the *perturbed* flows,
    so it still applies whenever the jittered ready order happens to stay
    monotone, and falls back to the engine otherwise.

    ``fault`` (a non-null :class:`~repro_torch.core.faults.FaultModel`) applies
    after jitter: correlated delays and bandwidth skew rewrite the flows
    (:func:`~repro_torch.core.faults.apply_faults_batch` and its tuple twin),
    then churn events — if any were drawn — route the run to the engine's
    membership-change path.  ``fault=None`` leaves every branch of this
    function untouched, byte for byte.

    Plans at or above the engine's small-plan threshold lower columnar
    (:func:`~repro_torch.core.schedule.plan_to_flow_batch` straight into
    :meth:`~repro_torch.core.events.NetworkEngine.run_batch`, no tuple
    materialization); ``REPRO_SIM_FASTPATH=0`` disables that dispatch and
    the fifo closed form together.

    ``path``/``capacities`` lower the plan onto a fabric route (see
    :mod:`repro_torch.core.fabric`): a multi-link ``path`` is stamped on every
    flow after jitter and faults, routing the run to the engine's
    max-min core with the fabric's link capacities.  A path of length
    <= 1 stamps nothing — the fabric elided its uplink — leaving every
    branch byte-identical to the flat topology.

    ``link`` (a non-null :class:`~repro_torch.core.transport.LinkProfile`)
    prices the lossy-link axis: the lowering inflates wire work and adds
    the RTT deterministically (:func:`~repro_torch.core.schedule._apply_link`),
    and seeded RTO stalls (:func:`~repro_torch.core.transport.retx_events`,
    substream ``(4,)`` of ``fault_seed``) join the churn list — the
    engine's ``_RETX`` calendar entries.  ``link=None`` leaves every
    branch byte-identical to the clean-link build.
    """
    fabric_path = path if len(path) > 1 else ()
    if results is None:
        if _fastpath_enabled() and len(plan.ops) >= _ev._SMALL_PLAN_MAX_FLOWS:
            batch = plan_to_flow_batch(plan, cost, tr.per_tensor_overhead,
                                       job=job, n_rails=n_rails,
                                       codecs=codecs, link_profile=link)
            if jitter > 0.0:
                batch = perturb_batch(batch, jitter, jitter_seed, stream)
            churn = None
            if fault is not None and batch.n:
                codes = worker_codes(plan, n_workers)
                batch = apply_faults_batch(batch, codes, fault, n_workers,
                                           fault_seed, stream)
                churn = churn_events(
                    fault, n_workers,
                    _fault_horizon(batch.ready, batch.work, batch.latency),
                    fault_seed, stream, job=job) or None
            if link is not None and batch.n:
                retx = retx_events(
                    link, sum(op.size for op in plan.ops),
                    _fault_horizon(batch.ready, batch.work, batch.latency),
                    fault_seed, stream, job=job)
                if retx:
                    churn = list(churn or ()) + retx
            if fabric_path:
                batch = batch.with_path(fabric_path)
                rb = run_flow_batch(batch, capacities=capacities,
                                    churn=churn)
            else:
                rb = None if churn else _fifo_fast_batch(plan, batch)
                if rb is None:
                    rb = run_flow_batch(batch, rails={DEFAULT_LINK: n_rails}
                                        if n_rails > 1 else None, churn=churn)
            return _serve_from_batch(plan, buckets, rb)
        flows = plan_to_flows(plan, cost, tr.per_tensor_overhead, job=job,
                              n_rails=n_rails, codecs=codecs,
                              link_profile=link)
        if jitter > 0.0:
            flows = perturb_flows(flows, jitter, jitter_seed, stream)
        churn = None
        if fault is not None and flows:
            codes = worker_codes(plan, n_workers)
            flows = apply_faults_flows(flows, codes, fault, n_workers,
                                       fault_seed, stream)
            churn = churn_events(
                fault, n_workers,
                _fault_horizon(np.array([f.ready for f in flows]),
                               np.array([f.work for f in flows]),
                               np.array([f.latency for f in flows])),
                fault_seed, stream, job=job) or None
        if link is not None and flows:
            retx = retx_events(
                link, sum(op.size for op in plan.ops),
                _fault_horizon(np.array([f.ready for f in flows]),
                               np.array([f.work for f in flows]),
                               np.array([f.latency for f in flows])),
                fault_seed, stream, job=job)
            if retx:
                churn = list(churn or ()) + retx
        if fabric_path:
            flows = [f._replace(path=fabric_path) for f in flows]
            results = run_flows(flows, capacities=capacities, churn=churn)
        if results is None and _fastpath_enabled() and churn is None:
            results = _fifo_fast_results(plan, flows)
        if results is None:
            results = run_flows(flows, rails={DEFAULT_LINK: n_rails}
                                if n_rails > 1 else None, churn=churn)
    start = {b: None for b in range(plan.n_buckets)}
    end = {b: 0.0 for b in range(plan.n_buckets)}
    busy = 0.0
    for op, r in zip(plan.ops, results):
        b = op.bucket_id
        start[b] = r.start if start[b] is None else min(start[b], r.start)
        end[b] = max(end[b], r.end)
        busy += r.occupancy if plan.scheduler == "fifo" else r.wire_end - r.start
    served = [Bucket(b.flush_time, b.size, b.n_tensors,
                     start[i] if start[i] is not None else b.flush_time,
                     end[i])
              for i, b in enumerate(buckets)]
    t_sync = max((b.end for b in served), default=0.0)
    return served, t_sync, busy


def simulate(timeline: GradTimeline, *, n_workers: int, bandwidth: float,
             comm: Optional[CommConfig] = None,
             transport: str | Transport = "ideal",
             addest: Optional[AddEst] = None,
             compression_ratio: float = 1.0,
             topology: str = "ring", n_pods: int = 1,
             dcn_bandwidth: Optional[float] = None,
             scheduler: Optional[str] = None,
             n_chunks: Optional[int] = None,
             n_rails: int = 1, rail_policy: str = "round-robin",
             jitter: float = 0.0, jitter_seed: int = 0,
             codec: str = "none", error_feedback: bool = False,
             fault_model: str = "none", churn_rate: float = 0.0,
             worker_bw_skew: float = 0.0, fault_seed: int = 0,
             fabric: str = "none",
             oversubscription: float = 1.0,
             link_profile: str | LinkProfile = "none") -> SimResult:
    """Run the two-process simulation for one iteration.

    ``bandwidth`` in bytes/s.  ``transport`` maps physical to effective
    bandwidth (the paper's measured-vs-ideal axis).  ``scheduler`` selects
    the comm schedule (default: ``comm.scheduler``, i.e. ``fifo``);
    ``n_chunks`` the chunking granularity of the pipelined schedulers.

    ``n_rails`` splits ``bandwidth`` (the *aggregate*) into that many
    equal rails and spreads the plan's ops across them under
    ``rail_policy`` (see :func:`~repro_torch.core.schedule.assign_rails`);
    ``jitter`` (seconds, mean of the per-flow exponential delay) with
    ``jitter_seed`` turns on the straggler axis.  Both at their defaults
    reproduce today's results bit-for-bit.

    ``codec`` names a gradient-compression codec (see
    :mod:`repro_torch.core.codec`): real codecs (``int8``, ``ternary``,
    ``topk:r``, ``size-adaptive[:base]``) lower every op into encode ->
    wire -> decode with kernel-calibrated compute costs;
    ``error_feedback`` adds the EF-SGD residual traffic to encode (and
    rejects free codecs).  ``codec="none"`` — with or without the
    deprecated ``compression_ratio`` byte divisor, which now routes
    through the free parametric ``ratio`` codec — is bit-exact with the
    pre-codec build.

    ``fault_model`` (``"none"`` | ``"slowdown:<ms>[:<rho>]"``) with
    ``churn_rate``/``worker_bw_skew``/``fault_seed`` turn on the
    unreliable-world axes (:mod:`repro_torch.core.faults`): worker-correlated
    slowdowns, dropout/rejoin churn with a priced re-bucketing stall, and
    asymmetric per-worker bandwidth.  All at their defaults resolve to a
    null model that bypasses the fault layer entirely — bit-identical to
    the pre-fault engine.

    ``fabric`` (``"none"`` | ``"clos"``) with ``oversubscription`` lowers
    the collective onto a datacenter fabric (:mod:`repro_torch.core.fabric`):
    flows traverse NIC -> ToR-uplink paths and the engine prices them at
    the bottleneck max-min fair share.  ``fabric="none"`` — and any
    fabric whose uplink can never bind, e.g. ``clos`` at 1:1 — is
    *bitwise* identical to the flat single-link topology.

    ``link_profile`` (``"none"`` |
    ``"wan:loss=p,rtt=ms[:timeout=ms,backoff=x]"`` | a
    :class:`~repro_torch.core.transport.LinkProfile`) turns on the lossy-link
    axis: wire work inflates by ``1/(1-loss)``, the RTT joins the fixed
    latency, and seeded retransmission-timeout stalls (substream ``(4,)``
    of ``fault_seed``) ride the engine's ``_RETX`` calendar.  The null
    profile is *bitwise* identical to the clean-link build.
    """
    comm = comm or CommConfig()
    addest = addest or AddEst.v100()
    tr = get_transport(transport) if isinstance(transport, str) else transport
    eff_bw = tr.effective(bandwidth)
    sched = canonical_scheduler(scheduler or comm.scheduler)
    k = n_chunks if n_chunks is not None else comm.sched_chunks
    n_rails = max(int(n_rails), 1)      # 0 and 1 both mean "no rails"
    policy, resolved = _resolve_codec(codec, compression_ratio,
                                      error_feedback)
    free = resolved.is_free and policy == "uniform"
    fm = parse_fault_model(fault_model, churn_rate=churn_rate,
                           bw_skew=worker_bw_skew)
    fault = None if fm.is_null else fm
    fab = resolve_fabric(fabric, oversubscription)
    lp = parse_link_profile(link_profile)
    lpr = None if lp.is_null else lp
    fpath = fab.path(topology) if fab is not None else ()
    fcaps = fab.capacities() if fab is not None else None
    if len(fpath) > 1 and n_rails > 1:
        raise ValueError("fabric paths and multi-rail links are mutually "
                         "exclusive (rails split the NIC, the fabric the "
                         "spine)")

    def _cost(ratio: float):
        return make_cost_model(
            n_workers, eff_bw, addest, topology=topology, n_pods=n_pods,
            dcn_bw=tr.effective(dcn_bandwidth or bandwidth / 2),
            compression_ratio=ratio)

    # free codecs keep the legacy path verbatim: the wire ratio lands in
    # the cost model exactly where compression_ratio used to
    cost = _cost(resolved.wire_ratio if free else 1.0)

    buckets = fuse_buckets(timeline, comm)
    plan = lower_buckets([(b.flush_time, b.size, b.n_tensors)
                          for b in buckets], scheduler=sched, n_chunks=k)
    plan = assign_rails(plan, n_rails, rail_policy)
    codecs = None
    if not free:
        plan = assign_codec(plan, resolved.name, policy=policy)
        codecs = _codec_lowerings(plan, resolved, cost,
                                  _cost(resolved.wire_ratio))
    served, t_sync, busy = _serve_plan(plan, buckets, cost, tr,
                                       n_rails=n_rails, jitter=jitter,
                                       jitter_seed=jitter_seed,
                                       codecs=codecs, fault=fault,
                                       fault_seed=fault_seed,
                                       n_workers=n_workers,
                                       path=fpath, capacities=fcaps,
                                       link=lpr)

    if not served:
        t_sync = timeline.t_back
    t_overhead = max(0.0, t_sync - timeline.t_back)
    f_sim = timeline.t_batch / (timeline.t_batch + t_overhead)

    # wire bytes from the active cost model (SwitchML moves ~S per worker,
    # hierarchical counts the ICI stage, ring the 2S(N-1)/N ring traffic);
    # under a codec each op's bytes go through its own codec's model
    if codecs is None:
        wire = sum(cost.wire_bytes(b.size) for b in served)
    else:
        wire = sum(codecs[op.codec].cost.wire_bytes(op.size)
                   for op in plan.ops)
    # utilization while the communication process occupies the link (paper
    # Fig. 4 measures real-time NIC throughput during the comm phase);
    # with rails, ``busy`` sums per-lane occupancy, so the denominator is
    # the per-rail share of the aggregate bandwidth
    util = (wire / busy) / (bandwidth / n_rails) if busy > 0 else 0.0

    return SimResult(
        name=timeline.name, n_workers=n_workers, bandwidth=bandwidth,
        effective_bw=eff_bw, t_batch=timeline.t_batch, t_back=timeline.t_back,
        t_sync=t_sync, t_overhead=t_overhead, scaling_factor=f_sim,
        buckets=tuple(served), wire_bytes_per_worker=wire,
        network_utilization=min(util, 1.0), scheduler=sched,
        codec=codec, codec_compute_s=codec_compute_seconds(plan, codecs))


def simulate_contention(timelines: Sequence[GradTimeline], *, n_workers: int,
                        bandwidth: float, comm: Optional[CommConfig] = None,
                        transport: str | Transport = "ideal",
                        addest: Optional[AddEst] = None,
                        compression_ratio: float = 1.0,
                        scheduler: Optional[str] = None,
                        n_chunks: Optional[int] = None,
                        n_rails: int = 1, rail_policy: str = "round-robin",
                        jitter: float = 0.0, jitter_seed: int = 0,
                        codec: str = "none",
                        error_feedback: bool = False,
                        fault_model: str = "none", churn_rate: float = 0.0,
                        worker_bw_skew: float = 0.0,
                        fault_seed: int = 0,
                        fabric: str = "none",
                        oversubscription: float = 1.0,
                        link_profile: str | LinkProfile = "none"
                        ) -> List[SimResult]:
    """Multiple jobs sharing one physical link (fair-share contention).

    Each timeline is an independent training job running the same ring
    collective over the *same* link: concurrent flows split the effective
    bandwidth evenly (progressive filling).  Returns one
    :class:`SimResult` per job; with a single timeline this degenerates to
    :func:`simulate` (ring topology).

    ``n_rails``/``rail_policy`` split the shared link into rails exactly
    as in :func:`simulate` — contention then happens per rail.  With
    ``jitter`` on, each job straggles independently (job ``j`` draws from
    stream ``j`` of ``jitter_seed``), so co-located jobs do not flush in
    lockstep.  ``codec``/``error_feedback`` price gradient compression
    exactly as in :func:`simulate`; each job encodes on its own GPU, so
    the encode chain embedded in the cloned flows is per job.  The fault
    axes (``fault_model``/``churn_rate``/``worker_bw_skew``/``fault_seed``,
    see :func:`simulate`) apply per job on the jitter streams' numbering
    (job ``j`` draws from fault stream ``j``), and churn events carry the
    job's name so a dropout only tears down its own fleet.

    ``fabric``/``oversubscription`` (see :func:`simulate`) put every job
    on the same NIC -> ToR-uplink route: co-located jobs striped over the
    same racks contend for the uplink too, and the engine's max-min solve
    arbitrates both links at once.  ``fabric="none"`` and the elided 1:1
    case stay bitwise identical to the flat shared link.

    ``link_profile`` (see :func:`simulate`) degrades the shared link for
    every job at once: the deterministic pricing rides the shared
    lowering (so relabeled clones stay bit-identical to fresh lowerings)
    and each job draws its own RTO stalls from fault stream ``j``.
    """
    comm = comm or CommConfig()
    addest = addest or AddEst.v100()
    tr = get_transport(transport) if isinstance(transport, str) else transport
    eff_bw = tr.effective(bandwidth)
    sched = canonical_scheduler(scheduler or comm.scheduler)
    k = n_chunks if n_chunks is not None else comm.sched_chunks
    n_rails = max(int(n_rails), 1)      # 0 and 1 both mean "no rails"
    policy, resolved = _resolve_codec(codec, compression_ratio,
                                      error_feedback)
    free = resolved.is_free and policy == "uniform"
    fm = parse_fault_model(fault_model, churn_rate=churn_rate,
                           bw_skew=worker_bw_skew)
    fault = None if fm.is_null else fm
    lp = parse_link_profile(link_profile)
    lpr = None if lp.is_null else lp
    fab = resolve_fabric(fabric, oversubscription)
    fpath = fab.path("ring") if fab is not None else ()
    if len(fpath) <= 1:
        fpath = ()
    fcaps = fab.capacities() if fab is not None and fpath else None
    if fpath and n_rails > 1:
        raise ValueError("fabric paths and multi-rail links are mutually "
                         "exclusive (rails split the NIC, the fabric the "
                         "spine)")
    cost = RingAllReduce(n_workers, eff_bw, addest,
                         resolved.wire_ratio if free else 1.0)
    codec_cost = None if free else RingAllReduce(n_workers, eff_bw, addest,
                                                 resolved.wire_ratio)

    # co-located jobs usually share one timeline object ([tl] * n_jobs):
    # lower it once and relabel per job (FlowBatch.relabel / clone_flows is
    # bit-identical to a fresh lowering), so an n-job cell costs one
    # lowering, not n.  Plans are built first so the columnar-vs-tuple
    # decision can see the cell's total flow count.
    lowered: dict = {}
    meta = []
    total_ops = 0
    for tl in timelines:
        got = lowered.get(id(tl))
        if got is None:
            buckets = fuse_buckets(tl, comm)
            plan = lower_buckets([(b.flush_time, b.size, b.n_tensors)
                                  for b in buckets], scheduler=sched,
                                 n_chunks=k)
            plan = assign_rails(plan, n_rails, rail_policy)
            codecs = None
            if not free:
                plan = assign_codec(plan, resolved.name, policy=policy)
                codecs = _codec_lowerings(plan, resolved, cost, codec_cost)
            got = lowered[id(tl)] = [buckets, plan, codecs, None, None]
        meta.append(got)
        total_ops += len(got[1].ops)

    # the whole cell goes columnar (lower once, relabel + jitter the
    # columns, one run_batch) when its combined flow count clears the
    # engine's small-plan threshold; small cells keep the tuple path and
    # its list-based setup.  REPRO_SIM_FASTPATH=0 forces the tuple path.
    use_batch = (_fastpath_enabled()
                 and total_ops >= _ev._SMALL_PLAN_MAX_FLOWS)
    rails = {DEFAULT_LINK: n_rails} if n_rails > 1 else None
    base = 0
    counts = []
    churn_all: list = []
    if use_batch:
        parts: List[FlowBatch] = []
        for j, got in enumerate(meta):
            if got[3] is None:
                got[3] = plan_to_flow_batch(got[1], cost,
                                            tr.per_tensor_overhead,
                                            op_id_base=0, n_rails=n_rails,
                                            codecs=got[2],
                                            link_profile=lpr)
            bj = got[3].relabel(base, f"job{j}")
            if jitter > 0.0:
                bj = perturb_batch(bj, jitter, jitter_seed, stream=j)
            if fault is not None and bj.n:
                if got[4] is None:
                    got[4] = worker_codes(got[1], n_workers)
                bj = apply_faults_batch(bj, got[4], fault, n_workers,
                                        fault_seed, j)
                churn_all.extend(churn_events(
                    fault, n_workers,
                    _fault_horizon(bj.ready, bj.work, bj.latency),
                    fault_seed, j, job=f"job{j}"))
            if lpr is not None and bj.n:
                churn_all.extend(retx_events(
                    lpr, sum(op.size for op in got[1].ops),
                    _fault_horizon(bj.ready, bj.work, bj.latency),
                    fault_seed, j, job=f"job{j}"))
            base += bj.n
            counts.append(bj.n)
            parts.append(bj)
        cell = concat_batches(parts)
        if fpath:
            rb = run_flow_batch(cell.with_path(fpath), capacities=fcaps,
                                churn=churn_all or None)
        else:
            rb = run_flow_batch(cell, rails=rails,
                                churn=churn_all or None)
    else:
        all_flows: List[FlowSpec] = []
        for j, got in enumerate(meta):
            if got[3] is None:
                got[3] = plan_to_flows(got[1], cost, tr.per_tensor_overhead,
                                       op_id_base=0, n_rails=n_rails,
                                       codecs=got[2], link_profile=lpr)
            flows = clone_flows(got[3], base, f"job{j}")
            if jitter > 0.0:
                flows = perturb_flows(flows, jitter, jitter_seed, stream=j)
            if fault is not None and flows:
                if got[4] is None:
                    got[4] = worker_codes(got[1], n_workers)
                flows = apply_faults_flows(flows, got[4], fault, n_workers,
                                           fault_seed, j)
                churn_all.extend(churn_events(
                    fault, n_workers,
                    _fault_horizon(np.array([f.ready for f in flows]),
                                   np.array([f.work for f in flows]),
                                   np.array([f.latency for f in flows])),
                    fault_seed, j, job=f"job{j}"))
            if lpr is not None and flows:
                churn_all.extend(retx_events(
                    lpr, sum(op.size for op in got[1].ops),
                    _fault_horizon(np.array([f.ready for f in flows]),
                                   np.array([f.work for f in flows]),
                                   np.array([f.latency for f in flows])),
                    fault_seed, j, job=f"job{j}"))
            base += len(flows)
            counts.append(len(flows))
            all_flows.extend(flows)
        if fpath:
            all_flows = [f._replace(path=fpath) for f in all_flows]
            results = run_flows(all_flows, capacities=fcaps,
                                churn=churn_all or None)
        else:
            results = run_flows(all_flows, rails=rails,
                                churn=churn_all or None)

    out: List[SimResult] = []
    pos = 0
    for j, got in enumerate(meta):
        tl = timelines[j]
        buckets, plan, codecs = got[0], got[1], got[2]
        n_flows = counts[j]
        if use_batch:
            sub = ResultBatch(rb.op_id[pos:pos + n_flows], rb.jobs,
                              rb.job[pos:pos + n_flows],
                              rb.start[pos:pos + n_flows],
                              rb.wire_end[pos:pos + n_flows],
                              rb.end[pos:pos + n_flows],
                              rb.contended[pos:pos + n_flows])
            served, t_sync, busy = _serve_from_batch(plan, buckets, sub)
        else:
            served, t_sync, busy = _serve_plan(
                plan, buckets, cost, tr, results=results[pos:pos + n_flows])
        pos += n_flows
        if not served:
            t_sync = tl.t_back
        t_overhead = max(0.0, t_sync - tl.t_back)
        if codecs is None:
            wire = sum(cost.wire_bytes(b.size) for b in served)
        else:
            wire = sum(codecs[op.codec].cost.wire_bytes(op.size)
                       for op in plan.ops)
        util = ((wire / busy) / (bandwidth / n_rails)
                if busy > 0 else 0.0)
        out.append(SimResult(
            name=tl.name, n_workers=n_workers, bandwidth=bandwidth,
            effective_bw=eff_bw, t_batch=tl.t_batch, t_back=tl.t_back,
            t_sync=t_sync, t_overhead=t_overhead,
            scaling_factor=tl.t_batch / (tl.t_batch + t_overhead),
            buckets=tuple(served), wire_bytes_per_worker=wire,
            network_utilization=min(util, 1.0), scheduler=sched,
            codec=codec,
            codec_compute_s=codec_compute_seconds(plan, codecs)))
    return out
