"""Seeded worker-level fault models: correlated slowdowns, churn, bw skew.

The paper's scaling-factor analysis assumes a well-behaved cluster: every
worker flushes on time and membership is static, so the only overhead is
network contention.  Real fleets are not like that — Hivemind-style
training runs on unreliable mixed GPUs, and system-level effects decide
whether communication optimizations pay off at all.  This module prices
three ways a fleet misbehaves, all seeded and deterministic:

- **worker-correlated slowdowns** — one straggling worker delays *every*
  flow of its iteration by the same exponential draw, unlike the
  per-flow-independent jitter axis.  ``correlation`` interpolates: 1 is
  fully worker-correlated, 0 reduces *bitwise* to the existing per-flow
  jitter (same RNG stream, same ``jitter * Exp(1)`` arithmetic);
- **churn** — workers drop out and rejoin mid-iteration.  A dropout
  tears down the in-flight transfer (it restarts after a priced
  re-bucketing stall) and cancels the dead worker's pending flows (the
  re-formed collective skips its buckets this iteration); a rejoin costs
  another stall.  Arrival counts are Poisson in ``churn_rate`` (expected
  membership changes per iteration), times uniform over the iteration.
  Under a fabric lowering (multi-link :attr:`FlowSpec.path`), the
  teardown releases the flow's share on *every* link of its path at
  once — the max-min rate vector is re-solved without it, so survivors
  speed up on the freed uplink immediately;
- **asymmetric bandwidth** — each worker's effective link rate is scaled
  by ``1 + bw_skew * Exp(1)``, so its flows carry proportionally more
  wire work (a factor of 1 everywhere at ``bw_skew=0``).

Worker attribution is structural, not random: bucket ``b`` belongs to
worker ``b % n_workers`` (:func:`worker_codes`), so the same buckets
straggle together across seeds and the axis composes deterministically
with every scheduler/rails/codec axis.

Determinism contract (shared with :func:`repro_torch.core.events.jitter_delays`
via :func:`repro_torch.core.events._jitter_stream`): every draw depends only on
``(fault_seed, stream, substream, n)`` — never process, thread, or global
RNG state — so artifacts are bit-identical across executors.  Substreams:
``()`` per-flow component, ``(1,)`` worker slowdowns, ``(2,)`` bandwidth
factors, ``(3,)`` churn arrivals.  A null model
(:attr:`FaultModel.is_null`) must never touch a flow: the simulator
bypasses this module entirely, keeping zero-fault configs bit-identical
to the pre-fault engine.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.events import (ChurnEvent, FlowBatch, FlowSpec,
                               _jitter_stream, jitter_delays)

__all__ = [
    "FaultModel", "parse_fault_model", "worker_codes", "fault_delays",
    "bw_factors", "churn_events", "apply_faults_batch", "apply_faults_flows",
]


@dataclass(frozen=True)
class FaultModel:
    """One unreliable-world scenario, fully determined by its fields + seed.

    ``slowdown`` is the mean extra delay (seconds) a worker's iteration
    suffers; ``correlation`` is the worker-vs-flow mix (see module doc);
    ``churn_rate`` the expected dropout events per iteration; ``downtime``
    the mean seconds before a dropped worker rejoins; ``rebucket`` the
    stall (seconds) every membership change costs the survivors;
    ``bw_skew`` the per-worker bandwidth asymmetry scale.
    """

    slowdown: float = 0.0
    correlation: float = 1.0
    churn_rate: float = 0.0
    downtime: float = 0.010
    rebucket: float = 0.005
    bw_skew: float = 0.0

    @property
    def is_null(self) -> bool:
        """True when no fault mechanism is active (the bit-exact bypass)."""
        return (self.slowdown <= 0.0 and self.churn_rate <= 0.0
                and self.bw_skew <= 0.0)


NULL_FAULTS = FaultModel()


def parse_fault_model(spec: str, *, churn_rate: float = 0.0,
                      bw_skew: float = 0.0, downtime: float = 0.010,
                      rebucket: float = 0.005) -> FaultModel:
    """Parse the experiment axis string into a :class:`FaultModel`.

    ``"none"`` means no slowdown; ``"slowdown:<ms>[:<rho>]"`` sets the
    mean worker slowdown in *milliseconds* (axis strings stay unit-tagged
    and short) with an optional correlation ``rho`` in [0, 1] (default 1,
    fully worker-correlated).  ``churn_rate``/``bw_skew`` ride along from
    their own cell axes.
    """
    s = spec.strip().lower()
    if s in ("", "none"):
        return FaultModel(churn_rate=churn_rate, bw_skew=bw_skew,
                          downtime=downtime, rebucket=rebucket)
    parts = s.split(":")
    if parts[0] != "slowdown" or len(parts) not in (2, 3):
        raise ValueError(
            f"unknown fault model {spec!r} (expected 'none' or "
            f"'slowdown:<ms>[:<rho>]')")
    ms = float(parts[1])
    rho = float(parts[2]) if len(parts) == 3 else 1.0
    if not 0.0 <= rho <= 1.0:
        raise ValueError(f"fault correlation {rho} outside [0, 1] in {spec!r}")
    return FaultModel(slowdown=ms / 1e3, correlation=rho,
                      churn_rate=churn_rate, bw_skew=bw_skew,
                      downtime=downtime, rebucket=rebucket)


def worker_codes(plan, n_workers: int) -> np.ndarray:
    """Owning worker per plan op: bucket ``b`` belongs to worker ``b % n``.

    Plan order equals flow order in both lowerings (``plan_to_flows``
    and ``plan_to_flow_batch`` iterate ``plan.ops``), so the codes align
    with the lowered flows by position.
    """
    n = max(int(n_workers), 1)
    return np.fromiter((op.bucket_id for op in plan.ops),
                       dtype=np.intp, count=len(plan.ops)) % n


def fault_delays(fm: FaultModel, codes: np.ndarray, n_workers: int,
                 seed: int, stream: int = 0) -> Optional[np.ndarray]:
    """Per-flow ready-time delays, or None when ``slowdown <= 0``.

    ``rho * E[worker] + (1 - rho) * F[flow]``, scaled by ``slowdown``:
    at ``rho >= 1`` every flow of a worker shares one draw (the
    correlated straggler); at ``rho <= 0`` the expression collapses to
    :func:`repro_torch.core.events.jitter_delays` — the *same* stream and the
    same single multiply, so correlation 0 is bitwise the per-flow jitter
    axis, not merely statistically equivalent.  Linear in ``slowdown``
    with shared draws, so a swept slowdown scale moves every ready time
    monotonically.
    """
    if fm.slowdown <= 0.0:
        return None
    n = int(codes.shape[0])
    rho = min(max(fm.correlation, 0.0), 1.0)
    if rho <= 0.0:
        return jitter_delays(n, fm.slowdown, seed, stream)
    nw = max(int(n_workers), 1)
    ew = _jitter_stream(seed, stream, 1).standard_exponential(nw)
    if rho >= 1.0:
        return fm.slowdown * ew[codes]
    fl = _jitter_stream(seed, stream).standard_exponential(n)
    return fm.slowdown * (rho * ew[codes] + (1.0 - rho) * fl)


def bw_factors(fm: FaultModel, n_workers: int, seed: int,
               stream: int = 0) -> Optional[np.ndarray]:
    """Per-worker wire-work multipliers, or None when ``bw_skew <= 0``.

    ``1 + bw_skew * Exp(1)`` per worker: a factor of exactly 1.0 means
    the nominal link rate; larger factors model the straggling NICs /
    oversubscribed hosts whose transfers take proportionally longer.
    """
    if fm.bw_skew <= 0.0:
        return None
    nw = max(int(n_workers), 1)
    return 1.0 + fm.bw_skew * _jitter_stream(
        seed, stream, 2).standard_exponential(nw)


def churn_events(fm: FaultModel, n_workers: int, horizon: float,
                 seed: int, stream: int = 0,
                 job: str = "job0") -> List[ChurnEvent]:
    """Draw the iteration's membership changes from the churn substream.

    ``Poisson(churn_rate)`` dropouts, each at a uniform time in
    ``[0, horizon)`` hitting a uniform worker, down for an exponential
    ``downtime`` before rejoining; both the drop and the rejoin cost the
    ``rebucket`` stall.  Returns events sorted by time (possibly empty —
    an empty list must leave the engine dispatch untouched).
    """
    if fm.churn_rate <= 0.0:
        return []
    rng = _jitter_stream(seed, stream, 3)
    k = int(rng.poisson(fm.churn_rate))
    if not k:
        return []
    nw = max(int(n_workers), 1)
    times = horizon * rng.random(k)
    workers = rng.integers(0, nw, size=k)
    downs = fm.downtime * rng.standard_exponential(k)
    out: List[ChurnEvent] = []
    for t, w, d in zip(times.tolist(), workers.tolist(), downs.tolist()):
        out.append(ChurnEvent(t=t, job=job, kind="drop", worker=int(w),
                              stall=fm.rebucket))
        out.append(ChurnEvent(t=t + d, job=job, kind="rejoin", worker=-1,
                              stall=fm.rebucket))
    out.sort()
    return out


def apply_faults_batch(batch: FlowBatch, codes: np.ndarray, fm: FaultModel,
                       n_workers: int, seed: int,
                       stream: int = 0) -> FlowBatch:
    """Stamp worker codes and apply slowdown delays + bw skew, columnar.

    Ready times gain :func:`fault_delays`; wire work of a skewed worker's
    flows is multiplied by its :func:`bw_factors` entry, with ``duration``
    adjusted by the same work delta so hold flows stay internally
    consistent (NaN durations propagate untouched).  All elementwise
    float64 — the scalar twin :func:`apply_faults_flows` performs the
    identical operations, so both lowering paths stay bit-identical.
    """
    out = batch._replace(worker=np.asarray(codes, dtype=np.intp))
    d = fault_delays(fm, codes, n_workers, seed, stream)
    if d is not None:
        out = out._replace(ready=out.ready + d)
    fac = bw_factors(fm, n_workers, seed, stream)
    if fac is not None:
        m = fac[codes]
        new_work = out.work * m
        out = out._replace(work=new_work,
                           duration=out.duration + (new_work - out.work))
    return out


def apply_faults_flows(flows: Sequence[FlowSpec], codes: np.ndarray,
                       fm: FaultModel, n_workers: int, seed: int,
                       stream: int = 0) -> List[FlowSpec]:
    """Tuple-path twin of :func:`apply_faults_batch`, bit-identical.

    The draws are the same numpy arrays; application is per-flow scalar
    float64 arithmetic, which matches the columnar elementwise ops
    bit-for-bit.
    """
    d = fault_delays(fm, codes, n_workers, seed, stream)
    fac = bw_factors(fm, n_workers, seed, stream)
    code_l = codes.tolist()
    d_l = d.tolist() if d is not None else None
    out: List[FlowSpec] = []
    for i, f in enumerate(flows):
        c = code_l[i]
        rdy = f.ready + d_l[i] if d_l is not None else f.ready
        wk = f.work
        du = f.duration
        if fac is not None:
            nw_ = f.work * float(fac[c])
            if du is not None:
                du = du + (nw_ - wk)
            wk = nw_
        out.append(f._replace(ready=rdy, work=wk, duration=du, worker=c))
    return out
