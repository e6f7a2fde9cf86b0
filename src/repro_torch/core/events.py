"""Discrete-event network engine: link resources with fair-share bandwidth.

The serialized bucket loop the simulator used to hard-code is one point in
a much larger scheduling space.  This engine executes *flows* — wire
transfers with a fixed post-wire latency (the reduction/vector-add phase of
a collective) — against named link resources:

- **links** split their bandwidth fairly among concurrent flows (progressive
  filling: each of the k active flows progresses at 1/k of full rate), which
  is what makes multi-job contention expressible;
- **jobs** serialize their own flows (one wire in flight per job): a ring
  all-reduce occupies the full NIC, so intra-job concurrency happens at
  chunk granularity via the scheduler that *ordered* the flows, not via the
  link;
- a job admits its highest-priority ready flow whenever it is free; a flow
  with ``hold=True`` keeps the job busy through its latency (Horovod's
  serialized all-reduce process), otherwise the job frees at wire end and
  the latency overlaps the next flow's transmission (pipelined chunks).

Exactness: a ``hold`` flow whose wire phase never shared its link completes
at ``start + duration`` with ``duration`` precomputed by the caller as a
single float expression — so the ``fifo`` schedule reproduces the legacy
serialized loop bit-for-bit, not just within tolerance.  A flow counts as
``contended`` only if it shared its link for a *nonzero* duration; the seed
engine also flagged zero-duration overlaps (two flows co-admitted at an
instant where one has zero residual work), which changed no completion time
beyond re-rounding but cosmetically dropped the closed form.

Times in seconds; ``work`` is wire time at full link rate (the caller bakes
bandwidth into it via the cost model).

Engine architecture (the O((n+e) log n) event calendar)
-------------------------------------------------------

The seed implementation rescanned every pending/running flow at every event
and advanced all wires step by step — quadratic once plans reach thousands
of flows.  This version is indexed end to end:

- **per-job admission state**: flows sort once into service order
  ``(priority, op_id)``.  When ready times are non-decreasing along that
  order (fifo/chunked plans), the next admissible flow is a pointer
  increment; otherwise (priority plans, where late-flushed buckets preempt)
  the job keeps a ready-time heap of *gated* flows plus a priority heap of
  admissible ones, so an admission is O(log n) instead of a rescan.
- **per-link fluid service clocks**: all flows on a link progress at the
  same fair share, so in link-service time a flow admitted when the link
  had delivered ``S`` per-flow seconds completes at exactly ``S + work`` —
  a *static* order.  Each link keeps a heap of these completion marks;
  membership changes rescale only the rate at which the clock advances,
  never the order, so projections are recomputed only when a link's
  membership (and hence share) changes, and only for the heap top.
- **versioned calendar entries**: the global ``heapq`` calendar holds each
  link's next projected completion stamped with the link's membership
  version, plus per-job admission triggers.  A membership change bumps the
  version; stale entries are lazily discarded on pop rather than searched
  for and removed.
- **completion spin + bulk commit**: when a link's next completion precedes
  everything else on the calendar, completions are served in a tight loop
  without calendar round-trips; and while membership is *constant* (every
  completion instantly re-admits the job's next flow), each job's future
  completion marks are plain prefix sums of its works, so whole saturated
  stretches are computed with vectorized numpy cumulative sums and
  committed in one pass, up to the first membership-changing boundary
  (ready gate, ``hold`` flow, job exhaustion, or calendar interrupt).
  Completion *times* for the merged stretch are produced by the same
  chained left fold the scalar spin performs — one ``np.cumsum`` over the
  per-step deltas of the (mark, flow)-sorted merge of every job's chain —
  so bulk-committed results are **bit-identical** to the scalar event
  loop, not merely within tolerance.
- **heap-mode resolved prefix**: a priority-scheduled job (ready times
  regress along service order) cannot expose a pointer chain, but its
  *ready frontier* is still a resolved sequence: sorting the admissible
  heap by ``(priority, op_id)`` yields exactly the order the scalar loop
  would pop, valid until the next gated flow's ready time (the *gating
  boundary*) is crossed.  Heap-mode jobs therefore contribute that sorted
  prefix to the bulk chain decomposition, with the gating boundary folded
  into the job's violation point; the sorted suffix left after a commit
  is itself a valid heap, so no re-heapify is needed.
- **multi-link bulk window**: when the spin attempts a bulk commit, other
  links' *valid* projected completions at the front of the calendar would
  artificially fence the window at the first foreign event.  If such a
  link is itself bulk-eligible and **self-contained** (every job in its
  heap runs all of its flows on that link, so nothing it commits can
  admit work elsewhere), its calendar entry is parked, the window extends
  to the first non-parkable event, and each parked link retires its own
  saturated stretch against the same fence — one window, all eligible
  links.  A parked link's first completion uses the exact time its
  calendar entry carried, so the arithmetic is the scalar loop's.
- **small-plan setup**: the columnar numpy views that pay for themselves on
  thousand-flow plans cost more than the whole event loop on the two-dozen-
  op plans the paper grids generate, so below
  :data:`_SMALL_PLAN_MAX_FLOWS` the setup runs on plain lists and the bulk
  commit (which needs the arrays, and can never engage on single-job plans
  anyway) is skipped.  The scalar event loop is identical either way, so
  single-job results are bit-identical across the two setups.

Termination is progress-based: the engine raises only when the calendar
drains with flows outstanding, or when event processing stops advancing
time, admitting, or completing — not on an iteration-count heuristic, which
could false-trip on heavily contended multi-job plans.

Columnar batches (structure-of-arrays end to end)
-------------------------------------------------

:class:`FlowBatch` is the columnar twin of a ``FlowSpec`` list: one numpy
record batch (float64 ``ready``/``work``/``latency``/``priority``/
``duration`` columns, a bool ``hold`` column, ``intp`` ``op_id``/``rail``
columns, and *interned* job/link name tables with ``intp`` code columns).
``NetworkEngine.run_batch`` consumes it directly — the large-plan setup
becomes one global lexsort plus per-job column slices, with no tuple
materialization on either side (results come back as a
:class:`ResultBatch`).  The glue is O(columns), not O(flows):

- :meth:`FlowBatch.relabel` replaces ``schedule.clone_flows`` — a
  contention cell relabels the shared lowering per job by rewriting the
  interned *name table* and shifting ``op_id``; every float column is the
  same array object;
- :func:`perturb_batch` replaces :func:`perturb_flows` — the same RNG
  stream, one vectorized ``ready + delays`` (elementwise float64 adds are
  the scalar adds, so jittered batches are bit-identical to the tuple
  path);
- :func:`concat_batches` merges per-job batches for one engine call,
  re-interning names in first-appearance order.

The name tables preserve **first-appearance order** by construction
(interning, relabeling, and concatenation all keep it), which is what
makes the columnar setup's calendar insertion order — and therefore every
same-time admission tie-break — identical to the tuple path's.  Plans
below :data:`_SMALL_PLAN_MAX_FLOWS` bounce to the list path unchanged.
``run(flows)`` above the threshold routes through the same batch core, so
there is exactly one large-plan engine.

Multi-rail links
----------------

A physical NIC with ``r`` rails is ``r`` independent fluid links that
happen to share a name: ``NetworkEngine(rails={"nic": r})`` turns the named
link into a :class:`_LinkSet` of ``r`` per-rail service clocks, and each
flow's ``rail`` field selects which clock serves it (rail selection is part
of the *plan* — see :func:`repro_torch.core.schedule.assign_rails` — so the
engine stays deterministic and a one-rail plan is bit-exact with a plain
link).  Rails do not fair-share with each other: contention is per rail,
which is exactly what distinguishes a 2x50G multi-rail host from a single
100G NIC.  The caller models per-rail bandwidth by scaling ``work`` (see
``plan_to_flows(..., n_rails=...)``).
"""
from __future__ import annotations

from heapq import heapify, heappop, heappush
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

DEFAULT_LINK = "nic"
DEFAULT_JOB = "job0"

# calendar event kinds: completions sort first at a tie, then faults (a
# completion landing exactly at a fault instant still completes), then
# admissions (a fault precedes any same-time admission it should gate),
# then retransmission timeouts (a same-time admission is admitted first
# and then pulled back — the segment was already in flight when it timed
# out).  _RETX shares _FAULT's handler: pull-back + stall, no worker
# cancellation (ChurnEvent kind "retx" never matches the "drop" gate).
_DONE, _FAULT, _ADMIT, _RETX = 0, 1, 2, 3
_INF = float("inf")
_NAN = float("nan")


class FlowSpec(NamedTuple):
    """One wire transfer plus a fixed post-wire latency.

    The engine's unit of work: the schedule layer lowers every
    :class:`~repro_torch.core.schedule.CommOp` to exactly one ``FlowSpec``.

    - ``op_id`` identifies the flow in results (results come back in input
      order, but ``op_id`` survives any caller-side regrouping);
    - ``ready`` is the earliest admission time (the bucket's flush time,
      possibly perturbed by :func:`perturb_flows`);
    - ``work`` is wire seconds *at full link rate* — the caller bakes
      bandwidth into it via the cost model, so a rail at 1/n of the
      aggregate bandwidth simply carries ``n`` times the work;
    - ``latency`` is the fixed post-wire phase (vector adds + negotiation)
      that does not scale under link sharing;
    - ``priority`` orders admission within a job (smaller first; ties broken
      by ``op_id``);
    - ``job`` names the serialization resource (one wire in flight per job);
    - ``link``/``rail`` name the bandwidth resource: ``rail`` selects the
      per-rail service clock when the engine was built with
      ``rails={link: n}``, and is ignored (must be 0) otherwise;
    - ``hold`` keeps the job busy through the latency (Horovod's serialized
      all-reduce); ``duration``, when given, must equal ``work + latency``
      up to the caller's own float rounding — it is used verbatim for the
      closed-form uncontended completion of ``hold`` flows, which is what
      makes the fifo schedule bit-exact with the legacy serialized loop;
    - ``worker`` attributes the flow to a physical worker for the fault
      layer (:mod:`repro_torch.core.faults`): a :class:`ChurnEvent` dropping
      worker ``w`` cancels the job's pending flows with ``worker == w``.
      Ignored unless the engine runs with churn events.
    - ``path``, when non-empty, is the tuple of link ids the flow
      traverses (host NIC -> ToR uplink -> ...); the flow progresses at
      its bottleneck **max-min fair share** across all of them
      (progressive filling — see :meth:`NetworkEngine._run_maxmin`).  A
      link id repeated ``m`` times encodes demand multiplicity: the flow
      consumes ``m`` units of that link's capacity per unit of rate (a
      rack uplink crossed by every host of the rack).  An empty path
      means "use ``link``" — today's single-resource semantics, and a
      one-element path is normalized to exactly that, so any plan whose
      paths all have length <= 1 runs the original engine bit-for-bit.
    """

    op_id: int
    ready: float                     # earliest admission time
    work: float                      # wire seconds at full link rate
    latency: float = 0.0             # fixed post-wire time (reduction etc.)
    priority: float = 0.0
    job: str = DEFAULT_JOB
    link: str = DEFAULT_LINK
    hold: bool = False               # job held busy through the latency
    duration: Optional[float] = None  # precomputed work+latency (hold flows)
    rail: int = 0                    # which rail of a multi-rail link
    worker: int = 0                  # owning worker (fault attribution)
    path: Tuple[str, ...] = ()       # multi-link route (empty: use ``link``)


class FlowResult(NamedTuple):
    """Execution record of one flow, in the input list's order.

    ``start`` is the admission time (wire begins), ``wire_end`` when the
    link was released, ``end`` when the post-wire latency finished.
    ``contended`` is True only if the wire phase shared its link (or rail)
    for a *nonzero* duration — uncontended flows take exact closed forms,
    so ``start + work == wire_end`` bit-for-bit.
    """

    op_id: int
    job: str
    start: float                     # admission (wire begins)
    wire_end: float                  # link released
    end: float                       # wire + latency complete
    contended: bool                  # wire phase ever shared its link

    @property
    def occupancy(self) -> float:
        """Time this flow kept its serialization resource busy."""
        return self.end - self.start


class ChurnEvent(NamedTuple):
    """One membership change of a job's worker fleet, at engine level.

    ``kind == "drop"``: at time ``t`` worker ``worker`` leaves the fleet —
    the job's in-flight flow (whoever owns it) is pulled back to restart
    after the re-bucketing stall, and every pending flow with a matching
    ``FlowSpec.worker`` is cancelled (it completes trivially at ``t``:
    the re-formed collective skips the dead worker's buckets this
    iteration).  ``kind == "rejoin"``: the worker comes back — only the
    pull-back and the stall apply (its cancelled flows stay cancelled;
    re-admission costs, not recovered work, are the priced quantity).
    ``kind == "retx"``: a retransmission timeout on a lossy link
    (:func:`repro_torch.core.transport.retx_events`) — pull-back + stall like a
    rejoin, lowered onto its own ``_RETX`` calendar kind so a timeout at
    an admission instant fires *after* the admission it interrupts.
    ``stall`` is the re-bucketing/remap cost (for ``retx``: the backoff
    ``timeout * backoff**k``): the job admits nothing before
    ``t + stall``.  ``job`` matches the flow's job name exactly or
    as a rail-lane prefix (``job0`` also hits ``job0@r1``).  Events are
    plain data — :func:`repro_torch.core.faults.churn_events` draws them from
    the seeded fault stream.
    """

    t: float
    job: str
    kind: str                        # "drop" | "rejoin"
    worker: int = -1                 # dropped worker (-1: no cancellation)
    stall: float = 0.0               # re-bucketing stall, seconds


def _jitter_stream(seed: int, stream: int, *extra: int) -> np.random.Generator:
    """The engine-wide perturbation RNG: ``(seed, stream[, substream])``.

    One construction shared by every stochastic scenario axis (per-flow
    jitter, correlated fault delays, bandwidth skew, churn arrivals), so
    the determinism contract — draws depend only on the explicit key,
    never on process/thread/global state — holds everywhere by
    construction.  ``extra`` selects an independent substream for draws
    that must not consume the base stream (worker-level draws, churn
    arrivals); the bare ``(seed, stream)`` stream is the one
    :func:`perturb_flows` has always used.
    """
    return np.random.default_rng(np.random.SeedSequence(
        entropy=int(seed), spawn_key=(int(stream), *map(int, extra))))


def jitter_delays(n: int, jitter: float, seed: int,
                  stream: int = 0) -> np.ndarray:
    """The independent-jitter draws: ``jitter * Exp(1)`` per flow.

    Depends only on ``(seed, stream, n)`` and scales linearly in
    ``jitter`` (same draws, scaled) — the contract both perturb
    functions and the fault model's ``correlation=0`` mode share.
    """
    return jitter * _jitter_stream(seed, stream).standard_exponential(n)


def perturb_flows(flows: Sequence[FlowSpec], jitter: float, seed: int,
                  stream: int = 0) -> List[FlowSpec]:
    """Seeded straggler model: delay every flow's ``ready`` time.

    Each flow's flush is pushed back by an independent exponential draw
    with mean ``jitter`` seconds — the long-tailed per-flow perturbation
    that models slow workers, GC pauses, and negotiation stalls jittering
    bucket flush times.  Determinism contract:

    - the draws depend only on ``(seed, stream, len(flows))`` — never on
      process, thread, or global RNG state — so artifacts are bit-identical
      across executors (``stream`` separates jobs in a contention scenario
      so co-located jobs straggle independently);
    - with a fixed seed the delays scale *linearly* in ``jitter``
      (``jitter * standard_exponential``), so a swept jitter axis moves
      every ready time monotonically — the straggler grid's
      ``t_sync`` monotonicity validator rests on this;
    - ``jitter <= 0`` returns the flows unchanged (same objects), keeping
      the zero-jitter path bit-exact with a run that never heard of jitter.

    :func:`perturb_batch` is the columnar twin: same RNG construction,
    same float adds, bit-identical ready times.
    """
    if jitter <= 0.0 or not flows:
        return list(flows)
    delays = jitter_delays(len(flows), jitter, seed, stream).tolist()
    return [f._replace(ready=f.ready + d) for f, d in zip(flows, delays)]


# ---------------------------------------------------------------------------
# columnar batches: structure-of-arrays flows and results
# ---------------------------------------------------------------------------

def _intern(names: Sequence[str]) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Name column -> (first-appearance-ordered table, intp code column)."""
    table: Dict[str, int] = {}
    codes = np.empty(len(names), dtype=np.intp)
    for i, nm in enumerate(names):
        c = table.get(nm)
        if c is None:
            c = table[nm] = len(table)
        codes[i] = c
    return tuple(table), codes


class FlowBatch(NamedTuple):
    """A columnar batch of flows: the structure-of-arrays ``FlowSpec`` list.

    Float columns are float64 (``duration`` holds NaN where a ``FlowSpec``
    would hold ``None``); ``op_id``/``rail`` are ``intp``; ``job``/``link``
    are ``intp`` codes into the interned ``jobs``/``links`` name tables.
    Invariant: the name tables are in **first-appearance order** along the
    batch — every constructor here preserves it, and the engine's columnar
    setup relies on it to reproduce the tuple path's calendar insertion
    order (and therefore every same-time tie-break) exactly.

    Batches are immutable in the NamedTuple sense; ``relabel`` and
    :func:`perturb_batch` share every column they do not change (except
    the path CSR columns, which ``relabel`` deep-copies — a relabeled
    job's route must be independently mutable without leaking into the
    source batch).

    Multi-link routes are stored CSR-style: flow ``i`` traverses the
    link codes ``path_link[path_off[i]:path_off[i+1]]`` (codes into
    ``links``, repeats = demand multiplicity, exactly mirroring
    ``FlowSpec.path``).  Both columns are ``None`` when no flow in the
    batch has a path — the common case, and the representation every
    pre-fabric constructor produces.
    """

    op_id: np.ndarray
    ready: np.ndarray
    work: np.ndarray
    latency: np.ndarray
    priority: np.ndarray
    duration: np.ndarray             # NaN = no precomputed duration
    hold: np.ndarray                 # bool
    jobs: Tuple[str, ...]            # interned names, first-appearance order
    job: np.ndarray                  # intp codes into ``jobs``
    links: Tuple[str, ...]
    link: np.ndarray                 # intp codes into ``links``
    rail: np.ndarray                 # intp
    worker: np.ndarray               # intp (fault attribution)
    path_off: Optional[np.ndarray] = None   # CSR offsets (n+1) into path_link
    path_link: Optional[np.ndarray] = None  # intp codes into ``links``

    @property
    def n(self) -> int:
        return int(self.op_id.shape[0])

    @classmethod
    def from_flows(cls, flows: Sequence[FlowSpec]) -> "FlowBatch":
        """Columnarize a flow list (``None`` durations become NaN)."""
        if not flows:
            return _EMPTY_BATCH
        (op_col, rdy_col, wk_col, lt_col, pr_col, job_col, lk_col, hd_col,
         du_col, rl_col, w_col, pth_col) = zip(*flows)
        jobs, jcode = _intern(job_col)
        if any(pth_col):
            # Intern link names and path entries together, still in
            # first-appearance order along the batch (flow i contributes
            # its ``link`` then its path entries).
            table: Dict[str, int] = {}
            lcode = np.empty(len(flows), dtype=np.intp)
            plinks: List[int] = []
            path_off = np.zeros(len(flows) + 1, dtype=np.intp)
            for i, (nm, p) in enumerate(zip(lk_col, pth_col)):
                c = table.get(nm)
                if c is None:
                    c = table[nm] = len(table)
                lcode[i] = c
                for pn in p:
                    pc = table.get(pn)
                    if pc is None:
                        pc = table[pn] = len(table)
                    plinks.append(pc)
                path_off[i + 1] = len(plinks)
            links = tuple(table)
            path_link: Optional[np.ndarray] = np.asarray(plinks, dtype=np.intp)
        else:
            links, lcode = _intern(lk_col)
            path_off = path_link = None
        return cls(
            op_id=np.asarray(op_col, dtype=np.intp),
            ready=np.asarray(rdy_col, dtype=np.float64),
            work=np.asarray(wk_col, dtype=np.float64),
            latency=np.asarray(lt_col, dtype=np.float64),
            priority=np.asarray(pr_col, dtype=np.float64),
            duration=np.array([_NAN if d is None else d for d in du_col]),
            hold=np.asarray(hd_col, dtype=bool),
            jobs=jobs, job=jcode, links=links, link=lcode,
            rail=np.asarray(rl_col, dtype=np.intp),
            worker=np.asarray(w_col, dtype=np.intp),
            path_off=path_off, path_link=path_link)

    def to_flows(self) -> List[FlowSpec]:
        """Materialize the tuple view (NaN durations become ``None``)."""
        jobs, links = self.jobs, self.links
        du = [None if d != d else d for d in self.duration.tolist()]
        if self.path_link is not None and self.path_link.shape[0]:
            off = self.path_off.tolist()
            pl = [links[c] for c in self.path_link.tolist()]
            paths: List[Tuple[str, ...]] = [
                tuple(pl[off[i]:off[i + 1]]) for i in range(self.n)]
        else:
            paths = [()] * self.n
        rows = zip(self.op_id.tolist(), self.ready.tolist(),
                   self.work.tolist(), self.latency.tolist(),
                   self.priority.tolist(),
                   [jobs[c] for c in self.job.tolist()],
                   [links[c] for c in self.link.tolist()],
                   self.hold.tolist(), du, self.rail.tolist(),
                   self.worker.tolist(), paths)
        new = tuple.__new__
        return [new(FlowSpec, row) for row in rows]

    def relabel(self, op_id_base: int, job: str,
                old_job: str = DEFAULT_JOB) -> "FlowBatch":
        """O(names) relabel for another identical co-located job.

        The columnar twin of :func:`repro_torch.core.schedule.clone_flows`:
        rewrites the interned job-name table (``old_job`` prefix ->
        ``job``, covering the rail lanes ``old_job@r<k>``) and shifts
        ``op_id``; every float column is shared, so an n-job contention
        cell pays one lowering and n column relabels.  ``op_id_base == 0``
        with ``job == old_job`` returns ``self``.
        """
        if op_id_base == 0 and job == old_job:
            return self
        shift = len(old_job)
        jobs = tuple(job + nm[shift:] if nm.startswith(old_job) else nm
                     for nm in self.jobs)
        # Copy the path CSR columns rather than aliasing them: relabeled
        # batches model *other* jobs, and an in-place route edit on the
        # clone (re-homing a job to a different uplink) must never leak
        # into the source batch the way a shared ``ready`` column would.
        path_off = None if self.path_off is None else self.path_off.copy()
        path_link = None if self.path_link is None else self.path_link.copy()
        return self._replace(op_id=self.op_id + op_id_base, jobs=jobs,
                             path_off=path_off, path_link=path_link)

    def with_path(self, path: Tuple[str, ...]) -> "FlowBatch":
        """Stamp one shared multi-link route on every flow of the batch.

        Extends the interned ``links`` table with any new names (appended
        after the existing entries, preserving first-appearance order for
        the single-link columns) and builds the uniform CSR columns.  An
        empty ``path`` clears the route columns instead.
        """
        if not path:
            return self._replace(path_off=None, path_link=None)
        table = {nm: k for k, nm in enumerate(self.links)}
        codes = []
        for nm in path:
            c = table.get(nm)
            if c is None:
                c = table[nm] = len(table)
            codes.append(c)
        k = len(path)
        path_off = np.arange(0, (self.n + 1) * k, k, dtype=np.intp)
        path_link = np.tile(np.asarray(codes, dtype=np.intp), self.n)
        return self._replace(links=tuple(table), path_off=path_off,
                             path_link=path_link)


_EMPTY_BATCH = FlowBatch(
    op_id=np.zeros(0, dtype=np.intp), ready=np.zeros(0), work=np.zeros(0),
    latency=np.zeros(0), priority=np.zeros(0), duration=np.zeros(0),
    hold=np.zeros(0, dtype=bool), jobs=(), job=np.zeros(0, dtype=np.intp),
    links=(), link=np.zeros(0, dtype=np.intp),
    rail=np.zeros(0, dtype=np.intp), worker=np.zeros(0, dtype=np.intp))


class ResultBatch(NamedTuple):
    """Columnar flow results, aligned with the batch that produced them."""

    op_id: np.ndarray
    jobs: Tuple[str, ...]
    job: np.ndarray                  # intp codes into ``jobs``
    start: np.ndarray
    wire_end: np.ndarray
    end: np.ndarray
    contended: np.ndarray            # bool

    @property
    def n(self) -> int:
        return int(self.op_id.shape[0])

    @property
    def occupancy(self) -> np.ndarray:
        return self.end - self.start

    def to_results(self) -> List[FlowResult]:
        jobs = self.jobs
        rows = zip(self.op_id.tolist(),
                   [jobs[c] for c in self.job.tolist()],
                   self.start.tolist(), self.wire_end.tolist(),
                   self.end.tolist(), self.contended.tolist())
        new = tuple.__new__
        return [new(FlowResult, row) for row in rows]


def concat_batches(batches: Iterable[FlowBatch]) -> FlowBatch:
    """Concatenate batches, re-interning names in first-appearance order.

    The columnar twin of ``all_flows.extend(...)`` across jobs: per-batch
    name tables merge through a small LUT (O(names) python work), code
    columns remap vectorized, float columns concatenate.
    """
    bs = [b for b in batches]
    if not bs:
        return _EMPTY_BATCH
    if len(bs) == 1:
        return bs[0]
    job_table: Dict[str, int] = {}
    link_table: Dict[str, int] = {}
    job_cols = []
    link_cols = []
    path_cols = []
    off_cols = []
    off_base = 0
    has_paths = False
    for b in bs:
        jl = np.empty(len(b.jobs), dtype=np.intp)
        for k, nm in enumerate(b.jobs):
            c = job_table.get(nm)
            if c is None:
                c = job_table[nm] = len(job_table)
            jl[k] = c
        job_cols.append(jl[b.job] if len(b.jobs) else b.job)
        ll = np.empty(len(b.links), dtype=np.intp)
        for k, nm in enumerate(b.links):
            c = link_table.get(nm)
            if c is None:
                c = link_table[nm] = len(link_table)
            ll[k] = c
        link_cols.append(ll[b.link] if len(b.links) else b.link)
        if b.path_link is not None and b.path_link.shape[0]:
            has_paths = True
            path_cols.append(ll[b.path_link])
            off_cols.append(b.path_off[1:] + off_base)
            off_base += int(b.path_off[-1])
        else:
            path_cols.append(np.zeros(0, dtype=np.intp))
            off_cols.append(np.full(b.n, off_base, dtype=np.intp))
    if has_paths:
        path_off = np.concatenate(
            [np.zeros(1, dtype=np.intp)] + off_cols)
        path_link = np.concatenate(path_cols)
    else:
        path_off = path_link = None
    return FlowBatch(
        op_id=np.concatenate([b.op_id for b in bs]),
        ready=np.concatenate([b.ready for b in bs]),
        work=np.concatenate([b.work for b in bs]),
        latency=np.concatenate([b.latency for b in bs]),
        priority=np.concatenate([b.priority for b in bs]),
        duration=np.concatenate([b.duration for b in bs]),
        hold=np.concatenate([b.hold for b in bs]),
        jobs=tuple(job_table), job=np.concatenate(job_cols),
        links=tuple(link_table), link=np.concatenate(link_cols),
        rail=np.concatenate([b.rail for b in bs]),
        worker=np.concatenate([b.worker for b in bs]),
        path_off=path_off, path_link=path_link)


def perturb_batch(batch: FlowBatch, jitter: float, seed: int,
                  stream: int = 0) -> FlowBatch:
    """Columnar :func:`perturb_flows`: one vectorized ``ready + delays``.

    Same RNG construction and draw count, and elementwise float64 adds are
    exactly the scalar adds — a perturbed batch is bit-identical to
    perturbing the tuple view.  ``jitter <= 0`` returns ``batch`` itself.
    """
    if jitter <= 0.0 or not batch.n:
        return batch
    delays = jitter_delays(batch.n, jitter, seed, stream)
    return batch._replace(ready=batch.ready + delays)


def serialized_chain(ready: np.ndarray, dur: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized max-plus recurrence, bit-exact with the serial loop.

    Solves ``start_i = max(ready_i, end_{i-1}); end_i = start_i + dur_i``
    with numpy.  Exactness hinges on two properties: ``np.cumsum`` is a
    strict left fold (the same float additions in the same order as the
    serial loop), and folding each chain's start into the summand array
    (``cumsum([ready_j, dur_j, ...])``) preserves the serial association
    ``((ready_j + dur_j) + dur_{j+1}) + ...``.

    Chain starts (indices where the resource went idle) are found
    iteratively: begin with the superset ``ready_i >= ready_{i-1} +
    dur_{i-1}`` (every true chain start satisfies it, since ``end >= ready
    + dur``), compute ends as if those were the starts, then demote any
    candidate whose gap closes (``ready_j < end_{j-1}``).  Ends only grow
    when chains merge, so each pass removes at least one false candidate
    and the fixpoint makes exactly the serial loop's max choices.

    Serves both the simulator's closed-form fifo fast path and the codec
    encode chain in :func:`repro_torch.core.schedule.plan_to_flow_batch` (a naive
    ``np.maximum.accumulate`` would re-associate the adds and drift).
    """
    n = ready.shape[0]
    cand = np.empty(n, dtype=bool)
    cand[0] = True
    if n > 1:
        cand[1:] = ready[1:] >= ready[:-1] + dur[:-1]
    starts = np.empty(n)
    ends = np.empty(n)
    for _ in range(n):
        idx = np.flatnonzero(cand)
        if idx.shape[0] == n:
            # every op finds the resource idle: no queueing anywhere
            starts[:] = ready
            ends[:] = ready + dur
        else:
            bounds = np.append(idx, n)
            for a, b in zip(bounds[:-1], bounds[1:]):
                seg = np.cumsum(np.concatenate(([ready[a]], dur[a:b])))
                starts[a] = ready[a]
                starts[a + 1:b] = seg[1:-1]
                ends[a:b] = seg[1:]
        bad = idx[1:][ready[idx[1:]] < ends[idx[1:] - 1]]
        if not bad.shape[0]:
            return starts, ends
        cand[bad] = False
    raise AssertionError("closed-form chain decomposition did not converge")


def maxmin_rates(demands: Sequence[Dict[str, float]],
                 capacities: Dict[str, float]) -> List[float]:
    """Bottleneck max-min fair rates by progressive filling.

    ``demands[i]`` maps link id -> multiplicity for flow ``i`` (a flow at
    rate ``r`` consumes ``m * r`` of a link it crosses with multiplicity
    ``m``); links absent from ``capacities`` have capacity 1.0.  The fill
    level rises uniformly for all unfrozen flows until some link
    saturates — link ``l`` with residual capacity ``c_l`` and unfrozen
    demand ``d_l`` saturates at level ``c_l / d_l`` — then the flows
    crossing the tightest link freeze at that level, their consumption is
    subtracted, and the process repeats.  Per-flow rates are capped at
    1.0 (full NIC-relative rate), matching the single-link engine's
    ``share = min(1, cap / n)``; the allocation this produces is the
    unique max-min fair point, so any correct solver agrees with it to
    rounding error (the contract behind ``tests/_reference_fabric.py``).

    Links co-saturating within a relative ``1e-12`` of the minimum level
    freeze in the same round: the residual updates are floating-point
    subtractions, and a tie partner left behind with a tiny negative
    residual would otherwise produce a bogus near-zero level (and a flow
    frozen at rate ~0) on the next round.
    """
    n = len(demands)
    rates = [0.0] * n
    un = list(range(n))
    residual: Dict[str, float] = {}
    load: Dict[str, float] = {}
    for i in un:
        for nm, m in demands[i].items():
            if nm not in residual:
                residual[nm] = float(capacities.get(nm, 1.0))
                load[nm] = 0.0
            load[nm] += m
    while un:
        phi = None
        for nm, ld in load.items():
            if ld <= 0.0:
                continue
            lvl = residual[nm] / ld
            if phi is None or lvl < phi:
                phi = lvl
        if phi is None or phi >= 1.0:
            for i in un:
                rates[i] = 1.0       # per-flow full-rate cap
            return rates
        if phi < 0.0:
            phi = 0.0
        cut = phi * (1.0 + 1e-12) + 1e-18
        tight = {nm for nm, ld in load.items()
                 if ld > 0.0 and residual[nm] / ld <= cut}
        nxt = []
        for i in un:
            d = demands[i]
            if tight.isdisjoint(d):
                nxt.append(i)
                continue
            rates[i] = phi
            for nm, m in d.items():
                residual[nm] -= m * phi
                load[nm] -= m
        un = nxt
    return rates


class _Link:
    """Fluid fair-share link: a service clock plus a completion-mark heap.

    ``S`` is the per-flow service delivered since the link last went idle;
    a flow admitted at service mark ``S`` completes when the clock reaches
    ``S + work``.  ``version`` stamps calendar entries for lazy
    invalidation on membership changes.
    """

    __slots__ = ("cap", "n", "share", "S", "t_last", "heap", "version",
                 "all_contended", "bulk_cap", "bulk_skip")

    def __init__(self, cap: float):
        self.cap = cap
        self.n = 0
        self.share = 1.0 if cap >= 1.0 else cap
        self.S = 0.0
        self.t_last = 0.0
        self.heap: List = []        # (service completion mark, flow index)
        self.version = 0
        self.all_contended = False
        # adaptive per-call chain cap for the bulk path: grows with actual
        # commit sizes so short windows (dense jittered ready gates) pay
        # O(committed), not O(remaining), per call
        self.bulk_cap = 64
        # back-off: after a weak commit or a gate rejection, let this many
        # completions go scalar before attempting bulk again — a window
        # too small to amortize the numpy setup is served cheaper event by
        # event, and a large window only ever waits O(skip) scalar events
        self.bulk_skip = 0


class _LinkSet:
    """One named multi-rail link: ``n_rails`` independent per-rail clocks.

    Every rail is a full :class:`_Link` (its own fluid service clock,
    completion heap, and membership version); flows are routed to
    ``rails[flow.rail]`` at setup, after which the event loop sees only
    plain links.  Rails therefore never fair-share with each other — the
    defining property of a multi-rail NIC versus one fat link.
    """

    __slots__ = ("rails",)

    def __init__(self, cap: float, n_rails: int):
        self.rails = [_Link(cap) for _ in range(n_rails)]


class _Job:
    """Serialization resource: one wire in flight, priority admission."""

    __slots__ = ("order", "rdy", "ptr", "gated", "gptr", "g_rd", "readyq",
                 "n_ready", "free", "busy", "link", "onp", "wk", "rd", "hd",
                 "lt", "apos")

    def __init__(self):
        self.order: List[int] = []   # flow indices in (priority, op_id) order
        self.rdy: List[float] = []   # ready times along ``order`` (ptr mode)
        self.ptr = 0
        # heap mode — two representations behind one mode flag
        # (``gated is None`` still means pointer mode):
        #
        # * small plans: ``gated`` is a build-once list of (ready, priority,
        #   op_id, idx) tuples sorted by ready; flows only ever *leave* it,
        #   so a pointer (``gptr``) replaces a heap and draining is a
        #   slice.  ``readyq`` is the classic (priority, op_id, idx) heap.
        # * columnar plans: ``gated`` is the position-into-``order`` array
        #   sorted by ready (``g_rd`` holds the sorted ready times), and
        #   ``readyq`` is a boolean *mask* over ``order`` positions.  The
        #   admissible set in service order is just ``nonzero(mask)`` — the
        #   bulk path's resolved prefix — a drain is one sliced scatter,
        #   and a scalar pop is ``argmax(mask)`` (``order`` is sorted by
        #   (priority, op_id), so the first set bit is the best flow).
        self.gated = None
        self.gptr = 0
        self.g_rd = None
        self.readyq = None
        self.n_ready = 0
        self.free = 0.0
        self.busy = False
        self.link: Optional[_Link] = None   # sole link, if homogeneous
        # numpy views along ``order`` for the bulk-commit path (lazy)
        self.onp = self.wk = self.rd = self.hd = self.lt = None
        # order-position of the in-flight flow (heap mode only; a fault
        # pulling the flow back needs it to restore the readyq bit)
        self.apos = -1


# below this many flows the engine skips its columnar numpy setup (and the
# bulk-commit path that needs it): asarray/lexsort/zeros dominate the whole
# event loop on the two-dozen-op plans the paper grids generate, while the
# bulk path only ever engages on contended multi-job plans far above this
_SMALL_PLAN_MAX_FLOWS = 64

# bulk commit engages once a link serves at least this many concurrent
# flows; tests raise it to infinity to force the scalar path (bulk must be
# bit-identical, so the knob is a dispatch threshold, not a semantic one)
_BULK_MIN_ACTIVE = 2

# hard upper bound on a bulk call's per-job candidate chain (the adaptive
# per-link cap never exceeds it): bounds the numpy work a short commit
# window can waste on chains it will not commit; correctness is unaffected
# — a capped chain just ends in an artificial boundary and the next call
# continues the same cumsum bit-exactly
_BULK_CHAIN_CAP = 2048

# drains of this many newly-ready flows rebuild the admissible heap with
# one extend+heapify instead of per-item pushes (same pop order: a heap's
# pop sequence is the sorted multiset regardless of internal layout)
_DRAIN_BATCH_MIN = 16

# stall detection: the engine raises after this many consecutive
# no-progress calendar pops (stale projections / superseded admissions);
# the counter resets on any committed work — an admission, a served
# completion, or a bulk commit.  Module-level so tests can tighten them.
_STALL_FACTOR = 4
_STALL_BASE = 1000


class NetworkEngine:
    """Event-calendar executor for a set of flows over shared links.

    ``capacities`` maps link name -> number of flows that can run at full
    rate before fair sharing kicks in (default 1.0 — the whole link).
    ``rails`` maps link name -> rail count: a name with ``n > 1`` becomes a
    :class:`_LinkSet` of ``n`` independent per-rail service clocks and each
    flow's ``rail`` field selects its clock (modulo ``n``).  Links absent
    from ``rails`` (or mapped to 1) behave exactly as before, bit-for-bit.
    """

    def __init__(self, capacities: Optional[Dict[str, float]] = None,
                 rails: Optional[Dict[str, int]] = None):
        self.capacities = dict(capacities or {})
        self.rails = dict(rails or {})

    def run(self, flows: Sequence[FlowSpec],
            churn: Optional[Sequence[ChurnEvent]] = None
            ) -> List[FlowResult]:
        """Execute ``flows``; returns results in input order.

        Plans below :data:`_SMALL_PLAN_MAX_FLOWS` run the plain-list setup;
        anything larger columnarizes once and runs the batch core — the
        same engine :meth:`run_batch` uses, so tuple and batch callers
        share one large-plan code path (and its bit-identity proofs).
        ``churn`` events force the batch core regardless of size (the
        membership-change handler lives only there).

        Flows carrying a multi-link ``path`` dispatch to the max-min
        event loop (:meth:`_run_maxmin`); single-element paths normalize
        into ``link`` first, so any plan whose paths all have length
        <= 1 runs the original single-resource engine bit-for-bit.
        """
        if not flows:
            return []
        plen = 0
        for f in flows:
            if len(f.path) > plen:
                plen = len(f.path)
        if plen > 1:
            return self._run_maxmin(flows, churn)
        if plen:
            flows = [f._replace(link=f.path[0], path=()) if f.path else f
                     for f in flows]
        if len(flows) < _SMALL_PLAN_MAX_FLOWS and not churn:
            return self._run_small(flows)
        return self.run_batch(FlowBatch.from_flows(flows),
                              churn=churn).to_results()

    def _run_small(self, flows: Sequence[FlowSpec]) -> List[FlowResult]:
        """Plain-list setup and event loop for paper-size plans.

        No numpy anywhere: columnar setup costs more than the whole event
        loop below :data:`_SMALL_PLAN_MAX_FLOWS`, and the bulk path can
        never engage on the single-job plans this size.  The scalar event
        loop is the same as the batch core's, so results are bit-identical
        across the two setups.
        """
        n_total = len(flows)
        caps = self.capacities

        (op_col, rdy_col, wk_col, lt_col, pr_col, job_col, lk_col, hd_col,
         _du_col, rl_col, _w_col, _pth_col) = zip(*flows)

        rail_counts = self.rails
        if rail_counts and any(rail_counts.get(nm, 1) > 1
                               for nm in set(lk_col)):
            sets = {nm: _LinkSet(caps.get(nm, 1.0),
                                 max(rail_counts.get(nm, 1), 1))
                    for nm in set(lk_col)}
            link_of = [sets[nm].rails[r % len(sets[nm].rails)]
                       for nm, r in zip(lk_col, rl_col)]
        else:
            links: Dict[str, _Link] = {
                nm: _Link(caps.get(nm, 1.0)) for nm in set(lk_col)}
            link_of = list(map(links.__getitem__, lk_col))

        by_job: Dict[str, List[int]] = {}
        for i, name in enumerate(job_col):
            try:
                by_job[name].append(i)
            except KeyError:
                by_job[name] = [i]
        jobs: Dict[str, _Job] = {name: _Job() for name in by_job}
        job_of = list(map(jobs.__getitem__, job_col))

        cal: List = []              # (time, kind, seq, ...) event calendar
        seq = 0
        for name, idxs in by_job.items():
            jb = jobs[name]
            # plain-list service order: identical (priority, op_id)
            # total order, without paying numpy's fixed costs
            if len(idxs) > 1:
                idxs.sort(key=lambda i: (pr_col[i], op_col[i]))
            order = jb.order = idxs
            rdy = jb.rdy = [rdy_col[i] for i in order]
            monotone = all(a <= b for a, b in zip(rdy, rdy[1:]))
            if monotone:
                trigger = rdy[0]
            else:
                # ready times regress along service order (e.g. priority
                # plans): gate admissions on ready order.  ``order`` is
                # already (priority, op_id)-sorted, so sorting *positions*
                # stably by ready yields (ready, priority, op_id) order.
                jb.gated = sorted((rdy_col[i], pr_col[i], op_col[i], i)
                                  for i in order)
                jb.readyq = []
                trigger = jb.gated[0][0]
            seq += 1
            cal.append((trigger if trigger > 0.0 else 0.0, _ADMIT, seq, jb))
        heapify(cal)                # one pass beats n pushes at setup

        start: List[float] = [0.0] * n_total
        wire: List[float] = [0.0] * n_total
        end: List[float] = [0.0] * n_total
        contended: List[bool] = [False] * n_total
        n_done = 0
        stale = 0                   # consecutive no-progress calendar pops
        stall_limit = _STALL_FACTOR * n_total + _STALL_BASE
        sweep_at = 256              # calendar size that triggers a compaction
        flws = flows                # local alias for the hot loops

        # -- admission: put flow ``i`` on its link at time ``t`` ------------
        def _admit(i: int, jb: _Job, t: float) -> _Link:
            nonlocal stale
            stale = 0               # an admission is committed work
            L = link_of[i]
            if L.n:
                if t > L.t_last:
                    L.S += (t - L.t_last) * L.share
                L.t_last = t
                contended[i] = True
                if not L.all_contended:
                    for _, k in L.heap:
                        contended[k] = True
                    L.all_contended = True
            else:
                # fresh busy period: restart the service clock so the
                # single-flow closed form stays exact (mark == work)
                L.S = 0.0
                L.t_last = t
                if L.cap < 1.0:
                    contended[i] = True
                    L.all_contended = True
            heappush(L.heap, (L.S + wk_col[i], i))
            L.n += 1
            c = L.cap
            L.share = 1.0 if c >= L.n else c / L.n
            L.version += 1
            start[i] = t
            jb.busy = True
            return L

        # -- next-admission trigger for a job that just freed ---------------
        def _schedule_admit(jb: _Job, t: float) -> None:
            nonlocal seq
            if jb.gated is None:
                if jb.ptr < len(jb.order):
                    trig = jb.rdy[jb.ptr]
                    if trig < jb.free:
                        trig = jb.free
                    seq += 1
                    heappush(cal, (trig, _ADMIT, seq, jb))
            else:
                have_ready = bool(jb.readyq)
                nxt = jb.gated[jb.gptr][0] \
                    if jb.gptr < len(jb.gated) else None
                if have_ready:
                    seq += 1
                    heappush(cal, (jb.free, _ADMIT, seq, jb))
                elif nxt is not None:
                    trig = nxt if nxt > jb.free else jb.free
                    seq += 1
                    heappush(cal, (trig, _ADMIT, seq, jb))

        # -- heap mode: move gated flows with ready <= t to the admissible
        # set.  Draining earlier than the next service event is sound: any
        # scalar drain happens at a service time t' >= t and moves a
        # superset, and pops always consider the whole admissible set.
        def _drain(jb: _Job, t: float) -> None:
            g = jb.gated
            gp = jb.gptr
            ng = len(g)
            if gp >= ng or g[gp][0] > t:
                return
            j = gp + 1
            while j < ng and g[j][0] <= t:
                j += 1
            rq = jb.readyq
            if j - gp >= _DRAIN_BATCH_MIN:
                # bulk heappush: one heapify over the merged contents
                rq.extend((pr, op, i) for _r, pr, op, i in g[gp:j])
                heapify(rq)
            else:
                for _r, pr, op, i in g[gp:j]:
                    heappush(rq, (pr, op, i))
            jb.gptr = j

        while n_done < n_total:
            if not cal:
                raise RuntimeError(
                    f"event engine stalled: {n_done}/{n_total} flows done "
                    "with an empty calendar")
            ev = heappop(cal)
            t = ev[0]

            if ev[1] == _DONE:
                ver, L = ev[3], ev[4]
                if ver != L.version or not L.n:
                    stale += 1      # lazily-invalidated projection
                    if stale > stall_limit:
                        raise RuntimeError(
                            "event engine made no progress over "
                            f"{stale} events ({n_done}/{n_total} flows done)")
                    if len(cal) > sweep_at:
                        # batched stale sweep: one filter pass + heapify
                        # beats popping invalidated projections one by one
                        cal[:] = [e for e in cal if e[1] != _DONE
                                  or e[3] == e[4].version]
                        heapify(cal)
                        sweep_at = max(256, 2 * len(cal))
                    continue
                stale = 0
                # ---- completion spin: serve this link's completions while
                # they precede everything else on the calendar --------------
                while True:
                    if t > L.t_last:
                        L.S += (t - L.t_last) * L.share
                    L.t_last = t
                    s_top, i = heappop(L.heap)
                    L.S = s_top
                    L.n -= 1
                    L.version += 1
                    if L.n:
                        c = L.cap
                        L.share = 1.0 if c >= L.n else c / L.n
                    else:
                        L.all_contended = False
                    if contended[i]:
                        w = t
                        e = t + lt_col[i]
                    else:
                        # exact closed form: share was 1.0 throughout
                        w = float(start[i]) + wk_col[i]
                        d = flws[i].duration
                        if hd_col[i] and d is not None:
                            e = float(start[i]) + d
                        else:
                            e = w + lt_col[i]
                    wire[i] = w
                    end[i] = e
                    n_done += 1
                    jb = job_of[i]
                    jb.busy = False
                    jb.free = e if hd_col[i] else w
                    # instant re-admission keeps the spin going (the
                    # saturated steady state); anything else goes back
                    # through the calendar
                    readmitted = None
                    if not hd_col[i]:
                        if jb.gated is None:
                            p = jb.ptr
                            if p < len(jb.order) and jb.rdy[p] <= t:
                                jb.ptr = p + 1
                                readmitted = _admit(jb.order[p], jb, t)
                        else:
                            _drain(jb, t)
                            if jb.readyq:
                                k = heappop(jb.readyq)[2]
                                readmitted = _admit(k, jb, t)
                    if readmitted is None:
                        _schedule_admit(jb, t)
                    elif readmitted is not L:
                        # cross-link re-admission: project the other link
                        seq += 1
                        s2 = readmitted.heap[0][0]
                        proj2 = t + (s2 - readmitted.S) / readmitted.share
                        heappush(cal, (proj2 if proj2 > t else t, _DONE,
                                       seq, readmitted.version, readmitted))
                    if not L.n:
                        break
                    proj = t + (L.heap[0][0] - L.S) / L.share
                    if proj < t:
                        proj = t
                    if cal and cal[0][0] < proj:
                        seq += 1
                        heappush(cal, (proj, _DONE, seq, L.version, L))
                        break
                    t = proj
                continue

            # ---- admission event ------------------------------------------
            jb = ev[3]
            if jb.busy:
                stale += 1          # superseded by an instant re-admission
                if stale > stall_limit:
                    raise RuntimeError(
                        "event engine made no progress over "
                        f"{stale} events ({n_done}/{n_total} flows done)")
                continue
            if jb.free > t:         # defensive: fire again once free
                stale += 1
                _schedule_admit(jb, t)
                continue
            stale = 0               # a serviced admission trigger is progress
            admitted = None
            if jb.gated is None:
                p = jb.ptr
                if p < len(jb.order):
                    if jb.rdy[p] <= t:
                        jb.ptr = p + 1
                        admitted = _admit(jb.order[p], jb, t)
                    else:
                        _schedule_admit(jb, t)
            else:
                _drain(jb, t)
                if jb.readyq:
                    k = heappop(jb.readyq)[2]
                    admitted = _admit(k, jb, t)
                elif jb.gptr < len(jb.gated):
                    _schedule_admit(jb, t)
            if admitted is not None:
                seq += 1
                s_top = admitted.heap[0][0]
                proj = t + (s_top - admitted.S) / admitted.share
                heappush(cal, (proj if proj > t else t, _DONE, seq,
                               admitted.version, admitted))

        rows = zip(op_col, job_col, start, wire, end, contended)
        new = tuple.__new__
        return [new(FlowResult, row) for row in rows]

    def _run_maxmin(self, flows: Sequence[FlowSpec],
                    churn: Optional[Sequence[ChurnEvent]] = None
                    ) -> List[FlowResult]:
        """Multi-resource event loop: bottleneck max-min fair shares.

        Flows whose ``path`` spans several links progress at the rate
        progressive filling assigns them (:func:`maxmin_rates`), and the
        piecewise-constant rate vector is re-derived at every
        path-membership change — admission, completion, churn teardown —
        which is exactly the set of instants where it can change.  Between
        change-points each active flow's remaining work drains linearly at
        its rate, and the next completion is the minimum projection
        ``t + remaining / rate``.

        Job semantics are the single-resource engine's, verbatim: one
        in-flight flow per job in (priority, op_id) service order, ready
        gating, ``hold``/``latency``/``duration`` completion bookkeeping,
        and the closed-form ``start + work`` wire time for flows that were
        never contended.  A flow is contended when it ever shared a link
        with another active flow or could not run at full rate alone
        (some link's capacity is below the flow's own demand on it).

        Churn tears down the in-flight flow on **every** link of its path
        at once — the active set is the only link state, so removal frees
        its share on all of them for the next rate solve — then cancels a
        dropped worker's pending flows and applies the re-bucketing stall,
        mirroring the single-resource ``_apply_fault``.

        The loop is O(events x active x path): fabric cells keep at most
        one flow per job in flight, so the rate solve spans the handful of
        co-scheduled jobs, not the plan size.
        """
        caps = self.capacities
        n_total = len(flows)
        if self.rails and any(v > 1 for v in self.rails.values()):
            raise ValueError("multi-link paths and multi-rail links are "
                             "mutually exclusive on one engine")

        # per-flow demand: link -> multiplicity (repeats in ``path``)
        demand: List[Dict[str, float]] = []
        for f in flows:
            d: Dict[str, float] = {}
            for nm in (f.path or (f.link,)):
                d[nm] = d.get(nm, 0.0) + 1.0
            demand.append(d)
        link_cap: Dict[str, float] = {}
        for d in demand:
            for nm in d:
                if nm not in link_cap:
                    link_cap[nm] = float(caps.get(nm, 1.0))

        by_job: Dict[str, List[int]] = {}
        for i, f in enumerate(flows):
            by_job.setdefault(f.job, []).append(i)
        for q in by_job.values():
            # service order (priority, op_id); best last for cheap picks
            q.sort(key=lambda k: (flows[k].priority, flows[k].op_id),
                   reverse=True)
        job_free: Dict[str, float] = {j: 0.0 for j in by_job}
        active: Dict[str, int] = {}          # job -> in-flight flow index

        start = [0.0] * n_total
        wire = [0.0] * n_total
        end = [0.0] * n_total
        contended = [False] * n_total
        remaining = [0.0] * n_total
        rate = [0.0] * n_total
        n_done = 0

        events = sorted(churn or [],
                        key=lambda fe: fe.t if fe.t > 0.0 else 0.0)
        ep = 0
        t = 0.0
        guard = 0
        guard_max = _STALL_FACTOR * (n_total + len(events)) * 4 + _STALL_BASE

        def _pick(job: str) -> int:
            q = by_job[job]
            for k in range(len(q) - 1, -1, -1):  # sorted reverse: best last
                if flows[q[k]].ready <= t:
                    return q.pop(k)
            return -1

        def _rates() -> None:
            ids = list(active.values())
            rs = maxmin_rates([demand[i] for i in ids], link_cap)
            for k, i in enumerate(ids):
                rate[i] = rs[k]

        def _apply_churn(fe: ChurnEvent, tf: float) -> None:
            nonlocal n_done, guard
            pref = fe.job + "@"
            for j in by_job:
                if j != fe.job and not j.startswith(pref):
                    continue
                guard = 0
                # (a) the in-flight transfer is torn down by the membership
                # change on every link of its path and restarts from
                # scratch after the stall: push it back into the queue
                i = active.pop(j, None)
                if i is not None:
                    contended[i] = False  # readmission re-derives contention
                    q = by_job[j]
                    q.append(i)
                    q.sort(key=lambda k: (flows[k].priority,
                                          flows[k].op_id), reverse=True)
                # (b) dropout: the re-formed collective skips the dead
                # worker's buckets — its pending flows complete trivially
                if fe.kind == "drop" and fe.worker >= 0:
                    q = by_job[j]
                    dead = [k for k in q
                            if flows[k].worker == fe.worker]
                    if dead:
                        by_job[j] = [k for k in q
                                     if flows[k].worker != fe.worker]
                        for k in dead:
                            start[k] = tf
                            wire[k] = tf
                            end[k] = tf
                            contended[k] = False
                            n_done += 1
                # (c) the priced re-bucketing stall gates the next admission
                if fe.stall > 0.0:
                    ft = tf + fe.stall
                    if ft > job_free[j]:
                        job_free[j] = ft

        while n_done < n_total:
            guard += 1
            if guard > guard_max:
                raise RuntimeError(
                    "max-min engine made no progress "
                    f"({n_done}/{n_total} flows done)")

            # -- admissions at the current time ----------------------------
            admitted = False
            for j, q in by_job.items():
                if j in active or job_free[j] > t or not q:
                    continue
                i = _pick(j)
                if i < 0:
                    continue
                start[i] = t
                remaining[i] = flows[i].work
                d = demand[i]
                if any(link_cap[nm] < m for nm, m in d.items()):
                    # some link cannot carry even this flow alone at full
                    # rate: the closed-form completion is invalid
                    contended[i] = True
                for oi in active.values():
                    od = demand[oi]
                    shared = any(nm in od for nm in d)
                    if shared:
                        contended[oi] = True
                        contended[i] = True
                active[j] = i
                admitted = True
            if admitted:
                guard = 0
                continue            # membership changed; recompute rates

            _rates()

            # -- next event: completion, admission trigger, or churn -------
            t_next = None
            for i in active.values():
                if rate[i] > 0.0:
                    proj = t + remaining[i] / rate[i]
                    if t_next is None or proj < t_next:
                        t_next = proj
            for j, q in by_job.items():
                if j in active or not q:
                    continue
                earliest = min(flows[k].ready for k in q)
                trigger = max(job_free[j], earliest)
                if t_next is None or trigger < t_next:
                    t_next = trigger
            if ep < len(events):
                ft = events[ep].t
                if ft < 0.0:
                    ft = 0.0
                if t_next is None or ft < t_next:
                    t_next = ft
            if t_next is None:
                raise RuntimeError(
                    "max-min engine stalled with pending flows")
            if t_next < t:
                t_next = t

            # -- advance every active wire at its current rate -------------
            dt = t_next - t
            completions: List[Tuple[str, int]] = []
            for j, i in active.items():
                r = rate[i]
                remaining[i] -= dt * r
                # done when the residual is negligible — or too small to
                # advance the clock at all (absorbed below ulp(t_next))
                if r > 0.0 and (
                        remaining[i] <= flows[i].work * 1e-12 + 1e-18
                        or t_next + remaining[i] / r <= t_next):
                    completions.append((j, i))
            t = t_next

            for j, i in completions:
                f = flows[i]
                if not contended[i]:
                    w = start[i] + f.work  # exact: rate was 1.0 throughout
                    if f.hold and f.duration is not None:
                        e = start[i] + f.duration
                    else:
                        e = w + f.latency
                else:
                    w = t
                    e = w + f.latency
                wire[i] = w
                end[i] = e
                job_free[j] = e if f.hold else w
                del active[j]
                n_done += 1
                guard = 0

            # -- churn due now fires after same-time completions, before
            # the next round of admissions (the _DONE < _FAULT < _ADMIT
            # calendar order of the single-resource core) ------------------
            while ep < len(events) and (
                    events[ep].t if events[ep].t > 0.0 else 0.0) <= t:
                _apply_churn(events[ep], t)
                ep += 1

        rows = zip([f.op_id for f in flows], [f.job for f in flows],
                   start, wire, end, contended)
        new = tuple.__new__
        return [new(FlowResult, row) for row in rows]

    def run_batch(self, batch: FlowBatch,
                  churn: Optional[Sequence[ChurnEvent]] = None
                  ) -> ResultBatch:
        """Execute a columnar batch; results align with the batch's order.

        The large-plan setup is fully vectorized: one global
        ``lexsort((op_id, priority, job))`` yields every job's
        (priority, op_id) service order *and* groups jobs in
        first-appearance order (the job-code invariant), so per-job state
        is built from contiguous slices — no tuple materialization and no
        per-job sorts.  Below :data:`_SMALL_PLAN_MAX_FLOWS` the batch
        bounces to the plain-list path (columnar setup must never engage
        on paper-size plans); either way results are bit-identical to
        ``run(batch.to_flows())``.

        ``churn`` events (membership changes — see :class:`ChurnEvent`)
        enter the calendar as ``_FAULT`` entries and keep the batch on
        the columnar core whatever its size; an empty/None ``churn`` is
        bit-identical to a run that never heard of faults.
        """
        n_total = batch.n
        if not n_total:
            z = np.zeros(0)
            return ResultBatch(batch.op_id, batch.jobs, batch.job,
                               z, np.zeros(0), np.zeros(0),
                               np.zeros(0, dtype=bool))
        if batch.path_link is not None and batch.path_link.shape[0]:
            plens = np.diff(batch.path_off)
            if plens.max() > 1:
                res = self._run_maxmin(batch.to_flows(), churn)
                return ResultBatch(
                    batch.op_id, batch.jobs, batch.job,
                    np.array([r.start for r in res]),
                    np.array([r.wire_end for r in res]),
                    np.array([r.end for r in res]),
                    np.array([r.contended for r in res], dtype=bool))
            # every path has length <= 1: normalize one-element paths into
            # the ``link`` column and run the single-resource engine —
            # bit-identical by construction (it only ever reads ``link``)
            m = plens > 0
            link = batch.link.copy()
            link[m] = batch.path_link[batch.path_off[:-1][m]]
            batch = batch._replace(link=link, path_off=None, path_link=None)
        if n_total < _SMALL_PLAN_MAX_FLOWS and not churn:
            res = self._run_small(batch.to_flows())
            return ResultBatch(
                batch.op_id, batch.jobs, batch.job,
                np.array([r.start for r in res]),
                np.array([r.wire_end for r in res]),
                np.array([r.end for r in res]),
                np.array([r.contended for r in res], dtype=bool))

        caps = self.capacities
        names = batch.links
        li_col = batch.link
        rail_counts = self.rails
        li_dense = None             # dense per-flow link index, when needed
        if rail_counts and any(rail_counts.get(nm, 1) > 1 for nm in names):
            rail_objs: List[_Link] = []
            base = np.empty(len(names), dtype=np.intp)
            nr = np.empty(len(names), dtype=np.intp)
            for k, nm in enumerate(names):
                r = max(rail_counts.get(nm, 1), 1)
                base[k] = len(rail_objs)
                nr[k] = r
                cap = caps.get(nm, 1.0)
                rail_objs.extend(_Link(cap) for _ in range(r))
            li_dense = base[li_col] + batch.rail % nr[li_col]
            link_of = np.asarray(rail_objs, dtype=object)[li_dense].tolist()
            one_link = len(rail_objs) == 1
        elif len(names) == 1:
            link_of = [_Link(caps.get(names[0], 1.0))] * n_total
            one_link = True
        else:
            rail_objs = [_Link(caps.get(nm, 1.0)) for nm in names]
            li_dense = li_col
            link_of = np.asarray(rail_objs, dtype=object)[li_col].tolist()
            one_link = len(rail_objs) == 1

        rd_np = batch.ready
        jcode = batch.job
        n_jobs = len(batch.jobs)
        if n_jobs > 1:
            # stable 3-key sort == per-job (priority, op_id) lexsorts, with
            # segments in job-code (= first-appearance) order
            order_g = np.lexsort((batch.op_id, batch.priority, jcode))
            jc_sorted = jcode[order_g]
            cuts = np.flatnonzero(jc_sorted[1:] != jc_sorted[:-1]) + 1
            bounds = np.concatenate((
                np.zeros(1, dtype=np.intp), cuts,
                np.full(1, n_total, dtype=np.intp)))
        else:
            order_g = np.lexsort((batch.op_id, batch.priority))
            bounds = np.array([0, n_total], dtype=np.intp)

        wk_col = batch.work.tolist()
        lt_col = batch.latency.tolist()
        hd_col = batch.hold.tolist()
        du_col = batch.duration.tolist()

        cal: List = []
        seq = 0
        job_list: List[_Job] = []
        for s_, e_ in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            ix = order_g[s_:e_]
            jb = _Job()
            jb.onp = ix
            order = jb.order = ix.tolist()
            rd_ix = rd_np[ix]
            rdy = jb.rdy = rd_ix.tolist()
            monotone = (len(rdy) == 1
                        or bool((rd_ix[1:] >= rd_ix[:-1]).all()))
            if one_link:
                jb.link = link_of[order[0]]
            else:
                li_ix = li_dense[ix]
                jb.link = (link_of[order[0]]
                           if bool((li_ix == li_ix[0]).all()) else None)
            if monotone:
                trigger = rdy[0]
            else:
                g_pos = np.argsort(rd_ix, kind="stable")
                jb.gated = g_pos
                jb.g_rd = rd_ix[g_pos]
                jb.readyq = np.zeros(len(order), dtype=bool)
                trigger = float(jb.g_rd[0])
            seq += 1
            cal.append((trigger if trigger > 0.0 else 0.0, _ADMIT, seq, jb))
            job_list.append(jb)
        if n_jobs > 1:
            job_of = np.asarray(job_list, dtype=object)[jcode].tolist()
        else:
            job_of = [job_list[0]] * n_total

        if churn:
            # resolve job names to _Job objects once; sort for a
            # deterministic seq order at equal fault times.  A name
            # matches exactly or as a rail-lane prefix (job0 -> job0@r1).
            jnames = batch.jobs
            for fe in sorted(churn):
                matched = [job_list[ci] for ci, nm in enumerate(jnames)
                           if nm == fe.job or nm.startswith(fe.job + "@")]
                if not matched:
                    continue
                seq += 1
                cal.append((fe.t if fe.t > 0.0 else 0.0,
                            _RETX if fe.kind == "retx" else _FAULT, seq,
                            matched, fe))

        start, wire, end, contended = _run_core(
            n_total, wk_col, lt_col, hd_col, du_col, rd_np, link_of,
            job_of, cal, seq, batch.work, batch.hold, batch.latency,
            batch.worker)
        return ResultBatch(batch.op_id, batch.jobs, batch.job,
                           start, wire, end, contended)


def run_flows(flows: Sequence[FlowSpec],
              capacities: Optional[Dict[str, float]] = None,
              rails: Optional[Dict[str, int]] = None,
              churn: Optional[Sequence[ChurnEvent]] = None
              ) -> List[FlowResult]:
    """Convenience wrapper: execute ``flows`` on a fresh engine.

    ``capacities`` and ``rails`` are per-link-name maps — see
    :class:`NetworkEngine`; ``churn`` is a list of membership-change
    events (:class:`ChurnEvent`).
    """
    return NetworkEngine(capacities, rails).run(flows, churn=churn)


def run_flow_batch(batch: FlowBatch,
                   capacities: Optional[Dict[str, float]] = None,
                   rails: Optional[Dict[str, int]] = None,
                   churn: Optional[Sequence[ChurnEvent]] = None
                   ) -> ResultBatch:
    """Columnar :func:`run_flows`: execute a batch on a fresh engine."""
    return NetworkEngine(capacities, rails).run_batch(batch, churn=churn)


def _run_core(n_total: int, wk_col, lt_col, hd_col, du_col, rd_np,
              link_of, job_of, cal, seq, g_wk, g_hd, g_lt, g_wr=None):
    """The large-plan event loop over columnar state.

    ``wk_col``/``lt_col``/``hd_col``/``du_col`` are plain python lists
    (scalar indexing in the hot loop), ``g_wk``/``g_hd``/``g_lt``/``rd_np``
    the matching numpy columns (the bulk path's gathers); ``du_col`` holds
    NaN where a duration is absent.  ``cal`` arrives as an unheapified
    list of per-job admission triggers in job first-appearance order,
    plus any ``_FAULT`` entries (``g_wr`` is the worker column their
    dropout cancellation filters on).
    Returns ``(start, wire, end, contended)`` numpy arrays.
    """
    heapify(cal)                # one pass beats n pushes at setup
    start = np.zeros(n_total)
    wire = np.zeros(n_total)
    end = np.zeros(n_total)
    contended = np.zeros(n_total, dtype=bool)
    n_done = 0
    stale = 0                   # consecutive no-progress calendar pops
    # the budget scales with every entry that can legitimately pop without
    # serving a flow: each fault/retx entry both pops once itself and can
    # supersede one pending admission, so a dense _RETX calendar (long
    # backoff stalls, zero committed work in between) must widen the
    # limit rather than trip it.  _apply_fault resets the counter — a
    # fault *is* committed calendar work — so this is belt and braces.
    n_faults = sum(1 for ev in cal if ev[1] == _FAULT or ev[1] == _RETX)
    stall_limit = _STALL_FACTOR * (n_total + 2 * n_faults) + _STALL_BASE
    sweep_at = 256              # calendar size that triggers a compaction

    # -- admission: put flow ``i`` on its link at time ``t`` ----------------
    def _admit(i: int, jb: _Job, t: float) -> _Link:
        nonlocal stale
        stale = 0               # an admission is committed work
        L = link_of[i]
        if L.n:
            if t > L.t_last:
                L.S += (t - L.t_last) * L.share
            L.t_last = t
            contended[i] = True
            if not L.all_contended:
                for _, k in L.heap:
                    contended[k] = True
                L.all_contended = True
        else:
            # fresh busy period: restart the service clock so the
            # single-flow closed form stays exact (mark == work)
            L.S = 0.0
            L.t_last = t
            if L.cap < 1.0:
                contended[i] = True
                L.all_contended = True
        heappush(L.heap, (L.S + wk_col[i], i))
        L.n += 1
        c = L.cap
        L.share = 1.0 if c >= L.n else c / L.n
        L.version += 1
        start[i] = t
        jb.busy = True
        return L

    # -- next-admission trigger for a job that just freed -------------------
    def _schedule_admit(jb: _Job, t: float) -> None:
        nonlocal seq
        if jb.gated is None:
            if jb.ptr < len(jb.order):
                trig = jb.rdy[jb.ptr]
                if trig < jb.free:
                    trig = jb.free
                seq += 1
                heappush(cal, (trig, _ADMIT, seq, jb))
        else:
            have_ready = jb.n_ready > 0
            nxt = float(jb.g_rd[jb.gptr]) \
                if jb.gptr < jb.g_rd.shape[0] else None
            if have_ready:
                seq += 1
                heappush(cal, (jb.free, _ADMIT, seq, jb))
            elif nxt is not None:
                trig = nxt if nxt > jb.free else jb.free
                seq += 1
                heappush(cal, (trig, _ADMIT, seq, jb))

    # -- heap mode: move gated flows with ready <= t to the admissible
    # set.  Draining earlier than the next service event is sound: any
    # scalar drain happens at a service time t' >= t and moves a
    # superset, and pops always consider the whole admissible set.
    def _drain(jb: _Job, t: float) -> None:
        gp = jb.gptr
        grd = jb.g_rd
        if gp >= grd.shape[0] or grd[gp] > t:
            return
        j = int(grd.searchsorted(t, side="right"))
        jb.readyq[jb.gated[gp:j]] = True   # one sliced scatter
        jb.n_ready += j - gp
        jb.gptr = j

    # -- membership change: pull back the wire, cancel the dead worker's
    # pending flows, stall the survivors through the re-bucketing ----------
    def _apply_fault(jb: _Job, fe, t: float) -> None:
        nonlocal n_done, seq, stale
        stale = 0                   # a fault is committed calendar work
        # (a) the in-flight transfer is torn down by the membership change
        # and restarts from scratch after the stall: un-admit it
        if jb.busy:
            if jb.gated is None:
                jb.ptr -= 1
                i = jb.order[jb.ptr]
            else:
                p = jb.apos
                jb.readyq[p] = True
                jb.n_ready += 1
                i = jb.order[p]
            L = link_of[i]
            if t > L.t_last:
                L.S += (t - L.t_last) * L.share
            L.t_last = t
            L.heap = [e for e in L.heap if e[1] != i]
            heapify(L.heap)
            L.n -= 1
            L.version += 1
            if L.n:
                c = L.cap
                L.share = 1.0 if c >= L.n else c / L.n
                seq += 1
                proj = t + (L.heap[0][0] - L.S) / L.share
                heappush(cal, (proj if proj > t else t, _DONE, seq,
                               L.version, L))
            else:
                L.all_contended = False
            contended[i] = False    # readmission re-derives contention
            jb.busy = False
        # (b) dropout: the re-formed collective skips the dead worker's
        # buckets this iteration — its pending flows complete trivially now
        if fe.kind == "drop" and fe.worker >= 0 and g_wr is not None:
            onp = jb.onp
            if onp is None:
                onp = jb.onp = np.asarray(jb.order, dtype=np.intp)
            if jb.gated is None:
                tail = onp[jb.ptr:]
                dead_m = g_wr[tail] == fe.worker
                if dead_m.any():
                    ids = tail[dead_m]
                    start[ids] = t
                    wire[ids] = t
                    end[ids] = t
                    contended[ids] = False
                    n_done += int(ids.size)
                    live = tail[~dead_m]
                    jb.order = jb.order[:jb.ptr] + live.tolist()
                    jb.rdy = jb.rdy[:jb.ptr] + rd_np[live].tolist()
                    jb.onp = None   # invalidate the bulk path's views
                    jb.wk = None
            else:
                wk_pos = g_wr[onp]  # worker per order position
                pos_r = np.flatnonzero(jb.readyq)
                dead_r = pos_r[wk_pos[pos_r] == fe.worker]
                g_tail = jb.gated[jb.gptr:]
                live_m = wk_pos[g_tail] != fe.worker
                dead_g = g_tail[~live_m]
                if dead_r.size or dead_g.size:
                    ids = onp[np.concatenate((dead_r, dead_g))]
                    start[ids] = t
                    wire[ids] = t
                    end[ids] = t
                    contended[ids] = False
                    n_done += int(ids.size)
                if dead_r.size:
                    jb.readyq[dead_r] = False
                    jb.n_ready -= int(dead_r.size)
                if dead_g.size:
                    jb.gated = g_tail[live_m]
                    jb.g_rd = jb.g_rd[jb.gptr:][live_m]
                    jb.gptr = 0
        # (c) the priced re-bucketing stall gates the next admission
        if fe.stall > 0.0:
            ft = t + fe.stall
            if ft > jb.free:
                jb.free = ft
        _schedule_admit(jb, t)

    # -- bulk commit: vectorized saturated stretch on link ``L`` ------------
    def _try_bulk(L: _Link, t0: float, t_cal: float,
                  t_first: Optional[float] = None) -> int:
        """While every completion instantly re-admits (constant
        membership, constant share), each job's future completion marks
        are prefix sums of its works — a pointer-mode job's marks walk
        ``order[ptr:]``, a heap-mode job's walk its *resolved prefix*
        (the admissible mask in (priority, op_id) order, valid until
        the next gated ready time).  The per-job chains merge into one
        (mark, flow)-sorted sequence whose completion times are a
        single chained left fold — the exact float operations the
        scalar spin performs, so bulk commits are bit-identical to
        scalar processing.  Every completion strictly before the first
        boundary (ready gate, gating boundary, hold flow, chain cap,
        or the ``t_cal`` calendar fence) commits in one vectorized pass.
        ``t_first`` overrides the first completion time — a *parked*
        link's calendar entry carries the exact (possibly clamped) time
        the scalar loop would have served it at.  Returns the number of
        flows committed."""
        nonlocal n_done, stale
        S0 = L.S
        share = L.share
        # O(1) pre-checks on the earliest completion: if its own job
        # cannot instantly re-admit, the very first completion is a
        # boundary and nothing can commit
        m_top, i_top = L.heap[0]
        if t_first is None:
            t_first = t0 + (m_top - S0) / share
        if t_cal <= t_first:
            return 0
        jb_top = job_of[i_top]
        if hd_col[i_top]:
            return 0
        if jb_top.gated is None:
            p = jb_top.ptr
            if p >= len(jb_top.order) or jb_top.rdy[p] > t_first:
                return 0
        else:
            _drain(jb_top, t0)
            if not jb_top.n_ready:
                return 0
        # every heap-mode job's gating boundary caps the whole window
        # (commits stop at the earliest gate), so if any gate precedes
        # the first completion the call cannot commit — an O(jobs)
        # rejection that keeps gate-dense phases (jittered plans) cheap
        for _m_x, i_x in L.heap:
            jx = job_of[i_x]
            if jx.gated is not None:
                _drain(jx, t0)
                if (jx.gptr < jx.g_rd.shape[0]
                        and jx.g_rd[jx.gptr] <= t_first):
                    L.bulk_skip = 4     # locally gate-dense: go scalar
                    return 0
        # no mark beyond this can commit (commit times are < t_cal), so
        # chains truncate here before the merge sort — a truncation is
        # just an earlier artificial boundary, never an arithmetic
        # change, and the next call continues the same cumsum exactly
        mark_limit = S0 + (t_cal - t0) * share
        chains = []
        mark_segs = []
        id_segs = []
        for m0, i0 in L.heap:
            jb = job_of[i0]
            if jb.link is not L:
                return 0
            if jb.wk is None:
                onp = jb.onp
                if onp is None:
                    onp = jb.onp = np.asarray(jb.order, dtype=np.intp)
                jb.wk = g_wk[onp]
                jb.rd = rd_np[onp]
                jb.hd = g_hd[onp]
                jb.lt = g_lt[onp]
            kcap = L.bulk_cap
            if jb.gated is None:
                ptr = jb.ptr
                k = len(jb.order) - ptr
                if k > kcap:
                    k = kcap
                ids = np.empty(k + 1, dtype=np.intp)
                ids[0] = i0
                ids[1:] = jb.onp[ptr:ptr + k]
                marks = np.empty(k + 1)
                marks[0] = m0
                marks[1:] = jb.wk[ptr:ptr + k]
                pos = None
            else:
                # resolved prefix: the admissible mask in service order
                # (this job was already drained by the gate pre-check)
                pos = jb.readyq.nonzero()[0]
                k = pos.shape[0]
                if k > kcap:
                    k = kcap
                    pos = pos[:k]
                ids = np.empty(k + 1, dtype=np.intp)
                ids[0] = i0
                ids[1:] = jb.onp[pos]
                marks = np.empty(k + 1)
                marks[0] = m0
                marks[1:] = jb.wk[pos]
            marks = marks.cumsum()          # exact left fold, like scalar
            if marks.shape[0] > 8:
                kk = int(marks.searchsorted(mark_limit,
                                            side="right")) + 2
                if kk < marks.shape[0]:
                    marks = marks[:kk]
                    ids = ids[:kk]
                    if pos is not None:
                        pos = pos[:kk - 1]
            chains.append((jb, m0, i0, marks, ids, pos))
            mark_segs.append(marks)
            id_segs.append(ids)
        # merge all chains into global service order (ties break on the
        # flow index, exactly like the link heap's (mark, i) tuples),
        # then chain completion times with the scalar spin's own
        # arithmetic: t_{j} = t_{j-1} + (m_j - m_{j-1}) / share
        M = np.concatenate(mark_segs)
        I = np.concatenate(id_segs)
        order_g = np.lexsort((I, M))
        Ms = M[order_g]
        d = np.empty_like(Ms)
        d[0] = t_first
        if Ms.shape[0] > 1:
            d[1:] = (Ms[1:] - Ms[:-1]) / share
        times_sorted = d.cumsum()
        times_flat = np.empty_like(times_sorted)
        times_flat[order_g] = times_sorted
        t_stop = t_cal
        metas = []
        off = 0
        for jb, m0, i0, marks, ids, pos in chains:
            n_j = marks.shape[0]
            times = times_flat[off:off + n_j]
            off += n_j
            k = n_j - 1                     # future flows in the chain
            if jb.gated is None:
                ptr = jb.ptr
                if k:
                    viol = ((jb.rd[ptr:ptr + k] > times[:k])
                            | jb.hd[ptr - 1:ptr + k - 1])
                    nz = viol.nonzero()[0]
                    v = int(nz[0]) + 1 if nz.size else k + 1
                else:
                    v = 1
                bt = times[v - 1]           # this job's boundary time
            else:
                if k:
                    hd_prev = g_hd[ids[:k]]
                    nz = hd_prev.nonzero()[0]
                    v = int(nz[0]) + 1 if nz.size else k + 1
                    bt = times[v - 1]
                    # gating boundary: a commit window reaching the
                    # next gated ready time would let a fresh flow
                    # preempt the resolved prefix
                    gp = jb.gptr
                    if gp < jb.g_rd.shape[0]:
                        tg = jb.g_rd[gp]
                        if tg < bt:
                            bt = tg
                else:
                    v = 1
                    bt = times[0]
            if bt < t_stop:
                t_stop = bt
            metas.append((jb, m0, i0, marks, times, v, ids, pos))
        total = 0
        entries = []
        for jb, m0, i0, marks, times, v, ids, pos in metas:
            c = int(times[:v].searchsorted(t_stop, side="left"))
            if c == 0:
                entries.append((m0, i0))
                continue
            tc = times[:c]
            idc = ids[:c]
            if c > 1:
                start[ids[1:c]] = tc[:-1]
            wire[idc] = tc
            if jb.gated is None:
                ptr = jb.ptr
                end[idc] = tc + jb.lt[ptr - 1:ptr + c - 1]
                ia = jb.order[ptr + c - 1]  # the job's new active flow
                jb.ptr = ptr + c
            else:
                end[idc] = tc + g_lt[idc]
                ia = int(ids[c])
                # consume the committed prefix plus the new active flow
                # (``ids[1:] = onp[pos]``, so ``ia`` sits at ``pos[c-1]``)
                jb.readyq[pos[:c]] = False
                jb.n_ready -= c
                jb.apos = int(pos[c - 1])
            contended[idc] = True
            tl = float(tc[-1])
            start[ia] = tl
            contended[ia] = True
            entries.append((float(marks[c]), ia))
            total += c
        if not total:
            return 0
        L.heap = entries
        heapify(entries)
        # final link state = exactly the scalar spin's after serving
        # the last committed completion of the merged sequence
        n_commit = int(times_sorted.searchsorted(t_stop, side="left"))
        L.S = float(Ms[n_commit - 1])
        L.t_last = float(times_sorted[n_commit - 1])
        L.version += 1
        # geometric cap adaptation: big commits earn longer chains next
        # call, near-empty windows shrink the per-call numpy work
        nc = 2 * total
        L.bulk_cap = (_BULK_CHAIN_CAP if nc > _BULK_CHAIN_CAP
                      else nc if nc > 32 else 32)
        if total < 4 * L.n:
            L.bulk_skip = 64    # window too small to pay numpy setup
        n_done += total
        stale = 0               # bulk-committed work is progress
        return total

    # -- multi-link bulk window: retire saturated stretches across all
    # eligible links per window, not one ``_try_bulk(L, t)`` at a time ------
    def _bulk_window(L: _Link, t0: float) -> int:
        """Park other links' valid projected completions at the front of
        the calendar when those links are themselves bulk-eligible and
        *self-contained* (every job in their heap runs entirely on them,
        so nothing they commit can admit work on another link — any
        cross-link effect would arrive as a calendar event, which then
        fences the window).  The shared fence ``t_cal`` is the first
        non-parkable event; ``L`` and every parked link each retire their
        stretch against it.  A parked link's first completion is served at
        the exact time its calendar entry carried (the scalar loop's
        arithmetic, clamping included); an entry whose link commits
        nothing is re-pushed *unchanged* — same seq, same tie order."""
        nonlocal seq
        parked = []
        while cal:
            ev = cal[0]
            if ev[1] != _DONE:
                break
            L2 = ev[4]
            if ev[3] != L2.version:
                heappop(cal)        # lazily-invalidated projection
                continue
            if L2 is L or L2.n < _BULK_MIN_ACTIVE or L2.bulk_skip:
                break
            contained = True
            for _m, i in L2.heap:
                if job_of[i].link is not L2:
                    contained = False
                    break
            if not contained:
                break
            heappop(cal)
            parked.append(ev)
        t_cal = cal[0][0] if cal else _INF
        total = _try_bulk(L, t0, t_cal)
        for ev in parked:
            L2 = ev[4]
            if ev[3] != L2.version:
                continue            # defensive; parked links are disjoint
            if _try_bulk(L2, L2.t_last, t_cal, ev[0]):
                # bulk preserves membership (every completion re-admits),
                # so L2 still has a next completion to project
                seq += 1
                proj2 = L2.t_last + (L2.heap[0][0] - L2.S) / L2.share
                if proj2 < L2.t_last:
                    proj2 = L2.t_last
                heappush(cal, (proj2, _DONE, seq, L2.version, L2))
            else:
                heappush(cal, ev)
        return total

    while n_done < n_total:
        if not cal:
            raise RuntimeError(
                f"event engine stalled: {n_done}/{n_total} flows done "
                "with an empty calendar")
        ev = heappop(cal)
        t = ev[0]

        if ev[1] == _DONE:
            ver, L = ev[3], ev[4]
            if ver != L.version or not L.n:
                stale += 1      # lazily-invalidated projection
                if stale > stall_limit:
                    raise RuntimeError(
                        "event engine made no progress over "
                        f"{stale} events ({n_done}/{n_total} flows done)")
                if len(cal) > sweep_at:
                    # batched stale sweep: one filter pass + heapify
                    # beats popping invalidated projections one by one
                    # (non-_DONE entries carry no link/version to check)
                    cal[:] = [e for e in cal if e[1] != _DONE
                              or e[3] == e[4].version]
                    heapify(cal)
                    sweep_at = max(256, 2 * len(cal))
                continue
            stale = 0
            # ---- completion spin: serve this link's completions while
            # they precede everything else on the calendar ------------------
            while True:
                if t > L.t_last:
                    L.S += (t - L.t_last) * L.share
                L.t_last = t
                s_top, i = heappop(L.heap)
                L.S = s_top
                L.n -= 1
                L.version += 1
                if L.n:
                    c = L.cap
                    L.share = 1.0 if c >= L.n else c / L.n
                else:
                    L.all_contended = False
                if contended[i]:
                    w = t
                    e = t + lt_col[i]
                else:
                    # exact closed form: share was 1.0 throughout
                    w = float(start[i]) + wk_col[i]
                    d = du_col[i]
                    if hd_col[i] and d == d:    # NaN = no duration
                        e = float(start[i]) + d
                    else:
                        e = w + lt_col[i]
                wire[i] = w
                end[i] = e
                n_done += 1
                jb = job_of[i]
                jb.busy = False
                jb.free = e if hd_col[i] else w
                # instant re-admission keeps the spin going (the
                # saturated steady state); anything else goes back
                # through the calendar
                readmitted = None
                if not hd_col[i]:
                    if jb.gated is None:
                        p = jb.ptr
                        if p < len(jb.order) and jb.rdy[p] <= t:
                            jb.ptr = p + 1
                            readmitted = _admit(jb.order[p], jb, t)
                    else:
                        _drain(jb, t)
                        if jb.n_ready:
                            # first set bit = best (priority, op_id)
                            p = int(jb.readyq.argmax())
                            jb.readyq[p] = False
                            jb.n_ready -= 1
                            jb.apos = p
                            readmitted = _admit(jb.order[p], jb, t)
                if readmitted is None:
                    _schedule_admit(jb, t)
                elif readmitted is not L:
                    # cross-link re-admission: project the other link
                    seq += 1
                    s2 = readmitted.heap[0][0]
                    proj2 = t + (s2 - readmitted.S) / readmitted.share
                    heappush(cal, (proj2 if proj2 > t else t, _DONE,
                                   seq, readmitted.version, readmitted))
                if not L.n:
                    break
                if L.n >= _BULK_MIN_ACTIVE:
                    if L.bulk_skip:
                        L.bulk_skip -= 1
                    elif _bulk_window(L, t):
                        t = L.t_last
                        if not L.n:
                            break
                proj = t + (L.heap[0][0] - L.S) / L.share
                if proj < t:
                    proj = t
                if cal and cal[0][0] < proj:
                    seq += 1
                    heappush(cal, (proj, _DONE, seq, L.version, L))
                    break
                t = proj
            continue

        if ev[1] == _FAULT or ev[1] == _RETX:
            # ---- membership change / retransmission timeout: apply to
            # every matched job (retx shares the fault handler — its kind
            # never matches the "drop" cancellation gate, so it reduces to
            # pull-back + backoff stall)
            for jb in ev[3]:
                _apply_fault(jb, ev[4], t)
            continue

        # ---- admission event ----------------------------------------------
        jb = ev[3]
        if jb.busy:
            stale += 1          # superseded by an instant re-admission
            if stale > stall_limit:
                raise RuntimeError(
                    "event engine made no progress over "
                    f"{stale} events ({n_done}/{n_total} flows done)")
            continue
        if jb.free > t:         # defensive: fire again once free
            stale += 1
            _schedule_admit(jb, t)
            continue
        stale = 0               # a serviced admission trigger is progress
        admitted = None
        if jb.gated is None:
            p = jb.ptr
            if p < len(jb.order):
                if jb.rdy[p] <= t:
                    jb.ptr = p + 1
                    admitted = _admit(jb.order[p], jb, t)
                else:
                    _schedule_admit(jb, t)
        else:
            _drain(jb, t)
            if jb.n_ready:
                p = int(jb.readyq.argmax())
                jb.readyq[p] = False
                jb.n_ready -= 1
                jb.apos = p
                admitted = _admit(jb.order[p], jb, t)
            elif jb.gptr < jb.g_rd.shape[0]:
                _schedule_admit(jb, t)
        if admitted is not None:
            seq += 1
            s_top = admitted.heap[0][0]
            proj = t + (s_top - admitted.S) / admitted.share
            heappush(cal, (proj if proj > t else t, _DONE, seq,
                           admitted.version, admitted))

    return start, wire, end, contended





