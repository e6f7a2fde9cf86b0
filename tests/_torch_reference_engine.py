"""The seed event engine over the port's ``repro_torch.core.events``: a copy
of ``tests/_reference_engine.py`` with only its one import changed, so that
``benchmarks/torch_sweep_bench.py`` measures the port's engine against the
seed's semantics without importing the JAX package.

This is the pre-heap ``NetworkEngine.run`` loop exactly as it shipped in
the seed ``repro.core.events`` — it rescans every pending/running flow at
every event, pops from list middles, and advances all wires on each step.
It is O(n^2)-ish and kept *only* so that:

- the property tests in ``test_events_equivalence.py`` can pit the indexed
  heap engine against the original semantics on randomized flow sets, and
- ``benchmarks/torch_sweep_bench.py`` can measure the speedup honestly against
  the behaviour the golden artifacts were produced with.

Do not "fix" or optimize this file; its value is being frozen.  The one
permitted deviation is ``max_iters_factor``: the seed's convergence
heuristic (``10 * n + 100`` iterations) can false-trip on heavily
contended multi-job plans, so callers that stress it may raise the factor
without changing any arithmetic.
"""
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.events import FlowResult, FlowSpec


class _Run:
    __slots__ = ("flow", "start", "remaining", "contended")

    def __init__(self, flow: FlowSpec, start: float):
        self.flow = flow
        self.start = start
        self.remaining = flow.work
        self.contended = False


class ReferenceNetworkEngine:
    """The seed engine: list rescans + stepwise wire advancement."""

    def __init__(self, capacities: Optional[Dict[str, float]] = None,
                 max_iters_factor: int = 10):
        self.capacities = dict(capacities or {})
        self.max_iters_factor = max_iters_factor

    def _share(self, link: str, n_active: int) -> float:
        cap = self.capacities.get(link, 1.0)
        return min(1.0, cap / n_active) if n_active else 1.0

    def run(self, flows: Sequence[FlowSpec]) -> List[FlowResult]:
        """Execute ``flows``; returns results in input order."""
        pending: Dict[str, List[FlowSpec]] = {}
        for f in flows:
            pending.setdefault(f.job, []).append(f)
        for q in pending.values():
            # stable service order: (priority, op_id); ready gates admission
            q.sort(key=lambda f: (f.priority, f.op_id), reverse=True)

        job_free: Dict[str, float] = {j: 0.0 for j in pending}
        running: Dict[str, _Run] = {}          # job -> active wire
        on_link: Dict[str, List[_Run]] = {}
        results: Dict[int, FlowResult] = {}
        t = 0.0
        n_total = len(flows)
        max_iters = self.max_iters_factor * n_total + 100

        def _pick(job: str) -> Optional[FlowSpec]:
            """Highest-priority flow of ``job`` that is ready at ``t``."""
            q = pending[job]
            best_i = -1
            for i in range(len(q) - 1, -1, -1):  # sorted reverse: best last
                if q[i].ready <= t:
                    best_i = i
                    break
            if best_i < 0:
                return None
            return q.pop(best_i)

        iters = 0
        while len(results) < n_total:
            iters += 1
            if iters > max_iters:
                raise RuntimeError("event engine failed to converge "
                                   f"({len(results)}/{n_total} flows done)")

            # -- admissions at the current time ------------------------------
            admitted = False
            for job in pending:
                if job in running or job_free[job] > t or not pending[job]:
                    continue
                flow = _pick(job)
                if flow is None:
                    continue
                run = _Run(flow, start=t)
                active = on_link.setdefault(flow.link, [])
                if active:
                    run.contended = True
                    for other in active:
                        other.contended = True
                if self._share(flow.link, 1) < 1.0:
                    # a link with fractional capacity never runs a flow at
                    # full rate, so the closed-form completion is invalid
                    run.contended = True
                active.append(run)
                running[job] = run
                admitted = True
            if admitted:
                continue  # shares changed; recompute projections

            # -- next event: a wire completion or a job becoming serviceable -
            t_next = None
            for run in running.values():
                share = self._share(run.flow.link, len(on_link[run.flow.link]))
                proj = t + run.remaining / share
                if t_next is None or proj < t_next:
                    t_next = proj
            for job, q in pending.items():
                if job in running or not q:
                    continue
                earliest = min(f.ready for f in q)
                trigger = max(job_free[job], earliest)
                if t_next is None or trigger < t_next:
                    t_next = trigger
            if t_next is None:
                raise RuntimeError("event engine stalled with pending flows")
            t_next = max(t_next, t)

            # -- advance all running wires to t_next -------------------------
            dt = t_next - t
            done: List[Tuple[str, _Run]] = []
            for job, run in running.items():
                share = self._share(run.flow.link, len(on_link[run.flow.link]))
                run.remaining -= dt * share
                # done when the residual is negligible — or too small to
                # advance the clock at all (absorbed below ulp(t_next)),
                # which would otherwise stall the loop
                if (run.remaining <= run.flow.work * 1e-12 + 1e-18
                        or t_next + run.remaining / share <= t_next):
                    done.append((job, run))
            t = t_next

            for job, run in done:
                flow = run.flow
                if not run.contended:
                    # exact closed form: share was 1.0 throughout
                    wire_end = run.start + flow.work
                    if flow.hold and flow.duration is not None:
                        end = run.start + flow.duration
                    else:
                        end = wire_end + flow.latency
                else:
                    wire_end = t
                    end = wire_end + flow.latency
                results[flow.op_id] = FlowResult(
                    flow.op_id, job, run.start, wire_end, end, run.contended)
                on_link[flow.link].remove(run)
                del running[job]
                job_free[job] = end if flow.hold else wire_end

        return [results[f.op_id] for f in flows]


def run_reference_flows(flows: Sequence[FlowSpec],
                        capacities: Optional[Dict[str, float]] = None,
                        max_iters_factor: int = 10) -> List[FlowResult]:
    """Convenience wrapper: execute ``flows`` on a fresh reference engine."""
    return ReferenceNetworkEngine(capacities, max_iters_factor).run(flows)
