"""Sweep-engine performance benchmark of the port's simulator
(``repro_torch.core``, ``repro_torch.experiments``): the counterpart of
``benchmarks/sweep_bench.py``, metric for metric.

The simulator is numpy on the host: every number here is the host CPU's
(its model is recorded in the JSON as ``cpu_model``), not the GPU's.

Writes these metrics to ``artifacts/bench/BENCH_sweep_torch.json``:

- **sweep_cells_per_sec** — end-to-end simulator throughput over a fixed
  mixed grid (models x bandwidths x schedulers x contention), run serially
  so the number is executor-independent and comparable across commits;
- **engine_events_per_sec / stress_speedup_vs_seed** — the discrete-event
  engine on the stress workload the engine's acceptance pins (8 contending
  jobs x chunked ``n_chunks=32`` -> thousands of flows on one fair-share
  link), against the retained seed engine
  (``tests/_torch_reference_engine.py``, the seed engine over the port's
  ``FlowSpec``); the engine consumes its native
  columnar input (``run_flow_batch``, no tuple materialization);
- **lowering_ms / xxl_lowering_ms** — the columnar lowering phase alone
  (``plan_to_flow_batch`` + per-job relabel/jitter + concat) for the
  stress workload and the xxl cell: the stage the structure-of-arrays
  pipeline collapsed from per-op NamedTuple rebuilds to column copies;
- **heap_stress_speedup_vs_seed** — the same 8-job stress under the
  *priority* scheduler, whose regressed ready order forces every job into
  heap mode: this pins the heap-mode bulk-commit fast path (resolved
  prefixes), which the CI gate holds to a hard speedup floor;
- **xxl_cell_ms** — one full ``simulate_contention`` call on the heaviest
  ``xxl-contention`` golden cell (16 VGG16 jobs x priority ``k=64`` with
  flush jitter, >18k flows), end to end through the lowering;
- **fabric_cell_ms** — one contended fabric cell (4 VGG16 jobs on a 4:1
  Clos fabric) end to end: the multi-link max-min event loop
  (``NetworkEngine._run_maxmin``) re-solving the rate vector at every
  membership change, through the same ``simulate_contention`` entry the
  ``fabric`` golden grid uses;
- **wan_cell_ms** — the lossiest hot cell of the gated ``wan`` grid
  (ResNet-50, priority + int8 at 10 Gbps over ``loss=0.05, rtt=20``):
  the lossy-transport lowering (goodput inflation + RTT) plus seeded
  retransmission stalls through the ``_RETX`` calendar machinery,
  end to end through ``simulate``;
- **fastpath_speedup** — the closed-form fifo path in
  ``repro_torch.core.simulator`` against the event engine on a long serialized
  plan;
- **small_plan_us** — one engine call on a paper-sized (two-dozen-flow)
  plan, the regime where per-run setup cost dominates: this is what the
  plain-list small-plan setup in ``repro_torch.core.events`` optimizes, and what
  every sub-fastpath-threshold cell of a sweep pays per call.

Usage::

    python benchmarks/torch_sweep_bench.py              # full, writes JSON
    python benchmarks/torch_sweep_bench.py --quick      # fewer reps
    python benchmarks/torch_sweep_bench.py --quick --out /tmp/b.json \
        --baseline artifacts/bench/BENCH_sweep_torch.json   # regression gate

With ``--baseline``, exits non-zero when sweep throughput regresses more
than :data:`REGRESSION_FACTOR` x against the committed baseline, the
heap-mode stress speedup falls below :data:`HEAP_SPEEDUP_FLOOR`, the xxl
worst cell exceeds :data:`XXL_CELL_MS_CEILING`, or chunked-stress engine
throughput falls below :data:`ENGINE_EVENTS_FLOOR` (the CI ``bench``
job's gates).  Absolute cells/sec is machine-dependent, so the
throughput gate compares *machine-normalized* numbers: the retained seed
engine is frozen code, so its measured stress time on the same run is a
pure machine-speed probe, and ``cells_per_sec * stress_seed_ms`` (cells
per unit of seed-engine work) cancels hardware speed out of the
comparison.  The speedup floors are same-run ratios and need no
normalization.
"""
from __future__ import annotations

import argparse
import gc
import json
import platform
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))
sys.path.insert(0, str(REPO_ROOT / "tests"))   # the seed engine, over the port

SCHEMA_VERSION = 1
KIND = "repro-torch-sweep-bench"
REGRESSION_FACTOR = 2.0
# hard floor on the heap-mode (priority) stress speedup vs the seed engine:
# a same-run ratio, so machine speed cancels out of the gate
HEAP_SPEEDUP_FLOOR = 3.5
# columnar-pipeline acceptance bars, anchored to the baseline host: the
# gate scales the measured numbers by the same-run seed-engine probe ratio
# (stress_seed_ms is frozen code — a pure machine-speed probe), so a slow
# CI runner is judged as if it ran on the machine that wrote the baseline
XXL_CELL_MS_CEILING = 100.0     # worst xxl-contention cell, end to end
ENGINE_EVENTS_FLOOR = 5e6       # chunked-stress events/sec through run_batch
FABRIC_CELL_MS_CEILING = 50.0   # 4-job 4:1-fabric contention cell
WAN_CELL_MS_CEILING = 50.0      # lossiest wan-grid cell, end to end
DEFAULT_OUT = REPO_ROOT / "artifacts" / "bench" / "BENCH_sweep_torch.json"
DEFAULT_BASELINE = DEFAULT_OUT


# each timed rep runs the workload enough times to span this much wall
# time, so per-call and timer overheads amortize to noise
MIN_REP_SECONDS = 0.1


# a sample more than this factor above the run's fastest is a load burst
# (another tenant, a throttle step), not the code under test: wall-clock
# medians must reject those or a busy host flunks the speedup floors
_SPIKE_FACTOR = 1.5


def _measure(fn: Callable[[], None], reps: int) -> float:
    """Median-of-N per-call wall time via ``time.perf_counter_ns``.

    The previous ``process_time`` timer ticks as coarsely as 10 ms on
    some kernels, which visibly quantized the published metrics (e.g.
    ``engine_fifo_ms: 1.2999...`` — a lattice point, not a measurement)
    and made the CI gate compare rounding artifacts.  ``perf_counter_ns``
    is nanosecond-granular; a timeit-style autorange still grows an inner
    loop until one rep spans :data:`MIN_REP_SECONDS` so call overhead
    amortizes.  Wall clock sees noisy neighbours, so the estimator is a
    *spike-rejected median*: samples more than :data:`_SPIKE_FACTOR` x
    the run's fastest are discarded as external load (they measure the
    machine, not the code), and the median of the rest absorbs what
    remains — a mean would inherit the spikes, a plain best-of would
    under-report a machine that throttles mid-run."""
    was_enabled = gc.isenabled()
    gc.disable()                    # like timeit: GC pauses are not the code
    try:
        inner = 1
        while True:
            t0 = time.perf_counter_ns()
            for _ in range(inner):
                fn()
            dt = (time.perf_counter_ns() - t0) / 1e9
            if dt >= MIN_REP_SECONDS:
                break
            inner *= 10 if dt <= 0.0 else min(10, max(
                2, int(MIN_REP_SECONDS / dt) + 1))
        samples = [dt / inner]
        for _ in range(max(reps, 5) - 1):
            t0 = time.perf_counter_ns()
            for _ in range(inner):
                fn()
            samples.append((time.perf_counter_ns() - t0) / 1e9 / inner)
        floor = min(samples)
        kept = [s for s in samples if s <= floor * _SPIKE_FACTOR]
        return statistics.median(kept)
    finally:
        if was_enabled:
            gc.enable()
        gc.collect()


def _stress_plan(n_chunks: int = 32, scheduler: str = "chunked"):
    """One VGG16 job's plan + cost for the stress workload."""
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.addest import AddEst
    from repro_torch.core.network_model import RingAllReduce
    from repro_torch.core.schedule import lower_buckets
    from repro_torch.core.simulator import fuse_buckets
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS, get_transport

    tl = from_cnn("vgg16")
    tr = get_transport("horovod_tcp")
    cost = RingAllReduce(64, tr.effective(25 * GBPS), AddEst.v100())
    buckets = [(b.flush_time, b.size, b.n_tensors)
               for b in fuse_buckets(tl, CommConfig())]
    plan = lower_buckets(buckets, scheduler=scheduler, n_chunks=n_chunks)
    return plan, cost, tr


def _stress_flows(jobs: int = 8, n_chunks: int = 32,
                  scheduler: str = "chunked"):
    """The acceptance stress workload: ``jobs`` identical VGG16 trainings
    under ``scheduler`` at ``n_chunks`` chunks/bucket, contending for one
    fair-share link.  ``chunked`` keeps every job in pointer mode;
    ``priority`` regresses each job's ready order and forces heap mode."""
    from repro_torch.core.schedule import plan_to_flows

    plan, cost, tr = _stress_plan(n_chunks, scheduler)
    flows, base = [], 0
    for j in range(jobs):
        fl = plan_to_flows(plan, cost, tr.per_tensor_overhead,
                           job=f"job{j}", op_id_base=base)
        base += len(fl)
        flows.extend(fl)
    return flows


def _lower_stress_batch(plan, cost, tr, jobs: int = 8):
    """The stress workload lowered columnar from a prebuilt plan: one
    ``plan_to_flow_batch`` call, relabeled per job and concatenated — the
    exact shape ``simulate_contention`` feeds the engine.  This is the
    stage ``lowering_ms`` prices."""
    from repro_torch.core.events import concat_batches
    from repro_torch.core.schedule import plan_to_flow_batch

    b0 = plan_to_flow_batch(plan, cost, tr.per_tensor_overhead)
    parts, base = [], 0
    for j in range(jobs):
        parts.append(b0.relabel(base, f"job{j}"))
        base += b0.n
    return concat_batches(parts)


def _engine_vs_seed(flows, batch, reps: int, prefix: str) -> Dict[str, float]:
    """Engine (columnar input, its native shape since the SoA lowering)
    vs the retained seed engine (tuple input — frozen code) on the same
    workload.  ``<prefix>_lowering_ms`` prices producing that columnar
    input from the already-built plan (lower + relabel + concat), the
    other half of a contention cell's cost."""
    from repro_torch.core.events import run_flow_batch, run_flows
    from _torch_reference_engine import run_reference_flows

    assert len(flows) >= 2000, "stress workload must be >= 2000 flows"
    # correctness cross-check before timing anything: seed engine vs the
    # columnar engine on the columnar input
    ref = run_reference_flows(flows, max_iters_factor=100)
    new = run_flow_batch(batch).to_results()
    worst = max(abs(a.end - b.end) / max(abs(a.end), 1e-12)
                for a, b in zip(ref, new))
    if worst > 1e-9:
        raise RuntimeError(f"engine diverges from seed by {worst:.2e}")
    tuple_results = run_flows(flows)
    if any(a.end != b.end for a, b in zip(tuple_results, new)):
        raise RuntimeError("tuple-input engine path diverges from columnar")
    t_new = _measure(lambda: run_flow_batch(batch), reps)
    t_ref = _measure(lambda: run_reference_flows(flows,
                                                 max_iters_factor=100), reps)
    n = len(flows)
    return {
        f"{prefix}_flows": float(n),
        f"{prefix}_seed_ms": t_ref * 1e3,
        f"{prefix}_engine_ms": t_new * 1e3,
        f"{prefix}_speedup_vs_seed": t_ref / t_new,
    }


def bench_engine(reps: int) -> Dict[str, float]:
    flows = _stress_flows()
    plan, cost, tr = _stress_plan()
    batch = _lower_stress_batch(plan, cost, tr)
    m = _engine_vs_seed(flows, batch, reps, "stress")
    n = len(flows)
    t_new = m["stress_engine_ms"] / 1e3
    m["engine_flows_per_sec"] = n / t_new
    # each flow is one admission plus one completion event
    m["engine_events_per_sec"] = 2 * n / t_new
    m["lowering_ms"] = _measure(
        lambda: _lower_stress_batch(plan, cost, tr), reps) * 1e3
    return m


def bench_heap_engine(reps: int) -> Dict[str, float]:
    """Heap-mode stress: the same 8 jobs at priority k=32.

    The priority scheduler regresses ready times along each job's service
    order, so every job runs gated/heap admission — the path the heap-mode
    bulk commit vectorizes.  The CI gate pins
    ``heap_stress_speedup_vs_seed >= HEAP_SPEEDUP_FLOOR``."""
    flows = _stress_flows(scheduler="priority")
    plan, cost, tr = _stress_plan(scheduler="priority")
    batch = _lower_stress_batch(plan, cost, tr)
    m = _engine_vs_seed(flows, batch, reps, "heap_stress")
    n = len(flows)
    m["heap_engine_events_per_sec"] = 2 * n / (m["heap_stress_engine_ms"]
                                               / 1e3)
    return m


def bench_xxl_cell(reps: int) -> Dict[str, float]:
    """One full xxl-contention worst cell, end to end.

    16 co-located VGG16 jobs, priority at 64 chunks/bucket, 2 ms flush
    jitter, 25 Gbps measured transport — the heaviest cell of the gated
    ``xxl-contention`` grid (>18k flows through one fair-share link),
    including bucket fusion, lowering, and result assembly.
    ``xxl_lowering_ms`` isolates the cell's columnar lowering phase (one
    ``plan_to_flow_batch`` + 16 relabel/jitter passes + concat), the part
    the structure-of-arrays pipeline took from ~40% of cell time to
    column copies."""
    from repro_torch.core.events import concat_batches, perturb_batch
    from repro_torch.core.schedule import plan_to_flow_batch
    from repro_torch.core.simulator import simulate_contention
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS

    tl = from_cnn("vgg16")

    def cell():
        simulate_contention([tl] * 16, n_workers=64, bandwidth=25 * GBPS,
                            scheduler="priority", n_chunks=64,
                            jitter=0.002, jitter_seed=2026)

    t = _measure(cell, reps)

    plan, cost, tr = _stress_plan(n_chunks=64, scheduler="priority")

    def lower_cell():
        b0 = plan_to_flow_batch(plan, cost, tr.per_tensor_overhead)
        parts, base = [], 0
        for j in range(16):
            bj = perturb_batch(b0.relabel(base, f"job{j}"), 0.002, 2026,
                               stream=j)
            base += bj.n
            parts.append(bj)
        concat_batches(parts)

    t_lower = _measure(lower_cell, reps)
    return {"xxl_cell_ms": t * 1e3, "xxl_lowering_ms": t_lower * 1e3}


def bench_fabric_cell(reps: int) -> Dict[str, float]:
    """One contended fabric cell: 4 VGG16 jobs on a 4:1 Clos fabric.

    Every job's flows carry the nic + 4x-uplink path, so the engine runs
    the multi-link max-min loop (rate vector re-solved at each
    admission/completion) instead of the indexed single-link calendar —
    the priced regime the ``fabric`` golden grid gates.  The CI bar
    holds ``fabric_cell_ms`` under :data:`FABRIC_CELL_MS_CEILING` on the
    baseline host (seed-probe normalized, like the xxl ceiling)."""
    from repro_torch.core.simulator import simulate_contention
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS

    tl = from_cnn("vgg16")

    def cell():
        simulate_contention([tl] * 4, n_workers=64, bandwidth=10 * GBPS,
                            transport="ideal", fabric="clos",
                            oversubscription=4.0)

    return {"fabric_cell_ms": _measure(cell, reps) * 1e3}


def bench_wan_cell(reps: int) -> Dict[str, float]:
    """The lossiest hot cell of the gated ``wan`` grid, end to end.

    ResNet-50 under priority + int8 at 10 Gbps over a
    ``loss=0.05, rtt=20`` link (the grid's ``fault_seed=2029``): every
    flow pays the ``1/(1-loss)`` goodput inflation and the RTT through
    the lossy lowering, and the seeded retransmission draws land as
    ``_RETX`` calendar stalls — the bulk-commit fences the fault axes
    introduced, now on the loss path.  The CI bar holds ``wan_cell_ms``
    under :data:`WAN_CELL_MS_CEILING` on the baseline host (seed-probe
    normalized, like the xxl and fabric ceilings)."""
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS

    tl = from_cnn("resnet50")

    def cell():
        simulate(tl, n_workers=64, bandwidth=10 * GBPS,
                 transport="horovod_tcp", scheduler="priority", n_chunks=8,
                 codec="int8", fault_seed=2029,
                 link_profile="wan:loss=0.05,rtt=20")

    return {"wan_cell_ms": _measure(cell, reps) * 1e3}


def bench_sweep(reps: int) -> Dict[str, float]:
    from repro_torch.experiments import run_spec
    from repro_torch.experiments.spec import ExperimentSpec

    spec = ExperimentSpec(
        name="bench-sweep", models=("resnet50", "vgg16"),
        n_servers=(2, 8), bandwidth_gbps=(5.0, 25.0, 100.0),
        transport=("ideal", "horovod_tcp"),
        scheduler=("fifo", "priority", "chunked"), sched_chunks=16)
    contention = ExperimentSpec(
        name="bench-contention", models=("vgg16",), n_servers=(8,),
        bandwidth_gbps=(25.0,), transport=("horovod_tcp",),
        scheduler=("chunked",), n_jobs=(1, 2, 4, 8), sched_chunks=32)
    n_cells = spec.n_cells + contention.n_cells
    t = _measure(lambda: (run_spec(spec, executor="serial"),
                          run_spec(contention, executor="serial")), reps)
    return {
        "sweep_cells": float(n_cells),
        "sweep_seconds": t,
        "sweep_cells_per_sec": n_cells / t,
    }


def bench_fastpath(reps: int) -> Dict[str, float]:
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.addest import AddEst
    from repro_torch.core.events import run_flows
    from repro_torch.core.network_model import RingAllReduce
    from repro_torch.core.schedule import lower_buckets, plan_to_flows
    from repro_torch.core.simulator import _fifo_fast_results, fuse_buckets
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS, get_transport

    # a small fusion buffer makes a long serialized fifo plan
    tl = from_cnn("vgg16")
    tr = get_transport("horovod_tcp")
    cost = RingAllReduce(64, tr.effective(10 * GBPS), AddEst.v100())
    buckets = fuse_buckets(tl, CommConfig(fusion_buffer_mb=2.0))
    plan = lower_buckets([(b.flush_time, b.size, b.n_tensors)
                          for b in buckets], scheduler="fifo")
    flows = plan_to_flows(plan, cost, tr.per_tensor_overhead)
    fast = _fifo_fast_results(plan, flows)
    slow = run_flows(flows)
    if fast is None or any(a.end != b.end for a, b in zip(fast, slow)):
        raise RuntimeError("fifo fast path is not bit-exact with the engine")
    t_fast = _measure(lambda: _fifo_fast_results(plan, flows), reps)
    t_engine = _measure(lambda: run_flows(flows), reps)
    return {
        "fastpath_plan_ops": float(len(flows)),
        "fastpath_ms": t_fast * 1e3,
        "engine_fifo_ms": t_engine * 1e3,
        "fastpath_speedup": t_engine / t_fast,
    }


def bench_small_plan(reps: int) -> Dict[str, float]:
    from repro_torch.configs.base import CommConfig
    from repro_torch.core.addest import AddEst
    from repro_torch.core.events import run_flows
    from repro_torch.core.network_model import RingAllReduce
    from repro_torch.core.schedule import lower_buckets, plan_to_flows
    from repro_torch.core.simulator import fuse_buckets
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS, get_transport

    # a real paper cell's plan: vgg16 fifo at the default fusion buffer is
    # ~18 ops — below the simulator's closed-form threshold, so sweeps pay
    # one engine call (and its setup) for every such cell
    tl = from_cnn("vgg16")
    tr = get_transport("horovod_tcp")
    cost = RingAllReduce(64, tr.effective(100 * GBPS), AddEst.v100())
    plan = lower_buckets([(b.flush_time, b.size, b.n_tensors)
                          for b in fuse_buckets(tl, CommConfig())],
                         scheduler="fifo")
    flows = plan_to_flows(plan, cost, tr.per_tensor_overhead)
    # the columnar setup must never engage down here: paper-size plans
    # stay on the plain-list small-plan path (and below the simulator's
    # columnar dispatch threshold, which shares the same knob)
    from repro_torch.core.events import _SMALL_PLAN_MAX_FLOWS
    assert len(flows) < _SMALL_PLAN_MAX_FLOWS, (
        f"small-plan bench grew to {len(flows)} flows — no longer exercises"
        f" the sub-{_SMALL_PLAN_MAX_FLOWS} list path")
    t = _measure(lambda: run_flows(flows), reps)
    return {
        "small_plan_flows": float(len(flows)),
        "small_plan_us": t * 1e6,
    }


def cpu_model() -> str:
    """The host CPU's model name (``/proc/cpuinfo``), else ``platform``'s."""
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def run_bench(quick: bool) -> Dict:
    reps = 5 if quick else 9        # median-of-N; _measure floors N at 5
    metrics: Dict[str, float] = {}
    metrics.update(bench_sweep(reps))
    metrics.update(bench_engine(reps))
    metrics.update(bench_heap_engine(reps))
    metrics.update(bench_xxl_cell(reps))
    metrics.update(bench_fabric_cell(reps))
    metrics.update(bench_wan_cell(reps))
    metrics.update(bench_fastpath(reps))
    metrics.update(bench_small_plan(reps))
    return {
        "kind": KIND,
        "schema_version": SCHEMA_VERSION,
        "quick": quick,
        "python": platform.python_version(),
        "machine": platform.machine(),
        "cpu_model": cpu_model(),
        "metrics": metrics,
    }


def _normalized_throughput(metrics: Dict[str, float]) -> Optional[float]:
    """Sweep cells per unit of seed-engine work — machine-independent.

    ``stress_seed_ms`` measures frozen code, so it scales with the host's
    single-core speed exactly as the (serial, CPU-bound) sweep does;
    multiplying cancels the hardware out and the gate compares only what
    the *changed* code costs."""
    cells = metrics.get("sweep_cells_per_sec")
    probe = metrics.get("stress_seed_ms")
    if not cells or not probe:
        return None
    return cells * probe


def check_regression(result: Dict, baseline_path: Path) -> List[str]:
    try:
        base = json.loads(baseline_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot read baseline {baseline_path}: {e}"]
    if base.get("kind") != KIND:
        return [f"{baseline_path} is not a {KIND}"]
    failures = []
    old = _normalized_throughput(base["metrics"])
    new = _normalized_throughput(result["metrics"])
    if old and new and new < old / REGRESSION_FACTOR:
        failures.append(
            f"machine-normalized sweep throughput regressed "
            f">{REGRESSION_FACTOR}x: baseline {old:.0f} -> {new:.0f} "
            f"cells/sec x seed-ms (raw: "
            f"{base['metrics']['sweep_cells_per_sec']:.1f} -> "
            f"{result['metrics']['sweep_cells_per_sec']:.1f} cells/sec)")
    # speedup floors: same-run ratios, immune to host speed; the heap floor
    # is the heap-mode bulk-commit acceptance bar
    heap = result["metrics"].get("heap_stress_speedup_vs_seed")
    if heap is not None and heap < HEAP_SPEEDUP_FLOOR:
        failures.append(
            f"heap-mode stress speedup {heap:.2f}x fell below the "
            f"{HEAP_SPEEDUP_FLOOR}x floor (priority k=32, 8 jobs)")
    # columnar-pipeline bars: absolute on the baseline host, scaled to this
    # host by the frozen seed-engine probe so CI runner speed cancels out
    base_probe = base["metrics"].get("stress_seed_ms")
    new_probe = result["metrics"].get("stress_seed_ms")
    speed = (base_probe / new_probe) if base_probe and new_probe else 1.0
    xxl = result["metrics"].get("xxl_cell_ms")
    if xxl is not None and xxl * speed > XXL_CELL_MS_CEILING:
        failures.append(
            f"xxl worst cell {xxl:.1f} ms ({xxl * speed:.1f} ms normalized "
            f"to the baseline host) exceeds the "
            f"{XXL_CELL_MS_CEILING:.0f} ms ceiling")
    ev = result["metrics"].get("engine_events_per_sec")
    if ev is not None and ev / speed < ENGINE_EVENTS_FLOOR:
        failures.append(
            f"chunked-stress engine throughput {ev / 1e6:.2f} M events/s "
            f"({ev / speed / 1e6:.2f} M normalized to the baseline host) "
            f"fell below the {ENGINE_EVENTS_FLOOR / 1e6:.0f} M floor")
    fab = result["metrics"].get("fabric_cell_ms")
    if fab is not None and fab * speed > FABRIC_CELL_MS_CEILING:
        failures.append(
            f"fabric contention cell {fab:.1f} ms ({fab * speed:.1f} ms "
            f"normalized to the baseline host) exceeds the "
            f"{FABRIC_CELL_MS_CEILING:.0f} ms ceiling")
    wan = result["metrics"].get("wan_cell_ms")
    if wan is not None and wan * speed > WAN_CELL_MS_CEILING:
        failures.append(
            f"wan lossy cell {wan:.1f} ms ({wan * speed:.1f} ms "
            f"normalized to the baseline host) exceeds the "
            f"{WAN_CELL_MS_CEILING:.0f} ms ceiling")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmarks/torch_sweep_bench.py",
                                 description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="single-rep timings (CI)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output JSON path (default {DEFAULT_OUT})")
    ap.add_argument("--baseline", default=None,
                    help="baseline BENCH_sweep_torch.json to gate against "
                         f"(e.g. {DEFAULT_BASELINE.relative_to(REPO_ROOT)})")
    args = ap.parse_args(argv)

    result = run_bench(args.quick)
    m = result["metrics"]
    print(f"host CPU: {result['cpu_model']} (every number below is the host's: the "
          f"simulator is numpy)")
    print(f"sweep:   {m['sweep_cells']:.0f} cells in {m['sweep_seconds']:.2f}s"
          f" -> {m['sweep_cells_per_sec']:.1f} cells/sec")
    print(f"engine:  {m['stress_flows']:.0f} stress flows: seed "
          f"{m['stress_seed_ms']:.1f} ms -> engine {m['stress_engine_ms']:.1f}"
          f" ms ({m['stress_speedup_vs_seed']:.1f}x, "
          f"{m['engine_events_per_sec'] / 1e3:.0f}k events/sec)")
    print(f"heap:    {m['heap_stress_flows']:.0f} priority flows: seed "
          f"{m['heap_stress_seed_ms']:.1f} ms -> engine "
          f"{m['heap_stress_engine_ms']:.1f} ms "
          f"({m['heap_stress_speedup_vs_seed']:.1f}x, floor "
          f"{HEAP_SPEEDUP_FLOOR}x)")
    print(f"lower:   stress lowering {m['lowering_ms']:.2f} ms; xxl "
          f"lowering {m['xxl_lowering_ms']:.2f} ms (columnar)")
    print(f"xxl:     16-job priority k=64 jittered cell: "
          f"{m['xxl_cell_ms']:.1f} ms end to end "
          f"(ceiling {XXL_CELL_MS_CEILING:.0f} ms on the baseline host)")
    print(f"fabric:  4-job 4:1-fabric contention cell: "
          f"{m['fabric_cell_ms']:.1f} ms end to end "
          f"(ceiling {FABRIC_CELL_MS_CEILING:.0f} ms on the baseline host)")
    print(f"wan:     lossy hot cell (loss=0.05, priority+int8): "
          f"{m['wan_cell_ms']:.1f} ms end to end "
          f"(ceiling {WAN_CELL_MS_CEILING:.0f} ms on the baseline host)")
    print(f"fastpath: {m['fastpath_plan_ops']:.0f}-op fifo plan: engine "
          f"{m['engine_fifo_ms']:.2f} ms -> closed form "
          f"{m['fastpath_ms']:.2f} ms ({m['fastpath_speedup']:.1f}x)")
    print(f"small:   {m['small_plan_flows']:.0f}-flow paper plan: "
          f"{m['small_plan_us']:.1f} us/engine call")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1, sort_keys=True) + "\n")
    print(f"wrote {out}")

    if args.baseline:
        failures = check_regression(result, Path(args.baseline))
        if failures:
            for f in failures:
                print(f"FAIL: {f}")
            return 1
        print(f"no perf regression vs {args.baseline}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
