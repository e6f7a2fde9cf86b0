#!/usr/bin/env python
"""cProfile one grid cell of the port's experiment engine
(``repro_torch.experiments``) and dump the hottest functions: the
counterpart of ``tools/profile_engine.py``.

The port's sweep-engine perf trajectory is tracked by
``benchmarks/torch_sweep_bench.py``; when a number there moves, this tool says
*where* the time went.  It resolves a registered grid (or suite), expands
its cells, runs one cell under ``cProfile``, and prints the top functions
by cumulative time — the view that pins whether a regression lives in the
event engine, the lowering, or the experiment layer.

Usage::

    python tools/torch_profile_engine.py --grid xxl-contention --cell 47
    python tools/torch_profile_engine.py --grid paper-fig3 --cell 0 --top 30
    python tools/torch_profile_engine.py --grid xxl-contention --cell 47 --phases
    python tools/torch_profile_engine.py --grid xxl-contention --list

``--cell`` indexes the concatenation of every spec's expanded cells when
the name resolves to a suite.  ``--repeat`` runs the cell several times
under one profile so short cells rise above interpreter noise; the first
(unprofiled) run warms timeline caches, so the profile shows steady-state
cost, not import/build cost.

``--phases`` skips cProfile and prints a wall-clock breakdown of the
cell into the pipeline's stages — lower (plan -> flows/batch), perturb
(jitter), engine (event loop / closed form), collect (results -> bucket
spans) and other (fusion, plan build, assembly) — so a hillclimb sees
where time went without reading profiler output.
"""
from __future__ import annotations

import argparse
import cProfile
import pstats
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))


def _cells(grid: str) -> List[Tuple]:
    from repro_torch.experiments import grids
    out = []
    for spec in grids.resolve(grid):
        out.extend((spec, cell) for cell in spec.expand())
    return out


def _run_phases(spec, cell, repeat: int) -> Tuple[Dict[str, float], float]:
    """Time one cell with the simulator's pipeline stages instrumented.

    Wraps the functions the simulator module actually calls (its own
    globals, so ``from ... import`` binding is respected) with exclusive
    wall-clock accumulators; the serve wrappers subtract time already
    booked to nested stages, so the four phases plus ``other`` partition
    the cell's wall time."""
    from repro_torch.core import simulator as sim

    acc = {"lower": 0.0, "perturb": 0.0, "engine": 0.0, "collect": 0.0}
    saved = []

    def wrap(name: str, phase: str):
        orig = getattr(sim, name)

        def timed(*a, **k):
            t0 = time.perf_counter_ns()
            try:
                return orig(*a, **k)
            finally:
                acc[phase] += (time.perf_counter_ns() - t0) / 1e9

        saved.append((name, orig))
        setattr(sim, name, timed)

    def wrap_serve(name: str):
        orig = getattr(sim, name)

        def timed(*a, **k):
            t0 = time.perf_counter_ns()
            before = sum(acc.values())
            try:
                return orig(*a, **k)
            finally:
                nested = sum(acc.values()) - before
                acc["collect"] += ((time.perf_counter_ns() - t0) / 1e9
                                   - nested)

        saved.append((name, orig))
        setattr(sim, name, timed)

    for name in ("plan_to_flows", "plan_to_flow_batch", "clone_flows",
                 "concat_batches"):
        wrap(name, "lower")
    for name in ("perturb_flows", "perturb_batch"):
        wrap(name, "perturb")
    for name in ("run_flows", "run_flow_batch", "_fifo_fast_results",
                 "_fifo_fast_batch"):
        wrap(name, "engine")
    wrap_serve("_serve_from_batch")
    wrap_serve("_serve_plan")

    from repro_torch.experiments.runner import run_cell
    try:
        t0 = time.perf_counter_ns()
        for _ in range(max(repeat, 1)):
            run_cell(spec, cell)
        total = (time.perf_counter_ns() - t0) / 1e9
    finally:
        for name, orig in saved:
            setattr(sim, name, orig)
    return acc, total


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python tools/torch_profile_engine.py",
        description="cProfile one cell of a registered grid")
    ap.add_argument("--grid", required=True,
                    help="registered grid or suite name (see "
                         "`python -m repro_torch.experiments list`)")
    ap.add_argument("--cell", type=int, default=0,
                    help="cell index into the expanded grid (default 0)")
    ap.add_argument("--top", type=int, default=20,
                    help="how many functions to print (default 20)")
    ap.add_argument("--sort", default="cumulative",
                    choices=("cumulative", "tottime", "ncalls"),
                    help="pstats sort key (default cumulative)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="profiled repetitions of the cell (default 3)")
    ap.add_argument("--phases", action="store_true",
                    help="print a lower/perturb/engine/collect wall-clock "
                         "breakdown instead of a cProfile listing")
    ap.add_argument("--list", action="store_true",
                    help="print the grid's cells with indices and exit")
    args = ap.parse_args(argv)

    cells = _cells(args.grid)
    if args.list:
        for i, (spec, cell) in enumerate(cells):
            print(f"{i:4d}  {spec.name}  {cell.to_dict()}")
        return 0
    if not 0 <= args.cell < len(cells):
        print(f"--cell {args.cell} out of range: {args.grid} has "
              f"{len(cells)} cells (use --list)")
        return 2

    from repro_torch.experiments.runner import run_cell
    spec, cell = cells[args.cell]
    print(f"profiling {spec.name} cell {args.cell}: {cell.to_dict()} "
          f"(x{args.repeat})")
    run_cell(spec, cell)            # warm timeline/transport caches
    if args.phases:
        acc, total = _run_phases(spec, cell, args.repeat)
        reps = max(args.repeat, 1)
        other = max(total - sum(acc.values()), 0.0)
        print(f"{'phase':<10}{'ms/cell':>10}{'share':>8}")
        for phase in ("lower", "perturb", "engine", "collect"):
            print(f"{phase:<10}{acc[phase] / reps * 1e3:>10.2f}"
                  f"{acc[phase] / total:>7.0%}")
        print(f"{'other':<10}{other / reps * 1e3:>10.2f}"
              f"{other / total:>7.0%}")
        print(f"{'total':<10}{total / reps * 1e3:>10.2f}")
        return 0
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(max(args.repeat, 1)):
        run_cell(spec, cell)
    prof.disable()
    stats = pstats.Stats(prof)
    stats.sort_stats(args.sort).print_stats(args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
