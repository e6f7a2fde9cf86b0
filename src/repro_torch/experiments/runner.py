"""Grid execution: fan an expanded spec out over the what-if simulator.

``run_spec`` maps every :class:`~repro_torch.experiments.spec.Cell` through
``repro_torch.core.simulator.simulate`` (or ``simulate_contention`` when the
cell's ``n_jobs`` axis is > 1) via ``concurrent.futures`` and returns one
*experiment record*: spec + spec hash + per-cell ``SimResult`` fields +
paper-claim validations.  Records are plain dicts so ``artifacts.write``
can dump them untouched.

Executor selection (``executor="auto"``, the CLI default): grids below
:data:`PROCESS_THRESHOLD` cells run on threads — each cell is a few ms of
pure Python, so thread fan-out only hides the artifact I/O — while larger
grids use a process pool, since the GIL serializes pure-Python cells and
threads cannot scale them.  ``serial`` stays available for debugging (and
is what tiny grids degenerate to).

Process pools have two per-worker costs this module amortizes:

- the ``_timeline`` LRU cache is cold in every worker, so each pool worker
  runs :func:`_warm_timelines` as an initializer, building the timelines
  the spec names exactly once per process instead of once per cell;
- cells are submitted in :data:`CELLS_PER_TASK`-sized batches so argument
  pickling and future bookkeeping are paid per batch, not per cell.

Hardened mode (any of ``journal`` / ``resume`` / ``cell_timeout`` /
``retries`` set) trades the batched fast path for crash-safety: every
completed cell is flushed to a JSONL journal as it lands, a wedged cell is
killed at its wall-clock budget and retried with exponential backoff, a
cell that exhausts its retries is *recorded* with failure metadata instead
of aborting the sweep, and ``resume=True`` replays the journal — re-running
only missing/failed cells — to an artifact byte-identical to a single-shot
run (cells are assembled in ``spec.expand()`` index order either way).
With none of those knobs set, the historical code path runs untouched.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.addest import AddEst
from repro_torch.core.simulator import simulate, simulate_contention
from repro_torch.core.transport import GBPS
from repro_torch.configs.base import CommConfig
from repro_torch.experiments.spec import Cell, ExperimentSpec

ENGINE_VERSION = 1

# auto executor: processes once the grid is big enough that the GIL (not
# I/O) is the bottleneck; below it, threads keep the artifact write warm
# without fork/spawn overhead
PROCESS_THRESHOLD = 64
# cells per process-pool task: amortizes pickling without starving workers
CELLS_PER_TASK = 8

# crash-safe journal identity (validated on --resume so a journal written
# by a different grid can never silently seed another sweep's artifact)
JOURNAL_KIND = "repro-journal"
JOURNAL_SCHEMA_VERSION = 1
# base of the round-level exponential retry backoff (seconds); bounded so
# a sweep with many flaky cells degrades in minutes, not hours
_RETRY_BACKOFF_S = 0.05
_RETRY_BACKOFF_MAX_S = 2.0

_ADDEST = {"v100": AddEst.v100, "h100": AddEst.h100}


@lru_cache(maxsize=32)
def _timeline(model: str):
    from repro_torch.core.timeline import from_cnn
    return from_cnn(model)


def _warm_timelines(models: Sequence[str]) -> None:
    """Process-pool initializer: pre-build the timelines a spec sweeps.

    ``_timeline``'s ``lru_cache`` lives per process; without this, every
    worker would rebuild each model's timeline on its first cell."""
    for m in models:
        _timeline(m)


def run_cell(spec: ExperimentSpec, cell: Cell) -> Dict:
    """Simulate one grid cell.  Must match ``whatif.sim_scaling`` exactly:
    same timeline, worker count, AddEst, and CommConfig as the historical
    per-figure loops, so golden artifacts are comparable at 1e-9.

    A cell with ``n_jobs > 1`` runs :func:`simulate_contention` with
    ``n_jobs`` copies of the same training job sharing one fair-share link;
    the jobs are symmetric, so the first job's result is the cell's record.

    The scenario axes ride along as plain keyword arguments: ``n_rails``
    splits the cell's (aggregate) bandwidth into rails under
    ``spec.rail_policy``, ``jitter_ms`` perturbs flush times under
    ``spec.jitter_seed``, and ``codec`` prices gradient compression as
    encode -> wire -> decode stages (``spec.error_feedback`` adds the
    EF-SGD residual cost to lossy-codec cells; ``codec="none"`` cells
    ignore it, so a grid can sweep codecs with EF on without its baseline
    cells rejecting the knob) — all default-off, leaving the historical
    cells' code path (and bits) untouched.  ``fabric``/``oversubscription``
    lower the cell onto NIC -> ToR-uplink paths (:mod:`repro_torch.core.fabric`)
    priced at the engine's max-min fair share; ``fabric="none"`` (and the
    elided 1:1 case) is bitwise the flat link.  ``link_profile`` prices a
    lossy WAN link (:mod:`repro_torch.core.transport`): retransmission wire
    inflation + RTT deterministically, seeded RTO stalls stochastically
    (drawn from ``spec.fault_seed``); ``"none"`` is bitwise the clean link.
    """
    kwargs = dict(
        n_workers=cell.n_servers * spec.gpus_per_server,
        bandwidth=cell.bandwidth_gbps * GBPS,
        transport=cell.transport,
        compression_ratio=cell.compression_ratio,
        scheduler=cell.scheduler,
        n_chunks=spec.sched_chunks,
        n_rails=cell.n_rails,
        rail_policy=spec.rail_policy,
        jitter=cell.jitter_ms / 1e3,
        jitter_seed=spec.jitter_seed,
        codec=cell.codec,
        error_feedback=spec.error_feedback and cell.codec != "none",
        fault_model=cell.fault_model,
        churn_rate=cell.churn_rate,
        worker_bw_skew=cell.worker_bw_skew,
        fault_seed=spec.fault_seed,
        fabric=cell.fabric,
        oversubscription=cell.oversubscription,
        link_profile=cell.link_profile,
        comm=CommConfig(fusion_buffer_mb=spec.fusion_buffer_mb,
                        timeout_ms=spec.timeout_ms),
        addest=_ADDEST[spec.addest]())
    tl = _timeline(cell.model)
    if cell.n_jobs > 1:
        if cell.topology != "ring":
            raise ValueError(
                f"contention cells model the flat ring only, got topology "
                f"{cell.topology!r} with n_jobs={cell.n_jobs}")
        r = simulate_contention([tl] * cell.n_jobs, **kwargs)[0]
    else:
        r = simulate(tl, topology=cell.topology, **kwargs)
    out = cell.to_dict()
    out.update(r.to_dict())
    # effective bandwidth in the sweep's own unit, for readable artifacts
    out["effective_gbps"] = r.effective_bw / GBPS
    # numpy scalars (np.float64 creeps in via the timeline arrays) become
    # plain Python types so artifacts are pure JSON
    return {k: float(v) if isinstance(v, float) else v
            for k, v in out.items()}


def _run_cell_from_dicts(spec_d: Dict, cell_d: Dict) -> Dict:
    # module-level picklable entry point for ProcessPoolExecutor
    return run_cell(ExperimentSpec.from_dict(spec_d), Cell.from_dict(cell_d))


def _run_cell_batch(spec_d: Dict, cell_ds: Sequence[Dict]) -> List[Dict]:
    """Picklable batch entry point: one submission, many cells."""
    spec = ExperimentSpec.from_dict(spec_d)
    return [run_cell(spec, Cell.from_dict(d)) for d in cell_ds]


def resolve_executor(executor: str, n_cells: int,
                     workload: Optional[int] = None) -> str:
    """``auto`` -> threads for small grids, processes for big ones.

    ``workload`` (default: the plain cell count) is the grid's
    :attr:`~repro_torch.experiments.spec.ExperimentSpec.workload_units` — a
    contention cell weighs ``n_jobs``-fold, since one n_jobs=16 cell runs
    sixteen jobs' worth of flows through the engine.  Without the
    weighting, a 48-cell grid of 10k-flow contention cells would be
    GIL-serialized on threads purely because its *count* is small."""
    if executor != "auto":
        return executor
    load = n_cells if workload is None else workload
    return "process" if load >= PROCESS_THRESHOLD else "thread"


def _batches(items: Sequence, size: int) -> List[Sequence]:
    return [items[i:i + size] for i in range(0, len(items), size)]


# -- hardened path: journal / resume / timeout / retry -----------------------

def _failure_record(cell: Cell, error: str) -> Dict:
    """Graceful degradation: the cell's identity plus failure metadata,
    shaped so ``index_cells`` still indexes it and ``validate``/``compare``
    can skip-and-report instead of crashing on missing numerics."""
    d = cell.to_dict()
    d["failed"] = True
    d["error"] = error
    return d


def _journal_append(fh, index: int, record: Dict) -> None:
    fh.write(json.dumps({"index": index, "cell": record},
                        sort_keys=True) + "\n")
    fh.flush()  # past the user-space buffer: SIGKILL loses at most one line


def _load_journal(path: Union[str, Path],
                  spec: ExperimentSpec) -> Dict[int, Dict]:
    """Replay a journal -> {expand() index: completed cell record}.

    Tolerates a truncated final line (the crash boundary); refuses a
    journal whose header names a different grid.  Failed cells are
    *dropped* so ``--resume`` re-runs them."""
    done: Dict[int, Dict] = {}
    p = Path(path)
    if not p.exists():
        return done
    with p.open() as fh:
        header = None
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail from a mid-write kill: keep what precedes
            if header is None:
                header = d
                if (d.get("kind") != JOURNAL_KIND
                        or d.get("schema_version") != JOURNAL_SCHEMA_VERSION):
                    raise ValueError(f"{p} is not a sweep journal")
                if d.get("spec_hash") != spec.spec_hash():
                    raise ValueError(
                        f"journal {p} was written by spec "
                        f"{d.get('spec_hash')!r}, not {spec.spec_hash()!r} "
                        f"({spec.name}) — refusing to resume across grids")
                continue
            rec = d.get("cell", {})
            if rec.get("failed"):
                continue
            done[int(d["index"])] = rec
    return done


def _run_hardened_serial(spec: ExperimentSpec, pending: Dict[int, Cell], *,
                         retries: int, jfh) -> Dict[int, Dict]:
    out: Dict[int, Dict] = {}
    for i in sorted(pending):
        cell, rec, err = pending[i], None, ""
        for attempt in range(retries + 1):
            try:
                rec = run_cell(spec, cell)
                break
            except Exception as e:  # noqa: BLE001 — degrade, don't abort
                err = f"{type(e).__name__}: {e}"
                if attempt < retries:
                    time.sleep(min(_RETRY_BACKOFF_S * 2.0 ** attempt,
                                   _RETRY_BACKOFF_MAX_S))
        if rec is None:
            rec = _failure_record(cell, err)
        out[i] = rec
        if jfh is not None:
            _journal_append(jfh, i, rec)
    return out


def _run_hardened_process(spec: ExperimentSpec, pending: Dict[int, Cell], *,
                          max_workers: Optional[int],
                          cell_timeout: Optional[float],
                          retries: int, jfh) -> Dict[int, Dict]:
    """Round-based pool execution with per-cell wall-clock budgets.

    Each round submits every still-pending cell via ``apply_async`` and
    collects in index order.  A cell that blows ``cell_timeout`` cannot be
    recalled from its worker, so the round charges it one attempt,
    harvests whatever later cells already finished, terminates the pool,
    and loops; a worker exception likewise burns an attempt.  Every round
    either drains cells or charges attempts (which are capped), so the
    sweep always terminates — exhausted cells land as failure records."""
    spec_d = spec.to_dict()
    out: Dict[int, Dict] = {}
    attempts = dict.fromkeys(pending, 0)
    left = dict(pending)
    rnd = 0
    while left:
        order = sorted(left)
        workers = max_workers or min(len(order), os.cpu_count() or 1)
        pool = multiprocessing.Pool(processes=workers,
                                    initializer=_warm_timelines,
                                    initargs=(tuple(spec.models),))
        harvested: Dict[int, tuple] = {}
        timed_out = None
        try:
            asyncs = {i: pool.apply_async(_run_cell_from_dicts,
                                          (spec_d, left[i].to_dict()))
                      for i in order}
            for pos, i in enumerate(order):
                try:
                    harvested[i] = ("ok", asyncs[i].get(cell_timeout))
                except multiprocessing.TimeoutError:
                    timed_out = i
                    for j in order[pos + 1:]:
                        if asyncs[j].ready():
                            try:
                                harvested[j] = ("ok", asyncs[j].get(0))
                            except Exception as e:  # noqa: BLE001
                                harvested[j] = (
                                    "err", f"{type(e).__name__}: {e}")
                    break
                except Exception as e:  # noqa: BLE001
                    harvested[i] = ("err", f"{type(e).__name__}: {e}")
        finally:
            pool.terminate()  # also the close() path: nothing left queued
            pool.join()

        charged = False
        if timed_out is not None:
            attempts[timed_out] += 1
            charged = True
            if attempts[timed_out] > retries:
                rec = _failure_record(
                    left[timed_out],
                    f"TimeoutError: cell exceeded {cell_timeout}s wall "
                    f"clock ({attempts[timed_out]} attempts)")
                out[timed_out] = rec
                del left[timed_out]
                if jfh is not None:
                    _journal_append(jfh, timed_out, rec)
        for i, (kind, val) in sorted(harvested.items()):
            if kind == "ok":
                out[i] = val
                del left[i]
                if jfh is not None:
                    _journal_append(jfh, i, val)
            else:
                attempts[i] += 1
                charged = True
                if attempts[i] > retries:
                    rec = _failure_record(left[i], val)
                    out[i] = rec
                    del left[i]
                    if jfh is not None:
                        _journal_append(jfh, i, rec)
        if charged and left:
            time.sleep(min(_RETRY_BACKOFF_S * 2.0 ** rnd,
                           _RETRY_BACKOFF_MAX_S))
        rnd += 1
    return out


def _run_hardened(spec: ExperimentSpec, cells: Sequence[Cell], *, mode: str,
                  max_workers: Optional[int],
                  journal: Optional[Union[str, Path]], resume: bool,
                  cell_timeout: Optional[float],
                  retries: int) -> List[Dict]:
    done: Dict[int, Dict] = {}
    jpath = Path(journal) if journal is not None else None
    if resume:
        if jpath is None:
            raise ValueError("resume=True needs a journal path")
        done = _load_journal(jpath, spec)
    jfh = None
    if jpath is not None:
        jpath.parent.mkdir(parents=True, exist_ok=True)
        # rewrite-from-scratch on every run: drops any torn tail line and
        # the failed entries being re-run, so the journal is always a clean
        # prefix of the final artifact
        jfh = jpath.open("w")
        jfh.write(json.dumps(
            {"kind": JOURNAL_KIND,
             "schema_version": JOURNAL_SCHEMA_VERSION,
             "name": spec.name, "spec_hash": spec.spec_hash()},
            sort_keys=True) + "\n")
        jfh.flush()
        for i in sorted(done):
            _journal_append(jfh, i, done[i])
    pending = {i: c for i, c in enumerate(cells) if i not in done}
    try:
        if not pending:
            fresh: Dict[int, Dict] = {}
        elif mode == "process":
            fresh = _run_hardened_process(
                spec, pending, max_workers=max_workers,
                cell_timeout=cell_timeout, retries=retries, jfh=jfh)
        else:
            # thread mode degenerates to serial here: a wedged thread
            # cannot be recalled, and retry bookkeeping wants one owner
            fresh = _run_hardened_serial(spec, pending, retries=retries,
                                         jfh=jfh)
    finally:
        if jfh is not None:
            jfh.close()
    done.update(fresh)
    return [done[i] for i in range(len(cells))]


def run_spec(spec: ExperimentSpec, *, executor: str = "auto",
             max_workers: Optional[int] = None,
             journal: Optional[Union[str, Path]] = None,
             resume: bool = False,
             cell_timeout: Optional[float] = None,
             retries: int = 0) -> Dict:
    """Expand and run one grid; returns the experiment record.

    ``journal`` (a JSONL path) flushes every completed cell as it lands;
    ``resume=True`` replays that journal and re-runs only missing/failed
    cells — the assembled record is byte-identical to a single-shot run.
    ``cell_timeout`` (seconds, process pool only) bounds each cell's wall
    clock; ``retries`` bounds re-attempts per cell, with exponential
    backoff between rounds.  A cell that exhausts its retries is recorded
    with ``{"failed": true, "error": ...}`` instead of aborting the sweep.
    All four default off, leaving the historical path byte-untouched."""
    cells = spec.expand()
    mode = resolve_executor(executor, len(cells), spec.workload_units)
    hardened = (journal is not None or resume
                or cell_timeout is not None or retries > 0)
    if hardened:
        results = _run_hardened(
            spec, cells, mode=mode, max_workers=max_workers,
            journal=journal, resume=resume, cell_timeout=cell_timeout,
            retries=retries)
        from repro_torch.experiments.validations import validate
        return {
            "name": spec.name,
            "engine_version": ENGINE_VERSION,
            "spec": spec.to_dict(),
            "spec_hash": spec.spec_hash(),
            "cells": results,
            "validations": validate(spec.name, results),
        }
    if mode == "serial" or len(cells) <= 1:
        results = [run_cell(spec, c) for c in cells]
    elif mode == "process":
        spec_d = spec.to_dict()
        workers = max_workers or min(len(cells), os.cpu_count() or 1)
        batches = _batches([c.to_dict() for c in cells], CELLS_PER_TASK)
        with ProcessPoolExecutor(
                max_workers=workers,
                initializer=_warm_timelines,
                initargs=(tuple(spec.models),)) as pool:
            results = [r for batch in pool.map(_run_cell_batch,
                                               [spec_d] * len(batches),
                                               batches)
                       for r in batch]
    elif mode == "thread":
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            results = list(pool.map(lambda c: run_cell(spec, c), cells))
    else:
        raise ValueError(f"unknown executor {executor!r}")

    from repro_torch.experiments.validations import validate
    return {
        "name": spec.name,
        "engine_version": ENGINE_VERSION,
        "spec": spec.to_dict(),
        "spec_hash": spec.spec_hash(),
        "cells": results,
        "validations": validate(spec.name, results),
    }


def run_suite(specs: Sequence[ExperimentSpec], *, executor: str = "auto",
              max_workers: Optional[int] = None,
              journal_dir: Optional[Union[str, Path]] = None,
              resume: bool = False,
              cell_timeout: Optional[float] = None,
              retries: int = 0) -> List[Dict]:
    """Run several grids; ``journal_dir`` keeps one journal per spec
    (``<dir>/<name>.jsonl``), which is what ``--resume`` replays."""
    out = []
    for s in specs:
        journal = (Path(journal_dir) / f"{s.name}.jsonl"
                   if journal_dir is not None else None)
        out.append(run_spec(s, executor=executor, max_workers=max_workers,
                            journal=journal, resume=resume,
                            cell_timeout=cell_timeout, retries=retries))
    return out


def index_cells(cells: Sequence[Dict]) -> Dict[tuple, Dict]:
    """Cell list -> {(model, n_servers, bw, transport, ratio, topo,
    scheduler, n_jobs): cell}.  Axes added after an artifact was written
    fall back to their recorded defaults, so old artifacts index
    consistently."""
    from repro_torch.experiments.spec import CELL_AXES, axis_value
    return {tuple(axis_value(c, a) for a in CELL_AXES): c for c in cells}
