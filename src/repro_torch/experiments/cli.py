"""``python -m repro_torch.experiments`` — run sweeps, gate regressions.

Commands:
  run      expand a named grid/suite, simulate it, write a JSON artifact
  compare  diff two artifacts under tolerances; exit 1 on any violation
  report   pretty-print an artifact (validations + CSV cells)
  list     show the known grids and suites

Examples:
  python -m repro_torch.experiments run --grid paper-fig3
  python -m repro_torch.experiments run --grid paper --out /tmp/new.json
  python -m repro_torch.experiments compare artifacts/golden/paper_suite.json /tmp/new.json
  python -m repro_torch.experiments report artifacts/golden/paper_suite.json
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.experiments import artifacts, grids
from repro_torch.experiments.compare import compare
from repro_torch.experiments.runner import ENGINE_VERSION, run_suite
from repro_torch.experiments.spec import CELL_AXES, axis_value


def _cmd_run(args: argparse.Namespace) -> int:
    specs = grids.resolve(args.grid)
    out = Path(args.out or f"artifacts/experiments/{args.grid}.json")
    journal_dir = args.journal
    if args.resume and journal_dir is None:
        raise SystemExit("--resume needs --journal DIR (the journal to "
                         "replay)")
    experiments = run_suite(specs, executor=args.executor,
                            max_workers=args.jobs,
                            journal_dir=journal_dir, resume=args.resume,
                            cell_timeout=args.cell_timeout,
                            retries=args.retries)
    artifacts.write(out, experiments, meta={"grid": args.grid,
                                            "engine_version": ENGINE_VERSION})
    n_cells = sum(len(e["cells"]) for e in experiments)
    n_failed_cells = sum(1 for e in experiments
                         for c in e["cells"] if c.get("failed"))
    failed = [f"{e['name']}:{k}" for e in experiments
              for k, v in e["validations"].items() if not v]
    print(f"wrote {out} ({len(experiments)} experiment(s), {n_cells} cells)")
    if n_failed_cells:
        print(f"WARNING: {n_failed_cells} cell(s) exhausted retries and "
              f"were recorded with failure metadata")
    if failed:
        print("FAILED paper-claim checks: " + ", ".join(failed))
        return 1
    print("all paper-claim checks pass")
    return 0


def _parse_tols(pairs: Optional[List[str]]) -> Dict[str, float]:
    tols: Dict[str, float] = {}
    for p in pairs or []:
        if "=" not in p:
            raise SystemExit(f"--tol expects field=value, got {p!r}")
        k, v = p.split("=", 1)
        tols[k] = float(v)
    return tols


def _cmd_compare(args: argparse.Namespace) -> int:
    old = artifacts.read(args.old)
    new = artifacts.read(args.new)
    report = compare(old, new, _parse_tols(args.tol))
    print(report.summary())
    return 0 if report.ok else 1


def _cmd_report(args: argparse.Namespace) -> int:
    art = artifacts.read(args.artifact)
    for e in art["experiments"]:
        if args.grid and e["name"] != args.grid:
            continue
        vals = e.get("validations", {})
        ok = all(vals.values())
        print(f"\n== {e['name']} ({len(e['cells'])} cells, "
              f"spec {e['spec_hash']}) {'PASS' if ok else 'FAIL'}")
        for k, v in vals.items():
            print(f"  check {k}: {'ok' if v else 'FAIL'}")
        cols = list(CELL_AXES) + ["scaling_factor", "t_overhead",
                                  "network_utilization"]
        print("  " + ",".join(cols))
        rows = e["cells"] if args.all else e["cells"][:8]
        for c in rows:
            # axes added after an artifact was written (or elided at their
            # default) fall back to AXIS_DEFAULTS
            vals = [axis_value(c, k) for k in cols]
            print("  " + ",".join(
                f"{v:.6g}" if isinstance(v, float) else str(v)
                for v in vals))
        if not args.all and len(e["cells"]) > 8:
            print(f"  ... ({len(e['cells'])} cells total; --all to list)")
    return 0


def _cmd_list(_args: argparse.Namespace) -> int:
    print("grids:")
    for name, spec in sorted(grids.GRIDS.items()):
        print(f"  {name:<14} {spec.n_cells:>4} cells  "
              f"(hash {spec.spec_hash()})")
    print("suites:")
    for name, members in sorted(grids.SUITES.items()):
        print(f"  {name:<14} -> {', '.join(members)}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser, importable without running anything.

    ``tools/check_docs.py`` parses every documented
    ``python -m repro_torch.experiments ...`` line through this parser, so a
    README example that drifts from the real flags fails CI.
    """
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a grid/suite and write an artifact")
    p.add_argument("--grid", required=True,
                   help="grid or suite name (see `list`)")
    p.add_argument("--out", help="artifact path "
                   "(default artifacts/experiments/<grid>.json)")
    p.add_argument("--executor",
                   choices=("auto", "thread", "process", "serial"),
                   default="auto",
                   help="auto = threads for small grids, a process pool "
                        "once the grid reaches 64 cells (pure-Python cells "
                        "are GIL-bound on threads); serial for debugging")
    p.add_argument("--jobs", type=int, default=None,
                   help="max workers for the executor")
    p.add_argument("--journal", metavar="DIR", default=None,
                   help="crash-safe journal directory: every completed "
                        "cell is flushed to DIR/<grid>.jsonl as it lands")
    p.add_argument("--resume", action="store_true",
                   help="replay the journal and re-run only missing/failed "
                        "cells; the artifact is byte-identical to a "
                        "single-shot run")
    p.add_argument("--cell-timeout", type=float, default=None,
                   metavar="SECONDS", dest="cell_timeout",
                   help="per-cell wall-clock budget (process pool): a "
                        "wedged cell is killed and retried")
    p.add_argument("--retries", type=int, default=0,
                   help="re-attempts per failed/timed-out cell (with "
                        "exponential backoff); an exhausted cell is "
                        "recorded with failure metadata, not fatal")
    p.set_defaults(fn=_cmd_run)

    p = sub.add_parser("compare", help="diff two artifacts (regression gate)")
    p.add_argument("old")
    p.add_argument("new")
    p.add_argument("--tol", action="append", metavar="FIELD=ATOL",
                   help="override the absolute tolerance for one field")
    p.set_defaults(fn=_cmd_compare)

    p = sub.add_parser("report", help="pretty-print an artifact")
    p.add_argument("artifact")
    p.add_argument("--grid", help="only this experiment")
    p.add_argument("--all", action="store_true", help="print every cell")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("list", help="list known grids and suites")
    p.set_defaults(fn=_cmd_list)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
