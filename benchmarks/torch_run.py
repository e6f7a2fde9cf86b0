"""The port's benchmark harness: ``python benchmarks/torch_run.py [--device cpu]``.

The counterpart of ``benchmarks/run.py``, section for section, over
``repro_torch``:

  1. The paper's figures and tables through the port's experiment engine
     (``repro_torch.experiments``), gated against
     ``artifacts/golden/{paper,scheduler}_suite.json`` at the engine's 1e-9,
     the suite artifact written to ``artifacts/experiments/torch_paper.json``;
     then the non-sweep analyses of ``benchmarks/torch_figures.py``.
  2. Kernel micro-benchmarks at the reference's 1 Mi elements
     (``benchmarks/torch_kernel_bench.run``): on the card the CUDA kernels
     beside their plain versions, with ``--device cpu`` the plain versions
     alone.
  3. The H100 what-if of the reference's six architectures
     (``repro_torch.core.whatif.h100_whatif``) in the layout the reference's
     TPU what-if prices: 256 GPUs a pod, one pod or two, a data-parallel
     group of 16 a pod and the rest of the GPUs model-parallel.
  4. The roofline over ``artifacts/dryrun/torch_results.json``
     (``benchmarks/torch_roofline.load_table``), when that file is there.

Prints a ``name,us_per_call,derived`` CSV per benchmark and a validation
summary; exits non-zero if a check fails.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

ART_PATH = REPO / "artifacts" / "experiments" / "torch_paper.json"
GOLDEN = REPO / "artifacts" / "golden"
WHATIF_ARCHS = ("stablelm-3b", "command-r-35b", "deepseek-coder-33b", "rwkv6-1.6b",
                "jamba-v0.1-52b", "moonshot-v1-16b-a3b")
GPUS_PER_POD = 256
DP_PER_POD = 16


def _banner(title: str) -> None:
    print("\n" + "=" * 72)
    print(title)
    print("=" * 72)


def _validations(name: str, val: Dict, detail: str = "") -> int:
    ok = all(bool(v) for v in val.values())
    print(f"\n{name},{detail}{'PASS' if ok else 'FAIL'}")
    for k, v in val.items():
        print(f"  check {k}: {'ok' if v else 'FAIL'}")
    return 0 if ok else 1


def section_engine() -> int:
    """Section 1: the paper and scheduler suites, gated against their
    goldens, then the figures with no sweep grid."""
    from benchmarks import torch_figures as figs
    from repro_torch.experiments import artifacts, compare, grids, run_suite

    _banner("SECTION 1: paper figure reproductions (the port's experiment engine)")
    failures = 0
    t0 = time.perf_counter()
    records = run_suite(grids.resolve("paper"))
    suite_us = (time.perf_counter() - t0) * 1e6
    art = artifacts.write(ART_PATH, records, meta={"grid": "paper"})
    print(f"suite artifact: {ART_PATH} ({suite_us:.0f} us total)")
    for ex in art["experiments"]:
        failures += _validations(ex["name"], ex["validations"], f"{len(ex['cells'])}cells,")
        for c in ex["cells"][:6]:
            print(f"  {c['model']},srv={c['n_servers']},bw={c['bandwidth_gbps']:g},"
                  f"{c['transport']},r={c['compression_ratio']:g},{c['topology']}: "
                  f"f_sim={c['scaling_factor']:.4f} util={c['network_utilization']:.3f}")
        if len(ex["cells"]) > 6:
            print(f"  ... ({len(ex['cells'])} cells total)")
    report = compare(artifacts.read(GOLDEN / "paper_suite.json"), art)
    failures += 0 if report.ok else 1
    print(f"\ngolden-artifact gate: {report.summary()}")

    sched_art = artifacts.make_artifact(run_suite(grids.resolve("scheduler")))
    for ex in sched_art["experiments"]:
        failures += _validations(ex["name"], ex["validations"], f"{len(ex['cells'])}cells,")
    report = compare(artifacts.read(GOLDEN / "scheduler_suite.json"), sched_art)
    failures += 0 if report.ok else 1
    print(f"scheduler-golden gate: {report.summary()}")

    rows, cval = figs.scheduler_contention()
    us = cval.pop("us", 0.0)
    failures += _validations("scheduler_contention", cval, f"{us:.0f},")
    for r in rows:
        print(f"  {r}")
    for name, fn in (("fig2_computation_time", figs.fig2_computation_time),
                     ("table_transmission", figs.table_transmission)):
        rows, val = fn()
        us = val.pop("us", 0.0)
        failures += _validations(name, val, f"{us:.0f},")
        for r in rows[:6]:
            print(f"  {r}")
        if len(rows) > 6:
            print(f"  ... ({len(rows)} rows total)")
    bs, bs_ok = figs.bytescheduler_bound()
    failures += 0 if bs_ok else 1
    print(f"\nbytescheduler_whatif,0,{'PASS' if bs_ok else 'FAIL'}")
    print(f"  {bs}")
    return failures


def section_kernels(device: str) -> int:
    """Section 2: the micro-bench table at 1 Mi elements."""
    from benchmarks import torch_kernel_bench as kb

    dev = kb.resolve_device(device)
    _banner(f"SECTION 2: kernel micro-benchmarks on {kb.card_name(dev)}"
            + (" (the plain versions: no CUDA device)" if dev.type == "cpu" else ""))
    print("name,us_per_call,derived")
    for r in kb.run(dev):
        if dev.type == "cpu" and not r["name"].endswith("_plain"):
            continue                        # on CPU tensors a wrapper runs its plain version
        print(f"{r['name']},{r['us_per_call']:.0f},{r['derived']}")
    return 0


def whatif_rows() -> List[Dict]:
    """Section 3's rows: ``h100_whatif`` on 256 GPUs a pod, one pod or two,
    dp = 16 a pod, mp = the rest."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core.whatif import h100_whatif

    shape = INPUT_SHAPES["train_4k"]
    rows = []
    for arch in WHATIF_ARCHS:
        for pods in (1, 2):
            n = GPUS_PER_POD * pods
            dp = DP_PER_POD * pods
            r = h100_whatif(get_config(arch), shape, n_gpus=n, data_parallel=dp)
            rows.append({"arch": arch, "pods": pods, "n_gpus": n, "dp": dp, "mp": n // dp,
                         "scaling_factor": r.scaling_factor, "t_overhead_s": r.t_overhead})
    return rows


def section_whatif() -> int:
    _banner("SECTION 3: H100 what-if for the reference's architectures (beyond-paper)")
    print("name,us_per_call,derived")
    for r in whatif_rows():
        print(f"h100_whatif[{r['arch']},gpus={r['n_gpus']},dp={r['dp']},mp={r['mp']}],0,"
              f"f_sim={r['scaling_factor']:.3f};overhead_ms={r['t_overhead_s'] * 1e3:.2f}")
    return 0


def section_roofline(path: Path) -> int:
    from benchmarks.torch_roofline import load_table

    _banner("SECTION 4: roofline from dry-run artifacts")
    if not path.exists():
        print(f"({path.name} not present — run python -m repro_torch.launch.dryrun first)")
        return 0
    rows = load_table(path)
    print(f"\n-- {path.name}: {len(rows)} combos --")
    print("name,us_per_call,derived")
    for r in rows:
        if r.get("kind") == "skipped":
            print(f"roofline[{r['arch']},{r['shape']}],0,skipped")
            continue
        print(f"roofline[{r['arch']},{r['shape']},{r['mesh']}"
              f"{',prod' if r.get('production') else ''}],0,"
              f"dominant={r['dominant']};compute_ms={r['compute_s'] * 1e3:.2f};"
              f"memory_ms={r['memory_s'] * 1e3:.2f};"
              f"collective_ms={r['collective_s'] * 1e3:.2f};"
              f"useful_ratio={r['model_flops_ratio']:.2f}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmarks/torch_run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, for section 2")
    ap.add_argument("--dryrun-results", default=str(REPO / "artifacts" / "dryrun" /
                                                    "torch_results.json"),
                    help="the dry run's records for section 4")
    args = ap.parse_args(argv)
    failures = section_engine()
    failures += section_kernels(args.device)
    failures += section_whatif()
    failures += section_roofline(Path(args.dryrun_results))
    print(f"\n{'ALL BENCHMARKS PASS' if failures == 0 else f'{failures} FAILURES'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
