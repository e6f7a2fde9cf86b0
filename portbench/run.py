#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the cards of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the program's training step (imports, the kernel library, weights
and AdamW state from ``--seed``, the checked steps), measures for
``--seconds``, follows the checked steps with the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, ``breakdown`` (traced
runs) and ``checks``, each compared number beside its limit, which are
also the last lines on standard error.  Exits non-zero with no result
where CUDA or the cards the cell asks for are missing, or where JAX or the
JAX package was loaded.  A cell with ``world`` > 1 starts that many rank
processes, one a card, and rank 0 prints.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: torch.cuda.is_available() is False; no result")
    if torch.cuda.device_count() < n:
        sys.exit(f"portbench: the cell asks for {n} cards, this machine has "
                 f"{torch.cuda.device_count()}; no result")


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell, out: dict, trace: bool, device) -> dict:
    import torch

    from portbench.harness import spec

    win, tr = out["window"], out["trace"]
    ctx = SimpleNamespace(cell=cell, window=win, trace=tr, world=out["world"],
                          leaf_sizes=out["leaf_sizes"], itemsize=out["itemsize"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": out["world"],
           "memory_peak_bytes": win.peak_bytes}
    line = {"correct": out["correct"], "attempted": win.attempted, "failed": win.failed,
            "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                             "idle_gaps": [list(x) for x in tr.idle_gaps]}
    line["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in out["checks"]}
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".portbench_cache" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.harness import spec

    cell = spec.load(args.workload, ROOT)
    require_cards(cell.chips)
    if cell.world > 1 and "WORLD_SIZE" not in os.environ:
        from portbench.harness import ranks
        return ranks.launch(cell.world, [sys.executable, str(Path(__file__).resolve()),
                                         *(sys.argv[1:] if argv is None else argv)],
                            {"PORTBENCH_T_PROCESS": repr(T_PROCESS)})

    import torch

    from portbench.harness import trainer

    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    t_process = float(os.environ.get("PORTBENCH_T_PROCESS", T_PROCESS))
    out = trainer.run(cell, args.seed, args.seconds, bool(args.trace), device, t_process)
    if out["rank"] != 0:
        return 0
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace), out["device"])
    for name, c in line["checks"].items():
        print(f"{name} {c['value']:.6e} limit {c['limit']:.6e}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
