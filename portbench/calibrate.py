#!/usr/bin/env python3
"""Readings from which a cell's limits are set, on the card; the
benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--faults 1,2,3] [--witness embedding,order] [--out readings.json]

For each seed in ``--seeds``: the program's checked steps, built and
driven as a run's set-up drives them, against the reference (the lower
readings).  For each seed in ``--faults``: the control, the reference
with its products one precision below the configuration's (TF32 below
float32, fp8 below bfloat16) put in the program's place, and the half-batch
fault planted in the reference, each against the reference (the upper
readings).  A state left unchanged reads 1 on ``grad_gap`` and
``change_gap`` and needs no run.  One process for every seed, so the
kernels are built and loaded once.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--witness", default="",
                    help="on the --faults seeds also: 'embedding', the program with a float32 "
                         "sum in its embedding's backward; 'order', the reference in another "
                         "float32 order (comma-separated)")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import check, spec, trainer
    from portbench.reference.precision import CONTROL

    if not torch.cuda.is_available():
        sys.exit("calibrate: needs a CUDA card")
    device = torch.device("cuda", 0)
    cell = spec.load(args.workload, ROOT)
    b1 = cell.traffic["optimizer"]["b1"]
    n = int(cell.cell["checked_steps"])
    rows = []

    def record(kind, seed, readings, t0):
        gaps = check.gaps(readings, ref)
        row = {"kind": kind, "seed": seed, "seconds": time.time() - t0,
               **{k: v[0] for k, v in gaps.items()}, "where": {k: v[1] for k, v in gaps.items()},
               "losses": readings.losses, "leaves": check.leaf_gaps(readings, ref)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    faults = {int(s) for s in args.faults.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        prog = trainer.Program(cell, seed, device, None)
        readings = prog.checked_steps(n, b1)
        prog.close()
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.time()
        ref = trainer.reference_readings(cell, seed, device, cell.world)
        print(f"seed {seed}: program {t1 - t0:.1f} s, reference {time.time() - t1:.1f} s, "
              f"reference losses {ref.losses}", flush=True)
        record("program", seed, readings, t0)
        if seed in faults and "order" in args.witness:
            # the reference against itself with its attention in blocks of
            # 512 queries: the same arithmetic in another float32 order
            from portbench.counts.arch import module
            reference = module(cell.arch, "reference")
            attention = reference.attention
            reference.attention = lambda q, k, v, mm, block=1024: attention(q, k, v, mm, 512)
            t0 = time.time()
            other = trainer.reference_readings(cell, seed, device, cell.world)
            reference.attention = attention
            record("witness_reference_order", seed, other, t0)
        if seed in faults and "embedding" in args.witness:
            # the program once more, its embedding lookup's backward summing
            # a repeated token's rows in float32 (F.embedding) in place of
            # its own bf16 index_put: which side the embedding's gap is on
            import repro_torch.models.transformer as transformer
            lookup = transformer.lookup
            transformer.lookup = lambda table, tokens: torch.nn.functional.embedding(
                tokens.long(), table)
            t0 = time.time()
            prog = trainer.Program(cell, seed, device, None)
            witness = prog.checked_steps(n, b1)
            prog.close()
            del prog
            transformer.lookup = lookup
            gc.collect()
            torch.cuda.empty_cache()
            record("witness_embedding_f32_sum", seed, witness, t0)
        if seed in faults:
            t0 = time.time()
            control = CONTROL[cell.arch.dtype]
            record(f"control_{control}", seed,
                   trainer.reference_readings(cell, seed, device, cell.world, control), t0)
            t0 = time.time()
            record("fault_half", seed,
                   trainer.reference_readings(cell, seed, device, cell.world, half=True), t0)
    summary = {}
    for kind in sorted({r["kind"] for r in rows}):
        sel = [r for r in rows if r["kind"] == kind]
        summary[kind] = {k: (max if kind == "program" else min)(r[k] for r in sel)
                         for k in check.NUMBERS}
    print("summary (program: largest; control and faults: smallest)", json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "summary": summary,
                                              "card": torch.cuda.get_device_name(device)},
                                             indent=1))


if __name__ == "__main__":
    main()
