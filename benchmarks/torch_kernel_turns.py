#!/usr/bin/env python3
"""Two trees' float32 flash kernel, timed on one card in turns.

    python benchmarks/torch_kernel_turns.py --trees PARENT . . PARENT

Each tree (the root of a checkout, with ``src/repro_torch`` under it) runs
in a process of its own, since both hold a package of the same name; a
tree's kernels are built by its first process.  In each, every call is
timed behind a stream spin of about 1 ms (as ``chip_smoke.time_device_ms``
times), median of 10: the float32 flash forward, causal, at repro-100m's
(48, 256, 64) with Hq 12 / Hkv 4 (``examples/torch_train_e2e.py``) and at
(8, 4096, 80).  Prints the card's name and power limit, a JSON line a turn,
and a table of the medians.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

FLASH = [("repro-100m (48, 256, 64) Hq 12 / Hkv 4", 4, 12, 4, 256, 64),
         ("(8, 4096, 80)", 1, 8, 8, 4096, 80)]


def child(tree: Path) -> dict:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fl

    dev = torch.device("cuda", 0)

    def randn(*shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, generator=g, device=dev)

    def device_ms(fn, reps=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    build.library()
    out = {"tree": str(tree)}
    for label, B, H, KV, S, hd in FLASH:
        q, k, v = randn(B * H, S, hd, seed=1), randn(B * KV, S, hd, seed=2), randn(B * KV, S, hd, seed=3)
        out[f"flash f32 {label}"] = device_ms(
            lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."], help="checkout roots, in the order of turns")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child).resolve())))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    turns = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            sys.exit(f"{tree} failed:\n{proc.stderr[-3000:]}")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]))
    keys = [k for k in turns[0] if k != "tree"]
    print("ms | " + " | ".join(t["tree"] for t in turns))
    for key in keys:
        print(f"{key} | " + " | ".join(f"{t[key]:.4f}" for t in turns))


if __name__ == "__main__":
    main()
