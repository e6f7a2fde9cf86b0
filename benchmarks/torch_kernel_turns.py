#!/usr/bin/env python3
"""Two trees' kernels, timed on one card in turns.

    python benchmarks/torch_kernel_turns.py --trees PARENT . . PARENT
    python benchmarks/torch_kernel_turns.py --trees PARENT . . PARENT --probe
    python benchmarks/torch_kernel_turns.py --trees . --probe --variants

Each tree (the root of a checkout, with ``src/repro_torch`` under it) runs
in a process of its own, since both hold a package of the same name; a
tree's kernels are built by its first process.  In each, every call is
timed behind a stream spin of about 1 ms (as ``chip_smoke.time_device_ms``
times).  By default: the float32 flash forward, causal, at repro-100m's
(48, 256, 64) with Hq 12 / Hkv 4 (``examples/torch_train_e2e.py``) and at
(8, 4096, 80), median of 10.  With ``--probe``: the copy probe
``probe_copy_2d``, ``x.clone()`` and the plain version's ``empty_like`` +
``copy_`` at stablelm-3b's largest bucket, 2,211,840 x 256 float32, taken
in turns 21 times, each turn starting at the next copy, median and
interquartile spread; ``--variants`` adds to those turns the designs of
``benchmarks/torch_probe_variants.cu``, each first held to its input bit
for bit, and the probe launched 5, 10, 20 and 40 us after its start event
(a launch's device time has been seen to depend on when the host issues
it).  Prints the card's name and power limit, a JSON line a
turn, and a table of the medians.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

FLASH = [("repro-100m (48, 256, 64) Hq 12 / Hkv 4", 4, 12, 4, 256, 64),
         ("(8, 4096, 80)", 1, 8, 8, 4096, 80)]
PROBE_ROWS = 32 * 2560 * 6912 // 256     # stablelm-3b's blocks.mlp.wi, the largest bucket
VARIANTS = ["strided", "coalesced", "coalesced, cs", "coalesced, nc", "strided, cs",
            "coalesced, evict_first", "coalesced, nc 256B", "coalesced, cs loads",
            "coalesced, cs stores"]
VARIANTS_CU = Path(__file__).resolve().parent / "torch_probe_variants.cu"
DELAYS_US = (5, 10, 20, 40)


def interleaved_ms(fns: dict, reps: int, rotate: bool = False) -> dict:
    """Device ms of one call of each function, the functions taken in turns
    ``reps`` times, each sample behind a stream spin; samples by name.
    ``rotate``: turn r starts at the r-th function, so that each follows
    each other one about equally often."""
    import torch

    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    names = list(fns)
    for r in range(reps):
        k = r % len(names) if rotate else 0
        for name in names[k:] + names[:k]:
            fn = fns[name]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return times


def variant_library(build, tmp: str) -> ctypes.CDLL:
    """``torch_probe_variants.cu`` built with the tree's nvcc flags."""
    so = Path(tmp) / "libprobe_variants.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", str(VARIANTS_CU),
                           "-o", str(so)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {VARIANTS_CU.name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.probe_variant.argtypes = [ctypes.c_int, P, P, ctypes.c_longlong, P]
    return lib


def after_us(us: float, fn):
    """``fn`` called once the host has spun ``us`` microseconds."""
    def call():
        end = time.perf_counter() + us * 1e-6
        while time.perf_counter() < end:
            pass
        return fn()
    return call


def probe_turns(randn, build, variants: bool) -> dict:
    import torch
    from repro_torch.kernels import probe as pb

    x = randn(PROBE_ROWS, 256, seed=430)
    bits = x.view(-1).view(torch.int32)
    bits[1], bits[2], bits[300] = 0x7FC00123, -(2 ** 31), -1   # a NaN's payload, -0.0, a NaN
    copies = {"probe_copy_2d": lambda: pb.probe_copy_2d(x), "x.clone()": lambda: x.clone(),
              "empty_like + copy_": lambda: pb.probe_copy_2d_plain(x)}
    check = {"probe_copy_2d": copies["probe_copy_2d"]}
    with tempfile.TemporaryDirectory() as tmp:
        if variants:
            for us in DELAYS_US:
                copies[f"probe_copy_2d {us} us after"] = after_us(us, copies["probe_copy_2d"])
            lib = variant_library(build, tmp)
            stream = build.current_stream(x.device)

            def variant(i):
                out = torch.empty_like(x)
                build.check(lib.probe_variant(i, x.data_ptr(), out.data_ptr(), PROBE_ROWS, stream),
                            f"probe variant {VARIANTS[i]}")
                return out

            for i, name in enumerate(VARIANTS):
                copies[f"variant {name}"] = check[name] = (lambda i=i: variant(i))
        for name, fn in check.items():
            out = fn()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), x.view(torch.int32)):
                raise RuntimeError(f"{name} is not a bit-exact copy")
            del out
        times = interleaved_ms(copies, reps=21, rotate=True)
    res = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        res[name] = {"median": statistics.median(ts), "iqr": q3 - q1}
    return res


def child(tree: Path, probe: bool, variants: bool) -> dict:
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as fl

    dev = torch.device("cuda", 0)

    def randn(*shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(*shape, generator=g, device=dev)

    build.library()
    out = {"tree": str(tree)}
    if probe:
        out.update(probe_turns(randn, build, variants))
        return out
    for label, B, H, KV, S, hd in FLASH:
        q, k, v = randn(B * H, S, hd, seed=1), randn(B * KV, S, hd, seed=2), randn(B * KV, S, hd, seed=3)
        out[f"flash f32 {label}"] = statistics.median(interleaved_ms(
            {label: lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)},
            reps=10)[label])
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."], help="checkout roots, in the order of turns")
    ap.add_argument("--probe", action="store_true",
                    help="time the copy probe beside x.clone() instead of the flash kernel")
    ap.add_argument("--variants", action="store_true",
                    help="with --probe: add the designs of torch_probe_variants.cu and the "
                         "probe launched later after its start event")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variants and not args.probe:
        ap.error("--variants needs --probe")
    if args.child:
        print(json.dumps(child(Path(args.child).resolve(), args.probe, args.variants)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    flags = [f"--{f}" for f in ("probe", "variants") if getattr(args, f)]
    turns = []
    for tree in args.trees:
        proc = subprocess.run([sys.executable, __file__, "--child", tree, *flags],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit(f"{tree} failed:\n{proc.stderr[-3000:]}")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]))
    keys = [k for k in turns[0] if k != "tree"]
    print("ms | " + " | ".join(t["tree"] for t in turns))
    for key in keys:
        cells = [t.get(key) for t in turns]
        print(f"{key} | " + " | ".join(
            "-" if c is None else f"{c:.4f}" if isinstance(c, float)
            else f"{c['median']:.4f} (iqr {c['iqr']:.4f})" for c in cells))


if __name__ == "__main__":
    main()
