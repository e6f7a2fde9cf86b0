#!/usr/bin/env python3
"""Kernel micro-benchmarks and the codec cost calibration of the PyTorch port.

Counterpart of ``benchmarks/kernel_bench.py``.  Two modes:

- default: the micro-bench table (each codec kernel and its plain version
  at 1 Mi f32 elements, with the achieved GB/s);
- ``--calibrate``: time every codec stage against the copy probe
  ``probe_copy_2d`` (a hand-written kernel with the codec kernels' launch
  shape) and emit the calibration table that ``repro_torch.core.codec``
  reads (``artifacts/bench/BENCH_codec_h100.json`` for the H100).

The table holds **probe-normalised passes**: a stage's time divided by the
probe's time on the same input.  Machine speed cancels in the ratio, and
the simulator prices a stage as that many copies' worth of memory traffic
at the modelled device's memory rate.  Times come from CUDA events around
launches queued behind a short spin of the stream (so the host's launch
time is not in them), the median of the repeats after two warm-ups.

``--elements`` sets the input size; 1 << 18 (1 MiB) is the reference's.  On
the H100 every stage at 1 MiB stays in its 50 MB L2 and lasts a few
microseconds, so the ratios there say how fast launches follow each other,
not how fast the kernels stream.  The committed H100 table is measured at
566,231,040 elements (2.26 GB of f32, stablelm-3b's largest gradient
bucket), where every stage is bound by device memory::

    python benchmarks/torch_kernel_bench.py                       # micro-bench table
    python benchmarks/torch_kernel_bench.py --calibrate --elements 566231040 \\
        --out artifacts/bench/BENCH_codec_h100.json               # refresh the H100 table
    python benchmarks/torch_kernel_bench.py --calibrate --elements 566231040 \\
        --check artifacts/bench/BENCH_codec_h100.json             # gate
    python benchmarks/torch_kernel_bench.py --calibrate --quick --device cpu

With ``--check``, exits non-zero when a freshly measured pass count drifts
more than :data:`DRIFT_FACTOR` x from the committed table, or a codec
kernel in ``repro_torch.kernels.quantize`` has no table entry.  The default
device is ``cuda``, and the script raises where there is none; ``--device
cpu`` runs the plain versions and marks the table ``"interpret": true``, so
that a CPU table is never taken for the card's.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize as _q  # noqa: E402
from repro_torch.kernels import topk_mask as _tm  # noqa: E402
from repro_torch.kernels.probe import probe_copy_2d  # noqa: E402,F401  (re-exported)

KIND = "repro-codec-bench"
SCHEMA_VERSION = 1
DRIFT_FACTOR = 2.0
DEFAULT_OUT = "BENCH_codec_h100.json"
DEFAULT_TABLE = REPO_ROOT / "artifacts" / "bench" / DEFAULT_OUT
LAUNCH_PROBE_ROWS = 64           # the probe at this many rows prices a launch

_CODEC_KERNEL_RE = re.compile(r"^quantize_(\w+)_2d$")
_HOLD_CYCLES_PER_LAUNCH = 100_000  # ~50 us of stream spin per queued launch


def resolve_device(name) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch_kernel_bench: no CUDA device; pass --device cpu to run "
                           "the plain versions")
    return device


def card_name(device: torch.device) -> str:
    """``name, power limit`` as nvidia-smi gives them, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[device.index or 0]


def _time_us(fn: Callable, device: torch.device, repeats: int, inner: int = 1) -> float:
    """Median time of one call of ``fn`` in microseconds, over ``repeats``
    samples of ``inner`` back-to-back calls, after two warm-up calls.

    On CUDA a spin kernel holds the stream while the host queues the
    sample, so the CUDA events see only the device's time."""
    for _ in range(2):
        fn()
    samples = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(repeats):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(_HOLD_CYCLES_PER_LAUNCH * inner)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            torch.cuda.synchronize(device)
            samples.append(e0.elapsed_time(e1) * 1e3 / inner)
    else:
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            samples.append((time.perf_counter() - t0) * 1e6 / inner)
    return statistics.median(samples)


def _inner(elements: int) -> int:
    """Launches per sample: enough that a small input's sample is not one
    launch's jitter, one for a bandwidth-bound input."""
    return max(1, min(64, (1 << 24) // max(elements, 1)))


def _randn(n: int, device: torch.device, seed: int) -> torch.Tensor:
    return torch.randn(n, generator=torch.Generator(device=device).manual_seed(seed),
                       device=device, dtype=torch.float32)


def run(device="cuda") -> List[Dict]:
    """The micro-bench table at 1 Mi elements, the reference's cases."""
    device = resolve_device(device)
    n = 1 << 20
    x = _randn(n, device, 0)
    bufs = _randn(n, device, 1).reshape(8, n // 8)
    cases = [
        ("quantize_int8_kernel", lambda: ops.quantize_int8(x)[0]),
        ("quantize_int8_plain", lambda: ops.quantize_int8(x, use_kernel=False)[0]),
        ("ternarize_kernel", lambda: ops.ternarize(x)[0]),
        ("ternarize_plain", lambda: ops.ternarize(x, use_kernel=False)[0]),
        ("topk_sparsify_kernel", lambda: ops.topk_sparsify(x, 0.01, sample=4096)),
        ("fused_add_kernel", lambda: ops.fused_add(bufs)),
        ("fused_add_plain", lambda: ops.fused_add(bufs, use_kernel=False)),
    ]
    rows = []
    for name, fn in cases:
        us = _time_us(fn, device, repeats=3, inner=_inner(n))
        gbps = n * 4 / (us / 1e6) / 1e9
        rows.append(dict(name=name, us_per_call=us, derived=f"{gbps:.2f}GB/s"))
    return rows


# ---------------------------------------------------------------------------
# codec cost calibration
# ---------------------------------------------------------------------------

def kernel_codec_names() -> List[str]:
    """Codec names implied by the kernels in ``repro_torch.kernels.quantize``:
    every ``quantize_<name>_2d`` entry point plus ``ternarize_2d``.  The
    ``--check`` gate fails if any of these is missing from the committed
    table, so a new compression kernel cannot land unpriced."""
    names = []
    for attr in dir(_q):
        m = _CODEC_KERNEL_RE.match(attr)
        if m and not attr.startswith("dequantize"):
            names.append(m.group(1))
    if hasattr(_q, "ternarize_2d"):
        names.append("ternary")
    return sorted(set(names))


def calibrate(quick: bool = False, *, elements: int = 1 << 18, device="cuda") -> Dict:
    """Measure probe-normalised pass counts for every codec stage.

    Quick and full mode use the same input and differ only in repeats, so
    that a quick run can be gated against a full table of the same size.
    Fixed per-call costs (the top-k threshold, estimated once from samples)
    stay out of the streaming passes; the simulator prices them as the
    per-bucket launch overhead."""
    from repro_torch.core.addest import H100_LAUNCH_OVERHEAD, H100_MEM_BW
    from repro_torch.core.codec import PROBE_BYTES_PER_BYTE

    device = resolve_device(device)
    repeats = 3 if quick else 9
    inner = _inner(elements)
    x = _randn(elements, device, 0)
    rows, _ = ops._to_rows(x)
    rows = rows.contiguous()

    def timed(fn):
        return _time_us(fn, device, repeats, inner)

    probe_us = timed(lambda: probe_copy_2d(rows))
    small = rows[:LAUNCH_PROBE_ROWS]
    launch_probe_us = _time_us(lambda: probe_copy_2d(small), device, repeats,
                               _inner(small.numel()))
    qv, sv = _q.quantize_int8_2d(rows)
    tv, tsv = _q.ternarize_2d(rows)
    # the threshold is estimated once per bucket from samples (a fixed
    # cost, not a pass), and stays a device scalar: no host sync when timed
    thr = ops.topk_threshold(x[::16], 1.0 / 8.0)

    stages = {
        "int8": {
            "encode_us": timed(lambda: _q.quantize_int8_2d(rows)),
            "decode_us": timed(lambda: _q.dequantize_int8_2d(qv, sv)),
        },
        "ternary": {
            "encode_us": timed(lambda: _q.ternarize_2d(rows)),
            # the ternary decode is the int8 decode kernel (ops.deternarize)
            "decode_us": timed(lambda: _q.dequantize_int8_2d(tv, tsv)),
        },
        "topk": {
            "encode_us": timed(lambda: _tm.topk_mask_2d(rows, thr)),
            # decode scatters kept values into a zeroed buffer: one
            # streaming pass, which is the probe itself
            "decode_us": probe_us,
        },
    }
    codecs = {}
    for name, t in stages.items():
        codecs[name] = {
            "encode_us": round(t["encode_us"], 3),
            "decode_us": round(t["decode_us"], 3),
            "encode_passes": round(t["encode_us"] / probe_us, 3),
            "decode_passes": round(t["decode_us"] / probe_us, 3),
        }
    return {
        "kind": KIND,
        "schema_version": SCHEMA_VERSION,
        "quick": quick,
        "interpret": device.type != "cuda",
        "n_bytes": rows.numel() * 4,
        "probe_us": round(probe_us, 3),
        "launch_probe_us": round(launch_probe_us, 3),
        "device_model": {
            "name": "h100",
            "mem_bw": H100_MEM_BW,
            "launch_overhead": H100_LAUNCH_OVERHEAD,
            "probe_bytes_per_byte": PROBE_BYTES_PER_BYTE,
            "card": card_name(device),
        },
        "codecs": codecs,
    }


def check_table(fresh: Dict, table_path: Path) -> List[str]:
    """The gate: committed table vs a fresh measurement, and kernel coverage."""
    try:
        committed = json.loads(Path(table_path).read_text())
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot read table {table_path}: {e}"]
    if committed.get("kind") != KIND:
        return [f"{table_path} is not a {KIND}"]
    failures = []
    have = committed.get("codecs", {})
    for name in kernel_codec_names():
        if name not in have:
            failures.append(
                f"kernel codec {name!r} (repro_torch.kernels.quantize) has no "
                f"entry in {Path(table_path).name}: re-run --calibrate")
    for name, entry in fresh["codecs"].items():
        if name not in have:
            failures.append(f"measured codec {name!r} missing from {Path(table_path).name}")
            continue
        for stage in ("encode_passes", "decode_passes"):
            old, new = have[name][stage], entry[stage]
            lo, hi = sorted((old, new))
            if lo <= 0 or hi / lo > DRIFT_FACTOR:
                failures.append(
                    f"{name}.{stage} drifted >{DRIFT_FACTOR}x: committed {old} vs "
                    f"measured {new}: kernels changed without re-running --calibrate?")
    return failures


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmarks/torch_kernel_bench.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="emit the codec cost table instead of the micro-bench")
    ap.add_argument("--quick", action="store_true", help="fewer repeats")
    ap.add_argument("--out", default=None,
                    help=f"calibration JSON path (e.g. {DEFAULT_OUT})")
    ap.add_argument("--check", default=None,
                    help="committed table to gate against "
                         f"(e.g. {DEFAULT_TABLE.relative_to(REPO_ROOT)})")
    ap.add_argument("--elements", type=int, default=1 << 18,
                    help="f32 elements of the calibration input (default 1 << 18, 1 MiB)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if not args.calibrate:
        for row in run(args.device):
            print(f"{row['name']:24s} {row['us_per_call']:10.3f} us  {row['derived']}")
        return 0

    result = calibrate(quick=args.quick, elements=args.elements, device=args.device)
    print(f"probe: {result['probe_us']:.3f} us over {result['n_bytes']} bytes "
          f"(interpret={result['interpret']}, card {result['device_model']['card']}); "
          f"{LAUNCH_PROBE_ROWS} rows: {result['launch_probe_us']:.3f} us")
    for name, c in sorted(result["codecs"].items()):
        print(f"{name:8s} encode {c['encode_passes']:.3f} passes ({c['encode_us']:.3f} us)  "
              f"decode {c['decode_passes']:.3f} passes ({c['decode_us']:.3f} us)")

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(result, indent=1, sort_keys=True) + "\n")
        print(f"wrote {out}")

    if args.check:
        failures = check_table(result, Path(args.check))
        if failures:
            for f in failures:
                print(f"FAIL: {f}")
            return 1
        print(f"calibration OK vs {args.check} (drift gate {DRIFT_FACTOR}x, codecs "
              f"{', '.join(kernel_codec_names())} covered)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
