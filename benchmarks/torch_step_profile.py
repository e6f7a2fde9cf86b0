#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time on the GPU.

    PYTHONPATH=src python benchmarks/torch_step_profile.py [--layers 32] [--steps 3]
    PYTHONPATH=src python benchmarks/torch_step_profile.py --arch moonshot-v1-16b-a3b --layers 4
    PYTHONPATH=src python benchmarks/torch_step_profile.py --dtype float32   # the benchmark cells' dtype

Runs the explicit-comm training step of ``--arch`` (stablelm-3b by default;
full width, S = 4096, batch 1, int8) once to warm up, then profiles
``--steps`` steps with ``torch.profiler`` (host operations and the
device), which switches on the program's own spans (``utils/trace``).
Prints, a step, each span name's device ms and self ms (less the part its
child spans cover), the counters' change over a step, the kernels that
take most device time, the device's idle share of the profiled window,
and the clock check: each span's ``time.time_ns()`` interval against its
``record_function`` range in the profile, and the kernels launched inside
it against its start.  Needs a CUDA device; prints the card's name and
power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import CommConfig, INPUT_SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_put_batch  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedule import get_schedule  # noqa: E402
from repro_torch.parallel.collectives import InProcessWorld  # noqa: E402
from repro_torch.utils import trace  # noqa: E402


def _events(prof):
    """(host events, device events) of a profile as (start ns, end ns, name,
    correlation id), on the profile's clock: ``time.time_ns()``'s."""
    from torch.autograd import DeviceType

    t0 = prof.profiler.kineto_results.trace_start_ns()
    host, device = [], []
    for e in prof.events():
        row = (t0 + int(e.time_range.start * 1e3), t0 + int(e.time_range.end * 1e3), e.name, e.id)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append(row)
        else:
            host.append(row)
    return host, device


def clock_check(prof, records) -> dict:
    """How each span's host interval sits against the profile: ``range_ns``,
    the most by which a span's ``record_function`` range reaches out of its
    interval (0 where every range lies inside); ``unmatched``, spans with
    no range of their name; ``kernel_ns``, the most by which a kernel
    launched inside a span starts before the span does (0 where none)."""
    host, device = _events(prof)
    by_name = defaultdict(list)
    for a, b, name, _ in host:
        by_name[name].append((a, b))
    starts = {cid: a for a, _, _, cid in device}
    launches = sorted((a, starts[cid]) for a, _, name, cid in host
                      if cid in starts and name.startswith("cuda"))
    range_ns, kernel_ns, unmatched = 0, 0, 0
    for r in records:
        ranges = by_name.get(r.name)
        if not ranges:
            unmatched += 1
            continue
        a, b = min(ranges, key=lambda ab: abs(ab[0] - r.start_ns))
        range_ns = max(range_ns, r.start_ns - a, b - r.end_ns)
        for launched, started in launches:
            if r.start_ns <= launched <= r.end_ns:
                kernel_ns = max(kernel_ns, r.start_ns - started)
    return {"range_ns": range_ns, "unmatched": unmatched, "kernel_ns": kernel_ns}


def span_table(records, steps: int):
    """[(name, device ms a step, self ms a step, spans a step)], by name,
    in the order names first closed."""
    table = {}
    for r, own in trace.self_ms(records):
        row = table.setdefault(r.name, [0.0, 0.0, 0])
        row[0] += r.ms / steps
        row[1] += own / steps
        row[2] += 1
    return [(name, ms, own, n / steps) for name, (ms, own, n) in table.items()]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--compression", default="int8")
    ap.add_argument("--dtype", default="", help="the model's dtype in place of the config's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = get_config(args.arch).replace(num_layers=args.layers)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    shape = InputShape("train_4k", INPUT_SHAPES["train_4k"].seq_len, 1, "train")
    comm = CommConfig(mode="explicit", compression=args.compression)
    api, opt = get_model(cfg), get_optimizer("adamw")
    params = api.init(torch.Generator(device=device).manual_seed(0))
    state = opt.init(params)
    step_fn = make_train_step(api, opt, InProcessWorld(1), comm,
                              get_schedule("cosine", 3e-4, 5, 20), clip_norm=1.0)
    data = SyntheticLM(cfg, shape, seed=0)
    batches = [device_put_batch(data.batch(i), device) for i in range(args.steps + 1)]

    params, state, _ = step_fn(params, state, batches[0])      # builds the kernels, warms up
    torch.cuda.synchronize(device)
    trace.clear()
    trace.reset_counts()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[1:]:
            params, state, _ = step_fn(params, state, batch)
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    records = trace.records()
    n = args.steps
    print(f"{cfg.name}, {args.layers} layers, {cfg.dtype}, S={shape.seq_len}, batch 1, "
          f"{args.compression}; {n} steps profiled with host operations, a step:")
    print(f"  {'span':18s} {'device ms':>10s} {'self ms':>10s} {'spans':>7s}")
    for name, ms, own, count in span_table(records, n):
        print(f"  {name:18s} {ms:10.2f} {own:10.2f} {count:7.1f}")
    deltas = defaultdict(int)
    for r in records:
        for k, v in r.attrs.get("counts", {}).items():
            deltas[k] += v
    print("  counters a step: " + ", ".join(f"{k} {v / n:g}" for k, v in sorted(deltas.items())))

    _, device_events = _events(prof)
    busy_ms = sum(b - a for a, b, _, _ in device_events) / 1e6
    print(f"  wall {wall_ms / n:.1f} ms, device busy {busy_ms / n:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f} (host operations recorded)")
    by_kernel = defaultdict(lambda: [0.0, 0])
    for a, b, name, _ in device_events:
        by_kernel[name[:110]][0] += (b - a) / 1e6
        by_kernel[name[:110]][1] += 1
    print(f"top kernels by device time (ms over {n} steps, calls):")
    for name, (ms, calls) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:22]:
        print(f"  {ms:9.2f}  {calls:6d}  {name}")
    check = clock_check(prof, records)
    print(f"clock check over {len(records)} spans: record_function ranges reach out of their "
          f"span by at most {check['range_ns'] / 1e3:.1f} us ({check['unmatched']} unmatched); "
          f"kernels launched inside a span start before it by at most "
          f"{check['kernel_ns'] / 1e3:.1f} us")


if __name__ == "__main__":
    main()
