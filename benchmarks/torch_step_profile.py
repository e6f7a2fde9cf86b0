#!/usr/bin/env python3
"""Where one training step of the PyTorch port spends its time on the GPU.

    PYTHONPATH=src python benchmarks/torch_step_profile.py [--layers 32] [--steps 3]
    PYTHONPATH=src python benchmarks/torch_step_profile.py --arch moonshot-v1-16b-a3b --layers 4

Runs the explicit-comm int8 training step of ``--arch`` (stablelm-3b by
default; full width, bf16, S = 4096, batch 1) phase by phase, with a device synchronise after each
phase (forward+backward, gradient sync, clipping, AdamW), then traces two
steps with ``torch.profiler`` and prints the kernels that take most device
time and the device's idle share of the traced window.  Needs a CUDA
device; prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import CommConfig, INPUT_SHAPES, InputShape, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_put_batch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedule import clip_by_global_norm, get_schedule  # noqa: E402
from repro_torch.parallel.collectives import InProcessWorld  # noqa: E402
from repro_torch.parallel.grad_sync import sync_grads  # noqa: E402
from repro_torch.utils.tree import value_and_grad  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--compression", default="int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = get_config(args.arch).replace(num_layers=args.layers)
    shape = InputShape("train_4k", INPUT_SHAPES["train_4k"].seq_len, 1, "train")
    comm = CommConfig(mode="explicit", compression=args.compression)
    world = InProcessWorld(1)
    api, opt = get_model(cfg), get_optimizer("adamw")
    params = api.init(torch.Generator(device=device).manual_seed(0))
    state = opt.init(params)
    lr_fn = get_schedule("cosine", 3e-4, 5, 20)
    data = SyntheticLM(cfg, shape, seed=0)

    def sync():
        torch.cuda.synchronize(device)
        return time.perf_counter()

    phases = {"fwd_bwd": [], "grad_sync": [], "clip": [], "adamw": [], "step": []}
    for step in range(args.steps + 1):
        batch = device_put_batch(data.batch(step), device)
        t0 = sync()
        (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
        t1 = sync()
        grads = sync_grads(grads, world, comm)
        t2 = sync()
        grads, _ = clip_by_global_norm(grads, 1.0)
        t3 = sync()
        params, state = opt.update(params, state, grads, lr_fn(state.count))
        t4 = sync()
        del grads
        if step:                                   # step 0 builds the kernels and warms up
            for name, dt in zip(phases, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t4 - t0)):
                phases[name].append(dt * 1e3)
    print(f"phases, median of {args.steps} steps after one warm-up step "
          f"({cfg.name}, {args.layers} layers, S=4096, batch 1, {args.compression}), ms:")
    for name, xs in phases.items():
        print(f"  {name:10s} {statistics.median(xs):9.1f}")

    step_fn = make_train_step(api, opt, world, comm, lr_fn, clip_norm=1.0)
    batch = device_put_batch(data.batch(99), device)
    build.reset_launch_counts()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = sync()
        for _ in range(2):
            params, state, _ = step_fn(params, state, batch)
        t1 = sync()
    wall_ms = (t1 - t0) * 1e3
    events = prof.key_averages()
    dev_time = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))  # noqa: E731
    kernels = [e for e in events if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower() and dev_time(e) > 0]
    if not kernels:
        kernels = [e for e in events if dev_time(e) > 0]
    busy_ms = sum(dev_time(e) for e in kernels) / 1e3
    print(f"traced 2 steps: wall {wall_ms:.1f} ms, device kernel time {busy_ms:.1f} ms, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; launches {dict(build.launch_counts)}")
    print("top kernels by device time (ms over 2 steps, calls):")
    for e in sorted(kernels, key=dev_time, reverse=True)[:22]:
        print(f"  {dev_time(e) / 1e3:9.2f}  {e.count:6d}  {e.key[:110]}")


if __name__ == "__main__":
    main()
