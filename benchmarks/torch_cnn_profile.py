#!/usr/bin/env python3
"""Where one fwd+bwd of the paper's CNNs spends its time on the GPU, and
what the conv weights' layout costs.

    PYTHONPATH=src python benchmarks/torch_cnn_profile.py [--models vgg16 resnet50 resnet101]

For each model at full width, batch 32, 224x224, 1,000 classes, float32:

- ``t_batch`` (median of 5 after 2 warm-ups, host clock around a step that
  ends in a synchronise) with TF32 off and on, each with the weights as
  ``models.cnn`` hands them to cuDNN (an HWIO leaf seen as OIHW, a view)
  and with an explicit ``.contiguous(memory_format=torch.channels_last)``
  of that view in the forward, in turns (view, contiguous, contiguous, view);
- a ``torch.profiler`` trace of two steps in each precision: device time by kernel
  class (convolution, matmul, batch norm, elementwise, pooling, layout
  copies, reductions, other), the kernels that take most of it, and the
  device's idle share of the traced window.

Needs a CUDA device; prints the card's name and power limit beside the
numbers.  ``--out`` writes them as JSON.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

from examples.torch_measured_whatif import measure_step, tf32  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.utils.tree import value_and_grad  # noqa: E402

BATCH = 32
CLASSES = (  # kernel class -> name fragments, first match wins
    ("convolution", ("fprop", "dgrad", "wgrad", "conv", "winograd", "implicit", "fft",
                     "cf32", "complex")),      # FFT convolutions: complex GEMMs and products
    ("matmul", ("gemm", "gemv")),
    ("batch_norm", ("batch_norm", "bn_", "batchnorm")),
    ("pooling", ("pool",)),
    ("layout_copy", ("copy", "transpose", "nchw", "nhwc", "permute")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, frags in CLASSES:
        if any(f in low for f in frags):
            return cls
    return "other"


def timed(name: str, contiguous_weights: bool) -> float:
    plain = cnn._oihw
    if contiguous_weights:
        cnn._oihw = lambda w: plain(w).contiguous(memory_format=torch.channels_last)
    try:
        return measure_step(name, 1.0, BATCH, repeats=5, device="cuda", warmup=2)
    finally:
        cnn._oihw = plain


def profile(name: str) -> dict:
    from torch.profiler import ProfilerActivity, profile as trace

    params, forward = cnn.get_cnn(name, torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator(device="cuda").manual_seed(1)
    data = {"images": torch.randn(BATCH, 224, 224, 3, device="cuda", generator=g),
            "labels": torch.zeros(BATCH, dtype=torch.long, device="cuda")}

    def step():
        value_and_grad(lambda p, b: (cnn.cnn_loss(forward, p, b), {}), params, data)

    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(2):
            step()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    dev_time = lambda e: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))  # noqa: E731
    events = prof.key_averages()
    kernels = [e for e in events if "cuda" in str(getattr(e, "device_type", "")).lower()
               and dev_time(e) > 0]
    busy_ms = sum(dev_time(e) for e in kernels) / 1e3
    by_class: dict = {}
    for e in kernels:
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_time(e) / 2e3       # ms a step
    top = [{"ms_per_step": dev_time(e) / 2e3, "calls_per_step": e.count / 2, "kernel": e.key[:120]}
           for e in sorted(kernels, key=dev_time, reverse=True)[:12]]
    return {"window_ms_per_step": window_ms / 2, "kernel_ms_per_step": busy_ms / 2,
            "idle_share": max(0.0, 1.0 - busy_ms / window_ms),
            "by_class_ms_per_step": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
            "top_kernels": top, "n_kernels_per_step": sum(e.count for e in kernels) / 2}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=list(cnn.CNN_NAMES), choices=cnn.CNN_NAMES)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_cnn_profile: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"cudnn {torch.backends.cudnn.version()}")
    out = {"card": card, "batch": BATCH, "models": {}}
    for name in args.models:
        res = {}
        for mode in (False, True):
            with tf32(mode):
                label = "tf32" if mode else "f32"
                # in turns: view, contiguous, contiguous, view
                view, contig = [], []
                for contiguous in (False, True, True, False):
                    (contig if contiguous else view).append(timed(name, contiguous))
                res[label] = {"t_batch_ms_view": statistics.median(view) * 1e3,
                              "t_batch_ms_channels_last": statistics.median(contig) * 1e3,
                              "runs_ms_view": [t * 1e3 for t in view],
                              "runs_ms_channels_last": [t * 1e3 for t in contig]}
                print(f"{name} {label}: t_batch with weight views {res[label]['t_batch_ms_view']:.2f} ms "
                      f"{res[label]['runs_ms_view']}, with channels_last weights "
                      f"{res[label]['t_batch_ms_channels_last']:.2f} ms "
                      f"{res[label]['runs_ms_channels_last']}")
        for mode in (False, True):
            label = "tf32" if mode else "f32"
            with tf32(mode):
                res[f"profile_{label}"] = p = profile(name)
            print(f"{name} {label} trace (2 steps): {p['window_ms_per_step']:.2f} ms a step, kernels "
                  f"{p['kernel_ms_per_step']:.2f} ms ({p['n_kernels_per_step']:.0f} launches), idle "
                  f"share {p['idle_share']:.3f}")
            for cls, ms in p["by_class_ms_per_step"].items():
                print(f"  {cls:12s} {ms:9.3f} ms a step")
            for k in p["top_kernels"]:
                print(f"  {k['ms_per_step']:9.3f} ms  {k['calls_per_step']:6.1f}x  {k['kernel']}")
        out["models"][name] = res
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
