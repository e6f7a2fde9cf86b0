#!/usr/bin/env python3
"""Where serving time goes in the PyTorch port on the GPU.

    PYTHONPATH=src python benchmarks/torch_serve_profile.py [--arch stablelm-3b] \
        [--batch 4] [--prompt-len 4096] [--gen 8] [--layers N]
    PYTHONPATH=src python benchmarks/torch_serve_profile.py --arch jamba-v0.1-52b --layers 8

Runs the serving path of ``repro_torch.launch.serve`` (one prefill of
``serve.prompt_batch``'s prompts, a VLM's prefix embeddings and Whisper's
frames with them, then greedy decode steps against the cache) at full
width, with random seed-0 parameters, at full depth unless ``--layers`` cuts it (jamba-v0.1-52b
takes a multiple of 8 and does not fit one card at its 32), and traces
the prefill and ``--gen`` decode steps separately with
``torch.profiler``: wall time, device kernel time, the
device's idle share of each window, and the kernels that take most device
time.  Needs a CUDA device; prints the card's name and power limit beside
the numbers.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import prompt_batch  # noqa: E402
from repro_torch.models.registry import get_model, pad_cache  # noqa: E402
from repro_torch.utils import trace  # noqa: E402


def _device_time(e) -> float:
    return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))


def report(label: str, prof, wall_ms: float, top: int) -> None:
    events = prof.key_averages()
    kernels = [e for e in events if getattr(e, "device_type", None) is not None
               and "cuda" in str(e.device_type).lower() and _device_time(e) > 0]
    if not kernels:
        kernels = [e for e in events if _device_time(e) > 0]
    busy_ms = sum(_device_time(e) for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"{label}: wall {wall_ms:.1f} ms, device kernel time {busy_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}, {n_launch} kernel launches")
    for e in sorted(kernels, key=_device_time, reverse=True)[:top]:
        print(f"  {_device_time(e) / 1e3:9.2f} ms  {e.count:6d}  {e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=4096)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_serve_profile: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    api = get_model(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    params = api.init(torch.Generator(device=device).manual_seed(0))
    batch = prompt_batch(cfg, B, P, 0, device)             # with a VLM's prefix, Whisper's frames
    n_cached = P + (cfg.prefix_embeds if cfg.family == "vlm" else 0)

    def sync() -> float:
        torch.cuda.synchronize(device)
        return time.perf_counter()

    with torch.inference_mode():
        api.prefill(params, {**batch, "tokens": batch["tokens"][:, :256]})   # builds, warms up
        trace.reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = sync()
            logits, cache = api.prefill(params, batch)
            t1 = sync()
        counts = trace.counts("launch") + trace.counts("route")
        print(f"{cfg.name}, {cfg.num_layers} layers, batch {B}, prompt {P}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        report("prefill (traced)", prof, (t1 - t0) * 1e3, args.top)

        cache = pad_cache(cache, n_cached + G + 1)
        tokens = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        logits, cache = api.decode_step(params, {"tokens": tokens}, cache, n_cached)   # warm-up
        t0 = sync()
        for i in range(G):
            logits, cache = api.decode_step(params, {"tokens": tokens}, cache, n_cached + 1 + i)
        t1 = sync()
        print(f"decode, untraced: {(t1 - t0) / G * 1e3:.2f} ms a step")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = sync()
            for i in range(G):
                logits, cache = api.decode_step(params, {"tokens": tokens}, cache, n_cached + 1 + i)
            t1 = sync()
        report(f"decode, {G} steps (traced)", prof, (t1 - t0) * 1e3, args.top)


if __name__ == "__main__":
    main()
