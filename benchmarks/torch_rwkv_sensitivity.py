#!/usr/bin/env python3
"""How far rounding noise carries through rwkv6-1.6b's prefill on the GPU.

    PYTHONPATH=src python benchmarks/torch_rwkv_sensitivity.py

For bf16 at 1, 4, 12 and 24 layers (batch 4) and float32 at 24 layers
(batch 2), all with prompts of 4096 tokens and seed-0 parameters, it
compares the next-token logits of three prefills: through the WKV kernel,
through the plain chunked form with chunks of 128 (the config's), and
through the plain form with chunks of 64 (the same function, another
summation order).  The rel L2 of plain-64 against plain-128 is the model's
own spread under a change of summation order: the yardstick
``chip_smoke.py`` holds the kernel run to.  Needs a CUDA device; prints the
card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

PROMPT = 4096


def last_logits(cfg, params, tokens) -> torch.Tensor:
    with torch.inference_mode():
        logits, _ = get_model(cfg).prefill(params, {"tokens": tokens})
    return logits[:, -1].float()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_rwkv_sensitivity: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    for dtype, layers, batch in [("bfloat16", 24, 4), ("float32", 24, 2), ("bfloat16", 1, 4),
                                 ("bfloat16", 4, 4), ("bfloat16", 12, 4)]:
        cfg = get_config("rwkv6-1.6b").replace(num_layers=layers, dtype=dtype)
        params = get_model(cfg).init(torch.Generator(device=device).manual_seed(0))
        raw = SyntheticLM(cfg, InputShape("prompt", PROMPT, batch, "prefill"), seed=0).batch(0)
        tokens = torch.from_numpy(raw["tokens"]).to(device)
        kernel = last_logits(cfg, params, tokens)
        plain128 = last_logits(cfg.replace(use_pallas="never"), params, tokens)
        plain64 = last_logits(cfg.replace(use_pallas="never",
                                          ssm=dataclasses.replace(cfg.ssm, chunk_size=64)),
                              params, tokens)
        agree = float((kernel.argmax(-1) == plain128.argmax(-1)).float().mean())
        print(f"{dtype} layers={layers} batch={batch}: kernel vs plain128 {rel_l2(kernel, plain128):.3e}, "
              f"plain64 vs plain128 {rel_l2(plain64, plain128):.3e}, kernel vs plain64 "
              f"{rel_l2(kernel, plain64):.3e}, argmax agrees {agree:.2f}", flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
