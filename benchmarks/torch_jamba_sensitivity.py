#!/usr/bin/env python3
"""How far rounding noise carries through jamba-v0.1-52b's prefill on the GPU.

    PYTHONPATH=src python benchmarks/torch_jamba_sensitivity.py

One super-block at full width (8 layers: 7 Mamba, 1 attention, 4 MoE),
seed-0 parameters, prompts of 4096 tokens.  In bf16 at batch 4 it compares
the next-token logits of prefills through both kernels, through each kernel
alone (the other layer kind on its plain path), and through the plain path
under several summation orders (other chunk sizes of the attention and of the
Mamba scan), each against the plain path with the config's chunks; and for
each it counts the MoE routing decisions (the top-2 experts of a token in a
layer) that differ from the plain run's.  In float32 at batch 1 it compares
kernels and plain path once more.  The largest plain-vs-plain distance is
the yardstick ``chip_smoke.py`` holds the kernel run to.  Needs a CUDA
device; prints the card's name and power limit.
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
from repro_torch.models import attention, mamba, moe  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

PROMPT = 4096
LAYERS = 8


def run(cfg, params, tokens, flash: bool = True, scan: bool = True):
    """Last-position logits and the top-k expert indices of every MoE call.
    ``flash`` / ``scan`` False keep that kernel off (its plain path) while
    the other follows ``cfg.use_pallas``."""
    routes = []
    real = attention.use_pallas, mamba.use_pallas, moe.top_k

    def top_k(probs, k):
        vals, idx = real[2](probs, k)
        routes.append(torch.sort(idx, dim=-1).values.to(torch.int8).cpu())
        return vals, idx

    if not flash:
        attention.use_pallas = lambda cfg, x: False
    if not scan:
        mamba.use_pallas = lambda cfg, x: False
    moe.top_k = top_k
    try:
        with torch.inference_mode():
            logits, _ = get_model(cfg).prefill(params, {"tokens": tokens})
    finally:
        attention.use_pallas, mamba.use_pallas, moe.top_k = real
    return logits[:, -1].float(), routes


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


def changed_routes(a: list, b: list) -> str:
    """Share of (token, MoE layer) whose set of experts differs."""
    diff = [float((x != y).any(-1).float().mean()) for x, y in zip(a, b)]
    return ", ".join(f"{d:.4f}" for d in diff)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_jamba_sensitivity: needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    base = get_config("jamba-v0.1-52b").replace(num_layers=LAYERS)
    ssm = base.ssm
    for dtype, batch in [("bfloat16", 4), ("float32", 1)]:
        cfg = base.replace(dtype=dtype)
        params = get_model(cfg).init(torch.Generator(device=device).manual_seed(0))
        raw = SyntheticLM(cfg, InputShape("prompt", PROMPT, batch, "prefill"), seed=0).batch(0)
        tokens = torch.from_numpy(raw["tokens"]).to(device)
        plain = cfg.replace(use_pallas="never")
        ref, ref_routes = run(plain, params, tokens)
        runs = {"kernels": (cfg, True, True)}
        if dtype == "bfloat16":
            runs.update({
                "flash kernel only": (cfg, True, False),
                "scan kernel only": (cfg, False, True),
                "plain, attn_chunk 512 and ssm chunk 64": (
                    plain.replace(attn_chunk=512, ssm=dataclasses.replace(ssm, chunk_size=64)), 1, 1),
                "plain, ssm chunk 256": (plain.replace(ssm=dataclasses.replace(ssm, chunk_size=256)), 1, 1),
                "plain, ssm chunk 32": (plain.replace(ssm=dataclasses.replace(ssm, chunk_size=32)), 1, 1),
                "plain, attn_chunk 2048": (plain.replace(attn_chunk=2048), 1, 1),
            })
        else:
            runs["plain, attn_chunk 512 and ssm chunk 64"] = (
                plain.replace(attn_chunk=512, ssm=dataclasses.replace(ssm, chunk_size=64)), 1, 1)
        for label, (c, flash, scan) in runs.items():
            out, routes = run(c, params, tokens, flash=bool(flash), scan=bool(scan))
            agree = float((out.argmax(-1) == ref.argmax(-1)).float().mean())
            print(f"{dtype} batch={batch} {label} vs plain: rel L2 {rel_l2(out, ref):.3e}, argmax agrees "
                  f"{agree:.2f}, routing changed per MoE layer [{changed_routes(routes, ref_routes)}]",
                  flush=True)
        del params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
