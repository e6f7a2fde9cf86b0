#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on a GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
with ``nvcc``, holds each against its plain PyTorch version on the card
(edge shapes and the shapes the main paths give it), times kernel, plain
version, memory/compute bound and a library yardstick, checks the K = 4
gradient sync against a float64 mean, and then drives the port's paths
through their entry points:

- the codec calibration, ``benchmarks/torch_kernel_bench.main`` with
  ``--calibrate`` at stablelm-3b's largest bucket (566,231,040 f32) gated
  against the committed ``artifacts/bench/BENCH_codec_h100.json``, and at
  the reference's 1 MiB; ``AddEst.measure`` on the card; and
  ``timeline.measure`` on stablelm-3b at full width and depth;

- ``repro_torch.launch.train.main`` on stablelm-3b at full width (bf16,
  S = 4096, batch 1, explicit comm, int8 compression, AdamW), the same run
  on the plain versions, and two ternary steps;
- ``repro_torch.launch.serve.main`` on stablelm-3b and on rwkv6-1.6b at full
  width and depth, and on jamba-v0.1-52b at full width, one super-block of 8
  layers deep (batch 4, prompt 4096, 32 generated tokens), each held against
  a run on the plain versions (within twice the plain path's own spread
  under other summation orders) and, for rwkv6-1.6b and jamba-v0.1-52b, in
  float32 too;
- one Mamba mixer of jamba-v0.1-52b at full width in float32, forward and
  gradients, through the selective-scan kernel against the plain scan;
- the trainer with ``--compression topk`` (stablelm-3b) and the trainer on
  rwkv6-1.6b (int8), 8 layers each.

Launch counters, reset right before each run and read right after, show
that the run went through the kernels.

Any failed phase raises, so the exit code is non-zero and the closing JSON
lines are not printed.  Without a CUDA device it exits non-zero at once.
``--layers N`` cuts the depth of the int8 trainer run (default: the model's 32).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# jamba-v0.1-52b serving holds 26.6 GB of weights and 8 GiB tensors: let the
# allocator grow segments instead of stranding reserved blocks
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import INPUT_SHAPES, CommConfig, InputShape, get_config  # noqa: E402
from repro_torch.core import timeline  # noqa: E402
from repro_torch.core.addest import H100_LAUNCH_OVERHEAD, AddEst  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, device_put_batch  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attn as fl  # noqa: E402
from repro_torch.kernels import fused_add as fa  # noqa: E402
from repro_torch.kernels import probe as pb  # noqa: E402
from repro_torch.kernels import quantize as qz  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import topk_mask as tm  # noqa: E402
from repro_torch.kernels import wkv as wk  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.models.jamba import block_layout as jamba_layout  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.parallel.collectives import InProcessWorld  # noqa: E402
from repro_torch.parallel.grad_sync import make_plan, sync_grads_per_rank  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = 989e12                # dense tensor-core rate, bf16
F32_FLOPS = 67e12                  # CUDA cores, f32
CSRC = "src/repro_torch/kernels/csrc/"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median time of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def randn(*shape, seed: int, dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=DEV, dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def check_int8(x: torch.Tensor, label: str) -> float:
    q, s = qz.quantize_int8_2d(x)
    qp, sp = qz.quantize_int8_2d_plain(x)
    torch.cuda.synchronize()
    n_diff = int((q != qp).sum())
    s_err = float(((s - sp).abs() / sp).max())
    err = float((q.float() * s - qp.float() * sp).abs().max())
    print(f"  int8 {label}: codes differing {n_diff}, scale rel err {s_err:.2e}, "
          f"dequantized max abs err {err:.3e}  (tolerance: exact codes, scales rtol 1e-6)")
    check(n_diff == 0 and s_err <= 1e-6, f"quantize_int8_2d disagrees at {label}")
    return err


def check_ternary(x: torch.Tensor, label: str) -> float:
    t, s = qz.ternarize_2d(x)
    tp, sp = qz.ternarize_2d_plain(x)
    torch.cuda.synchronize()
    s_err = float(((s - sp).abs() / sp.clamp(min=1e-30)).max())
    ulp = torch.nextafter(sp, torch.full_like(sp, float("inf"))) - sp
    near = (x.abs() - sp).abs() <= 4 * ulp            # |x| within 4 ulp of the row mean
    differ = t != tp
    n_near_flips = int((differ & near).sum())
    n_faults = int((differ & ~near).sum())
    err = float((t.float() * s - tp.float() * sp).abs().max())
    print(f"  ternary {label}: scale rel err {s_err:.2e}, elements within 4 ulp of the "
          f"threshold {int(near.sum())}, of which flipped {n_near_flips}, other "
          f"differences {n_faults}  (tolerance: scales rtol 1e-6, t equal away from the threshold)")
    check(s_err <= 1e-6 and n_faults == 0, f"ternarize_2d disagrees at {label}")
    return err


def phase_quantizers(R_main: int) -> list:
    print("[2a] quantize_int8_2d / ternarize_2d vs plain")
    edge = randn(64, 256, seed=1)
    edge[3] = 0.0                                     # all-zero row: scale 1 / scale 0
    edge[5] *= 1e-30
    edge[7] *= 1e30
    edge[9] = torch.arange(256, device=DEV) * 0.5 - 60.0   # with amax 127 the scale is 1:
    edge[9, 0] = 127.0                                # half-integers are exact rounding ties
    check_int8(edge, "edge R=64")
    check_ternary(edge, "edge R=64")
    for shape in [(999,), (1, 1), (2 * 256 + 17,)]:   # through the 1-D wrappers (padding)
        v = randn(*shape, seed=2)
        q, s, n = ops.quantize_int8(v)
        qp, sp, _ = ops.quantize_int8(v, use_kernel=False)
        t, ts, _ = ops.ternarize(v)
        tp, tsp, _ = ops.ternarize(v, use_kernel=False)
        check(n == v.numel() and q.shape[0] % 64 == 0 and bool((q == qp).all())
              and bool((t == tp).all()), f"ops wrappers disagree at {shape}")
    x = randn(65536, 256, seed=3)
    check_int8(x, "one 64 MiB bucket R=65536")
    check_ternary(x, "one 64 MiB bucket R=65536")
    del x
    x = randn(R_main, 256, seed=4) * 1e-3
    n = x.numel()
    bytes_moved = n * 4 + n * 1 + R_main * 4
    rows = []
    for name, kern, plain, chk in [
            ("quantize_int8_2d", qz.quantize_int8_2d, qz.quantize_int8_2d_plain, check_int8),
            ("ternarize_2d", qz.ternarize_2d, qz.ternarize_2d_plain, check_ternary)]:
        err = chk(x, f"largest stablelm-3b bucket R={R_main}")
        ms = time_ms(lambda: kern(x))
        plain_ms = time_ms(lambda: plain(x), reps=3, warmup=1)
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        print(f"  {name} R={R_main}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms (bytes), {bytes_moved / ms / 1e6:.0f} GB/s")
        rows.append({"name": name, "route": "cuda", "source": CSRC + "quantize.cu",
                     "replaces": ("src/repro/kernels/quantize.py:39" if name == "quantize_int8_2d"
                                  else "src/repro/kernels/quantize.py:84"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
    return rows


def phase_fused_add(n_main: int) -> dict:
    print("[2b] fused_add_2d vs plain (tolerance rtol = atol = 1e-5: f32 sums in row order)")
    for K, n, dtype in [(1, 1000, torch.float32), (3, 1001, torch.bfloat16), (16, 4099, torch.float32),
                        (64, 2048, torch.bfloat16)]:
        x = randn(K, n, seed=5, dtype=dtype)
        torch.testing.assert_close(fa.fused_add_2d(x), fa.fused_add_2d_plain(x), rtol=1e-5, atol=1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        for K in (1, 4, 8):
            n = 16 << 20
            x = randn(K, n, seed=6, dtype=dtype)
            out, ref = fa.fused_add_2d(x), fa.fused_add_2d_plain(x)
            torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
            ms = time_ms(lambda: fa.fused_add_2d(x))
            lib = time_ms(lambda: torch.sum(x, dim=0, dtype=torch.float32))
            nbytes = (K * x.element_size() + 4) * n
            print(f"  K={K} n=16Mi {str(dtype).split('.')[-1]}: err {float((out - ref).abs().max()):.2e}, "
                  f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s), torch.sum {lib:.3f} ms, "
                  f"bound {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
            del x, out, ref
    # the trainer's shape: a world of one rank, the largest dequantized bucket
    x = randn(1, n_main, seed=7)
    out, ref = fa.fused_add_2d(x), fa.fused_add_2d_plain(x)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    err = float((out - ref).abs().max())
    del out, ref
    ms = time_ms(lambda: fa.fused_add_2d(x))
    plain_ms = time_ms(lambda: fa.fused_add_2d_plain(x), reps=3, warmup=1)
    lib = time_ms(lambda: torch.sum(x, dim=0, dtype=torch.float32), reps=3, warmup=1)
    bound_ms = (1 * 4 + 4) * n_main / HBM_BYTES_PER_S * 1e3
    print(f"  K=1 n={n_main} f32 (trainer): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"torch.sum {lib:.3f} ms, bound {bound_ms:.3f} ms (bytes)")
    return {"name": "fused_add_2d", "route": "cuda", "source": CSRC + "fused_add.cu",
            "replaces": "src/repro/kernels/fused_add.py:29", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib}


def flash_case(BH, S, hd, dtype, causal, H, KV, seed):
    q = randn(BH, S, hd, seed=seed, dtype=dtype)
    k = randn(BH // H * KV, S, hd, seed=seed + 1, dtype=dtype)
    v = randn(BH // H * KV, S, hd, seed=seed + 2, dtype=dtype)
    return q, k, v


def phase_flash() -> dict:
    print("[2c] flash attention vs plain (tolerance: f32 rtol = atol = 2e-3; bf16 rtol = atol "
          "= 1e-2, one bf16 rounding of the output)")
    cases = [(4, 256, 64, torch.float32, True, 1, 1), (2, 128, 64, torch.float32, False, 1, 1),
             (1, 512, 32, torch.float32, True, 1, 1), (3, 128, 128, torch.float32, True, 1, 1),
             (8, 256, 80, torch.float32, True, 4, 2), (8, 256, 64, torch.bfloat16, True, 4, 2),
             (4, 1024, 128, torch.bfloat16, True, 2, 2), (4, 512, 80, torch.bfloat16, False, 4, 1),
             (2, 192, 72, torch.float32, True, 2, 1), (8, 4096, 80, torch.float32, True, 8, 8)]
    for i, (BH, S, hd, dtype, causal, H, KV) in enumerate(cases):
        q, k, v = flash_case(BH, S, hd, dtype, causal, H, KV, seed=10 * i)
        out = fl.flash_attention_cuda(q, k, v, causal=causal, n_heads=H, n_kv_heads=KV)
        torch.cuda.synchronize()
        ref = fl.flash_attention_plain(q, k, v, causal=causal, n_heads=H, n_kv_heads=KV)
        tol = 2e-3 if dtype == torch.float32 else 1e-2
        err = float((out.float() - ref.float()).abs().max())
        print(f"  (BH,S,hd)=({BH},{S},{hd}) {str(dtype).split('.')[-1]} causal={causal} "
              f"Hq={H} Hkv={KV}: max abs err {err:.3e}")
        check(bool(torch.isfinite(out).all()), "flash output not finite")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    BH, S, hd, H = 32, 4096, 80, 32                       # stablelm-3b, batch 1, train_4k
    q, k, v = flash_case(BH, S, hd, torch.bfloat16, True, H, H, seed=999)
    out = fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=H)
    ref = fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=H)
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    err = float((out.float() - ref.float()).abs().max())
    del out, ref
    ms = time_ms(lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=H))
    plain_ms = time_ms(lambda: fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=H),
                       reps=3, warmup=1)
    q4, k4, v4 = (t.reshape(1, H, S, hd) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True))
    flops = 4.0 * hd * BH * (S * (S + 1) / 2)             # two products over the causal triangle
    nbytes = 4 * BH * S * hd * 2                          # q, k, v read and o written, bf16
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  (32,4096,80) bf16 causal (trainer): err {err:.3e}, kernel {ms:.3f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms")
    del q, k, v, q4, k4, v4
    flash_jamba()
    return {"name": "flash_attention", "route": "cuda", "source": CSRC + "flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:84", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib}


def flash_jamba() -> None:
    """jamba-v0.1-52b's attention layer at serving: batch 4, prompt 4096,
    Hq 32 / Hkv 8, hd 128, bf16, causal."""
    B, H, KV, S, hd = 4, 32, 8, 4096, 128
    q, k, v = flash_case(B * H, S, hd, torch.bfloat16, True, H, KV, seed=1234)
    out = fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)
    ref = fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)
    check(bool(torch.isfinite(out).all()), "flash output not finite at Jamba's shape")
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    err = float((out.float() - ref.float()).abs().max())
    del out, ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV))
    plain_ms = time_ms(lambda: fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=KV),
                       reps=3, warmup=1)
    q4, k4, v4 = q.reshape(B, H, S, hd), k.reshape(B, KV, S, hd), v.reshape(B, KV, S, hd)
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True))
    flops = 4.0 * hd * B * H * (S * (S + 1) / 2)
    nbytes = 2 * S * hd * (2 * B * H + 2 * B * KV)          # q and o; k and v, bf16
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  (128,4096,128) bf16 causal Hq=32 Hkv=8 (jamba-v0.1-52b serving): err {err:.3e}, "
          f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
          f"({'operations' if t_ops >= t_bytes else 'bytes'})")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def phase_topk(R_main: int) -> dict:
    print("[2d] topk_mask_2d vs plain (tolerance: equal bit for bit)")
    for i, (R, C, dtype) in enumerate([(64, 256, torch.float32), (3, 7, torch.float32),
                                       (1, 1, torch.float32), (5, 3, torch.bfloat16),
                                       (65, 256, torch.bfloat16), (129, 256, torch.bfloat16)]):
        x = randn(R, C, seed=300 + i, dtype=dtype)
        if x.numel() > 1:
            x.view(-1)[1] = float("nan")                  # |NaN| >= thr is false: masked to 0
        amax = float(x.float().nan_to_num(0.0).abs().max())
        for thr in (0.0, 0.5, amax, amax + 1.0):          # keep all, some, the max only, none
            t = torch.tensor(thr, device=DEV)
            out, ref = tm.topk_mask_2d(x, t), tm.topk_mask_2d_plain(x, t)
            torch.cuda.synchronize()
            check(torch.equal(_bits(out), _bits(ref)), f"topk_mask_2d differs at {(R, C)} {dtype} thr={thr}")
            if thr > amax:
                check(not bool(out.float().abs().gt(0).any()), "a threshold above the max kept something")
    for n in (999, 2 * 256 + 17, 100_003):                 # ragged n through the 1-D wrapper
        v = randn(n, seed=n)
        a = ops.topk_sparsify(v, 0.01, sample=1 << 14)
        b = ops.topk_sparsify(v, 0.01, sample=1 << 14, use_kernel=False)
        check(torch.equal(_bits(a), _bits(b)) and a.shape == v.shape, f"topk_sparsify differs at n={n}")
    x = randn(R_main, 256, seed=310) * 1e-3
    n = x.numel()
    thr = ops.topk_threshold(x.view(-1)[::n // (1 << 14)], 0.01)   # as grad sync samples it
    out, ref = tm.topk_mask_2d(x, thr), tm.topk_mask_2d_plain(x, thr)
    torch.cuda.synchronize()
    check(torch.equal(_bits(out), _bits(ref)), "topk_mask_2d differs at the largest bucket")
    kept = int((out != 0).sum())
    del out, ref
    ms = time_ms(lambda: tm.topk_mask_2d(x, thr))
    plain_ms = time_ms(lambda: tm.topk_mask_2d_plain(x, thr), reps=3, warmup=1)
    nbytes = 2 * 4 * n                                    # f32 read once, written once
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  largest stablelm-3b bucket R={R_main} f32: equal, {kept} of {n} kept; kernel {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms (bytes)")
    return {"name": "topk_mask_2d", "route": "cuda", "source": CSRC + "topk_mask.cu",
            "replaces": "src/repro/kernels/topk_mask.py:31", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}


def wkv_inputs(B, H, S, hd, seed, model_decay=False):
    r, k, v = (randn(B, H, S, hd, seed=seed + i) * 0.5 for i in range(3))
    if model_decay:
        # the model's init: per-channel w0 from -6 (slow) to -1 (fast) plus a small data term
        ratio = torch.arange(H * hd, device=DEV, dtype=torch.float32).reshape(H, hd) / (H * hd - 1)
        w0 = -6.0 + 5.0 * ratio ** 0.7
        logw = -torch.exp(w0[None, :, None, :] + 0.1 * randn(B, H, S, hd, seed=seed + 3))
    else:
        logw = -torch.exp(randn(B, H, S, hd, seed=seed + 3) * 0.5 - 2.0)
    u = randn(H, hd, seed=seed + 4) * 0.1
    s0 = randn(B, H, hd, hd, seed=seed + 5) * 0.1
    return r, k, v, logw, u, s0


def wkv_err(got, want) -> float:
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_wkv() -> dict:
    print("[2e] wkv vs its plain chunked form (tolerance rtol = atol = 1e-4: f32 sums in another "
          "order, and the chunked form clips each pairwise decay at exp(-60) where the "
          "recurrence underflows)")
    for B, H, S, hd, chunk in [(2, 8, 64, 16, 16),       # rwkv6-1.6b smoke
                               (2, 8, 37, 16, 16),       # ragged S
                               (1, 4, 192, 64, 64), (2, 3, 100, 128, 32), (1, 2, 50, 8, 16),
                               (4, 32, 1, 64, 128)]:     # one decode step
        args = wkv_inputs(B, H, S, hd, seed=B * 100 + S + hd)
        err = wkv_err(wk.wkv(*args), wk.wkv_plain(*args, chunk=chunk))
        print(f"  (B,H,S,hd)=({B},{H},{S},{hd}): max abs err {err:.2e}")
    # state chain: two half-sequence calls equal one call over the whole
    r, k, v, logw, u, s0 = wkv_inputs(1, 4, 512, 64, seed=7, model_decay=True)
    y, s = wk.wkv(r, k, v, logw, u, s0)
    h = 256
    y1, s1 = wk.wkv(r[:, :, :h], k[:, :, :h], v[:, :, :h], logw[:, :, :h], u, s0)
    y2, s2 = wk.wkv(r[:, :, h:], k[:, :, h:], v[:, :, h:], logw[:, :, h:], u, s1)
    err = wkv_err((torch.cat([y1, y2], dim=2), s2), (y, s))
    print(f"  state chain, 2 x 256 = 512 steps: max abs err {err:.2e}")
    # the model's layout, read through a transpose
    tr = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, logw)]
    err = wkv_err(wk.wkv(*tr, u, s0), (y, s))
    print(f"  (B,S,H,hd) layout through strides: max abs err {err:.2e}")

    B, H, S, hd = 4, 32, 4096, 64                        # rwkv6-1.6b serving: batch 4, prompt 4096
    args = wkv_inputs(B, H, S, hd, seed=11, model_decay=True)
    got, want = wk.wkv(*args), wk.wkv_plain(*args, chunk=128)
    err = wkv_err(got, want)
    del got, want
    ms = time_ms(lambda: wk.wkv(*args))
    plain_ms = time_ms(lambda: wk.wkv_plain(*args, chunk=128), reps=3, warmup=1)
    n = B * H * S * hd
    nbytes = 4 * (5 * n + 2 * B * H * hd * hd + H * hd)  # r, k, v, logw, y; s0, s_out; u
    flops = 4.0 * hd * n                                 # y and the state update, per element
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    print(f"  serving shape (B,H,S,hd)=({B},{H},{S},{hd}) f32: max abs err {err:.2e}, kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.3f} ms "
          f"(bytes {t_bytes:.3f}, f32 operations {t_ops:.3f})")
    return {"name": "wkv", "route": "cuda", "source": CSRC + "wkv.cu",
            "replaces": "src/repro/kernels/wkv.py:78", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def ssm_inputs(B, S, n, di, seed, dtype=torch.float32, model_layout=True):
    """decay, bx, c_t, h0 for ``ss.ssm_scan``, the first two either
    transposed views of the model's (B, S, di, n) tensors or contiguous (B,
    S, n, di); decay = exp(dt * -(1..n)) with the model's dt, so that states
    live up to a thousand steps."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt0 = torch.exp(torch.rand(di, generator=g, device=DEV) * math.log(100.0) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))            # the model's dt_bias
    dt = F.softplus(torch.randn(B, S, di, generator=g, device=DEV) * 0.5 + bias)
    shape = (B, S, di, n) if model_layout else (B, S, n, di)
    dt_b = dt[..., None] if model_layout else dt[:, :, None, :]
    a = -torch.arange(1, n + 1, device=DEV, dtype=torch.float32)
    a = a if model_layout else a[:, None]
    decay = torch.empty(shape, device=DEV)
    torch.mul(dt_b, a, out=decay).exp_()
    bx = torch.randn(shape, generator=g, device=DEV).mul_(dt_b).mul_(0.5)
    c_t = torch.randn(B, S, n, generator=g, device=DEV)
    h0 = torch.randn(B, di, n, generator=g, device=DEV) * 0.1
    decay, bx, c_t = (t.to(dtype) for t in (decay, bx, c_t))
    if model_layout:
        return decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2)
    return decay, bx, c_t, h0.transpose(1, 2).contiguous()


def ssm_err(got, want) -> float:
    for a, b in zip(got, want):
        check(a.dtype == torch.float32 and a.shape == b.shape, "ssm_scan output dtype or shape")
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_ssm_scan(main_shape=(4, 4096, 16, 8192)) -> dict:
    print("[2f] ssm_scan vs its plain recurrence (tolerance rtol = atol = 1e-4, the reference's: "
          "f32 state, fused multiply-adds and a shuffle sum against separate roundings)")
    for i, (B, S, n, di) in enumerate([(4, 1, 16, 8192),     # one decode step
                                       (2, 100, 16, 200),    # S and d_inner not multiples of 128
                                       (1, 300, 16, 96), (3, 64, 8, 130), (2, 50, 12, 64),
                                       (2, 40, 5, 33)]):
        for layout in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                args = ssm_inputs(B, S, n, di, seed=40 + i, dtype=dtype, model_layout=layout)
                err = ssm_err(ss.ssm_scan(*args), ss.ssm_scan_plain(*args))
                print(f"  (B,S,n,d_inner)=({B},{S},{n},{di}) {str(dtype).split('.')[-1]} "
                      f"{'model layout (strided)' if layout else 'contiguous'}: max abs err {err:.2e}")
    # state chain: two calls that carry h equal one call over both halves
    decay, bx, c_t, h0 = ssm_inputs(2, 512, 16, 1024, seed=50)
    y, h = ss.ssm_scan(decay, bx, c_t, h0)
    y1, h1 = ss.ssm_scan(decay[:, :256], bx[:, :256], c_t[:, :256], h0)
    y2, h2 = ss.ssm_scan(decay[:, 256:], bx[:, 256:], c_t[:, 256:], h1)
    err = ssm_err((torch.cat([y1, y2], dim=1), h2), (y, h))
    print(f"  state chain, 2 x 256 = 512 steps: max abs err {err:.2e}")
    del decay, bx, c_t, h0

    B, S, n, di = main_shape                                # jamba-v0.1-52b serving
    args = ssm_inputs(B, S, n, di, seed=51)
    got, want = ss.ssm_scan(*args), ss.ssm_scan_plain(*args)
    err = ssm_err(got, want)
    y_max = float(want[0].abs().max())
    del got, want
    ms = time_ms(lambda: ss.ssm_scan(*args))
    plain_ms = time_ms(lambda: ss.ssm_scan_plain(*args), reps=3, warmup=1)
    n_state = B * S * n * di
    nbytes = 4 * (2 * n_state + B * S * di + B * S * n + 2 * B * n * di)   # decay, bx; y; c; h0, h
    flops = 4.0 * n_state                                   # two FMAs per state element and step
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    print(f"  serving shape (B,S,n,d_inner)=({B},{S},{n},{di}) f32, model layout: max abs err "
          f"{err:.2e} (|y| up to {y_max:.2f}), kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s), "
          f"plain {plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.3f} ms (bytes {t_bytes:.3f}, "
          f"f32 operations {t_ops:.3f}); library: none (no single PyTorch call)")
    return {"name": "ssm_scan", "route": "cuda", "source": CSRC + "ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:65", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def phase_mamba_mixer(S: int = 4096) -> None:
    """One Mamba layer of jamba-v0.1-52b at full width in float32: the
    kernel path against the plain ``assoc`` scan, forward and gradients."""
    B = 1
    cfg = get_config("jamba-v0.1-52b").replace(dtype="float32")
    print(f"[6] Mamba mixer, jamba-v0.1-52b full width (d_model {cfg.d_model}, d_inner "
          f"{mb.dims(cfg)[0]}, d_state {cfg.ssm.d_state}), float32, batch {B}, prompt {S}: kernel vs "
          f"use_pallas=never (tolerance: output 1e-4, gradients 1e-3 relative L2; f32, order of sums)")
    torch.cuda.empty_cache()
    params = mb.init_mamba(torch.Generator(device=DEV).manual_seed(0), cfg)
    x = randn(B, S, cfg.d_model, seed=60)
    cot = randn(B, S, cfg.d_model, seed=61)
    results = {}
    for mode in ("auto", "never"):
        build.reset_launch_counts()
        xg = x.clone().requires_grad_(True)
        w_in = params["w_in"].detach().clone().requires_grad_(True)
        out, state = mb.mamba_mixer({**params, "w_in": w_in}, xg, cfg.replace(use_pallas=mode))
        gx, gw = torch.autograd.grad(torch.sum(out * cot), (xg, w_in))
        torch.cuda.synchronize()
        results[mode] = (out.detach(), state["ssm"].detach(), gx, gw, build.launch_counts["ssm_scan"])
        del out, state, xg, w_in
        torch.cuda.empty_cache()
    check(results["auto"][4] == 1 and results["never"][4] == 0,
          "expected one ssm_scan launch on the kernel path, none on the plain one")
    names = ["output", "final state", "d loss / d x", "d loss / d w_in"]
    tols = [1e-4, 1e-4, 1e-3, 1e-3]
    for i, (name, tol) in enumerate(zip(names, tols)):
        a, b = results["auto"][i], results["never"][i]
        check(bool(torch.isfinite(a).all()), f"mixer {name} not finite")
        rel = rel_l2(a, b)
        print(f"  {name}: rel L2 {rel:.3e} (tolerance {tol:.0e})")
        check(rel <= tol, f"Mamba mixer {name}: kernel and plain disagree")
    del params, results
    torch.cuda.empty_cache()


def phase_dequantize(R_main: int) -> dict:
    print("[2g] dequantize_int8_2d vs plain (tolerance: equal bit for bit, one rounded product)")
    g = torch.Generator(device=DEV).manual_seed(400)
    for R in (64, 1):                                     # a tile of rows; one row of a tile
        q = torch.randint(-128, 128, (R, 256), generator=g, device=DEV, dtype=torch.int8)
        s = torch.rand(R, 1, generator=g, device=DEV) * 3.0
        if R == 64:
            s[3], s[5], s[7], s[9] = 0.0, 1e-30, 1e30, -1.5   # zero, tiny, huge, negative scales
            q[11] = 127
            q[12] = -128
        out, ref = qz.dequantize_int8_2d(q, s), qz.dequantize_int8_2d_plain(q, s)
        check(torch.equal(_bits(out), _bits(ref)), f"dequantize_int8_2d differs at R={R} (int8 codes)")
        t, ts = qz.ternarize_2d(randn(R, 256, seed=401 + R))
        out, ref = qz.dequantize_int8_2d(t, ts), qz.dequantize_int8_2d_plain(t, ts)
        check(torch.equal(_bits(out), _bits(ref)), f"dequantize_int8_2d differs at R={R} (ternary codes)")
    for n in (999, 2 * 256 + 17):                         # ragged n through the 1-D wrappers
        v = randn(n, seed=410 + n)
        q, s, _ = ops.quantize_int8(v)
        t, ts, _ = ops.ternarize(v)
        for a, b in ((ops.dequantize_int8(q, s, n), ops.dequantize_int8(q, s, n, use_kernel=False)),
                     (ops.deternarize(t, ts, n), ops.deternarize(t, ts, n, use_kernel=False))):
            check(a.shape == (n,) and torch.equal(_bits(a), _bits(b)), f"ops decode differs at n={n}")
    bad = torch.zeros(4 * 256 + 4, dtype=torch.int8, device=DEV)[4:].view(4, 256)
    try:
        qz.dequantize_int8_2d(bad, torch.ones(4, 1, device=DEV))
    except ValueError:
        pass
    else:
        check(False, "dequantize_int8_2d took codes off a 16-byte boundary")
    x = randn(R_main, 256, seed=4) * 1e-3
    q, s = qz.quantize_int8_2d(x)
    t, ts = qz.ternarize_2d(x)
    del x
    for label, codes, scales in (("int8", q, s), ("ternary", t, ts)):
        out, ref = qz.dequantize_int8_2d(codes, scales), qz.dequantize_int8_2d_plain(codes, scales)
        torch.cuda.synchronize()
        check(torch.equal(_bits(out), _bits(ref)),
              f"dequantize_int8_2d differs at the largest bucket ({label} codes)")
        del out, ref
    del t, ts
    ms = time_ms(lambda: qz.dequantize_int8_2d(q, s))
    plain_ms = time_ms(lambda: qz.dequantize_int8_2d_plain(q, s), reps=3, warmup=1)
    lib = time_ms(lambda: torch.mul(q, s))                # int8 * f32 promotes to f32: one call
    nbytes = R_main * (256 + 4 + 256 * 4)                 # codes and scale read, f32 written
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  edge R=64 and R=1 (int8 codes -128..127, scales 0, 1e-30, 1e30, -1.5; ternary codes), "
          f"ragged n 999 and 529 through ops.dequantize_int8 / deternarize: equal")
    print(f"  largest stablelm-3b bucket R={R_main}: equal for int8 and ternary codes; kernel {ms:.3f} ms "
          f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, torch.mul(q, s) {lib:.3f} ms, "
          f"bound {bound_ms:.3f} ms (bytes)")
    return {"name": "dequantize_int8_2d", "route": "cuda", "source": CSRC + "quantize.cu",
            "replaces": "src/repro/kernels/quantize.py:58", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib}


def phase_probe(R_main: int) -> dict:
    print("[2h] probe_copy_2d vs plain (tolerance: equal bit for bit)")
    for R in (64, 1):
        x = randn(R, 256, seed=420 + R)
        x.view(-1)[1] = float("nan")
        x.view(-1)[2] = -0.0
        check(torch.equal(_bits(pb.probe_copy_2d(x)), _bits(pb.probe_copy_2d_plain(x))),
              f"probe_copy_2d differs at R={R}")
    bad = torch.zeros(4 * 256 + 1, device=DEV)[1:].view(4, 256)
    try:
        pb.probe_copy_2d(bad)
    except ValueError:
        pass
    else:
        check(False, "probe_copy_2d took rows off a 16-byte boundary")
    x = randn(R_main, 256, seed=430)
    out, ref = pb.probe_copy_2d(x), pb.probe_copy_2d_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(_bits(out), _bits(ref)), "probe_copy_2d differs at the largest bucket")
    del out, ref
    ms = time_ms(lambda: pb.probe_copy_2d(x))
    plain_ms = time_ms(lambda: pb.probe_copy_2d_plain(x), reps=3, warmup=1)
    lib = time_ms(lambda: x.clone())
    nbytes = R_main * 256 * 4 * 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  edge R=64 and R=1 (with NaN and -0.0): equal; largest stablelm-3b bucket R={R_main}: equal, "
          f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, x.clone() "
          f"{lib:.3f} ms, bound {bound_ms:.3f} ms (bytes)")
    return {"name": "probe_copy_2d", "route": "cuda", "source": CSRC + "probe_copy.cu",
            "replaces": "benchmarks/kernel_bench.py:107", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib}


# ---------------------------------------------------------------------------
# phases 14-16: the codec calibration and the measurement seams of core/
# ---------------------------------------------------------------------------

H100_TABLE = REPO / "artifacts" / "bench" / "BENCH_codec_h100.json"


def phase_calibration(elements: int) -> dict:
    """The calibration bench through its entry point, at the bandwidth-bound
    size against the committed table, then at the reference's 1 MiB."""
    from benchmarks import torch_kernel_bench as kb

    print(f"[14] codec calibration: benchmarks/torch_kernel_bench.py --calibrate --elements {elements} "
          f"--check {H100_TABLE.relative_to(REPO)}")
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        build.reset_launch_counts()
        rc = kb.main(["--calibrate", "--elements", str(elements), "--out", f"{tmp}/big.json",
                      "--check", str(H100_TABLE)])
        counts = dict(build.launch_counts)
        print(f"  launches {counts}")
        check(rc == 0, f"the calibration at {elements} elements failed its gate (exit {rc})")
        for name in ("probe_copy_2d", "dequantize_int8_2d", "quantize_int8_2d", "ternarize_2d",
                     "topk_mask_2d"):
            check(counts[name] > 0, f"the calibration did not launch {name}")
        big = json.loads(Path(f"{tmp}/big.json").read_text())
        check(not big["interpret"] and big["n_bytes"] == elements * 4, "calibration table header")
        gc.collect()
        torch.cuda.empty_cache()
        print("  the same at the reference's 1 << 18 elements (1 MiB, L2-resident)")
        check(kb.main(["--calibrate", "--out", f"{tmp}/small.json"]) == 0, "calibration at 1 MiB")
    print(f"  copy probe at {kb.LAUNCH_PROBE_ROWS} rows {big['launch_probe_us']:.3f} us against "
          f"H100_LAUNCH_OVERHEAD {H100_LAUNCH_OVERHEAD * 1e6:.3f} us")
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_addest() -> None:
    print("[15] AddEst.measure on the card (CUDA events, L2 flushed before each add), against "
          "AddEst.h100()")
    est, model = AddEst.measure(device="cuda"), AddEst.h100()
    for x, t in zip(est.sizes, est.times):
        rate = 3 * x / t
        print(f"  {int(x):>10d} B: {t * 1e6:9.3f} us ({rate / 1e9:7.1f} GB/s); model {model(x) * 1e6:9.3f} us")
        check(0 < rate <= HBM_BYTES_PER_S * 1.05,
              f"AddEst.measure read {rate / 1e9:.0f} GB/s at {int(x)} B: above the card's peak")


def phase_timeline(trained: dict) -> None:
    cfg = get_config("stablelm-3b")
    print(f"[16] timeline.measure: stablelm-3b full width and depth ({cfg.num_layers} layers), S = 4096, "
          f"batch 1, repeats 2")
    gc.collect()
    torch.cuda.empty_cache()
    api = get_model(cfg)
    shape = InputShape("train_4k", INPUT_SHAPES["train_4k"].seq_len, 1, "train")
    batch = device_put_batch(SyntheticLM(cfg, shape, seed=0).batch(0), DEV)
    build.reset_launch_counts()
    tl = timeline.measure(api, cfg, batch, repeats=2)
    counts = dict(build.launch_counts)
    ready = tl.ready_times
    print(f"  t_batch {tl.t_batch:.3f} s (the int8 trainer's median step, fwd+bwd+sync+AdamW: "
          f"{trained['result']['median_step_s']:.3f} s); t_back {tl.t_back:.3f} s; {len(ready)} "
          f"groups, {tl.total_bytes / 2 ** 30:.2f} GiB of f32 gradients; ready at "
          f"{', '.join(f'{r:.4f}' for r in ready)} s; launches {counts}")
    check(math.isfinite(tl.t_batch) and tl.t_batch > 0, "t_batch not a positive time")
    check(all(a < b for a, b in zip(ready, ready[1:])), "ready times do not ascend")
    check(counts["flash_attention"] > 0, "timeline.measure did not run the flash kernel")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: K = 4 gradient sync
# ---------------------------------------------------------------------------

def phase_grad_sync() -> None:
    print("[3] sync_grads, in-process world of K = 4, two 64 MiB buckets, vs float64 mean")
    K, n = 4, 16 << 20
    grads = [{"a": randn(n, seed=100 + r), "b": randn(n, seed=200 + r)} for r in range(K)]
    tol = {"none": 1e-6, "fp16": 2e-2, "int8": 2e-2, "ternary": 1.5}
    for compression, hier in [("none", False), ("none", True), ("fp16", False),
                              ("int8", False), ("ternary", False)]:
        if compression == "ternary":
            # a ternary code errs by up to max(|x| - mean|x|, mean|x|): unbounded in the
            # largest magnitude.  The bound 1.5 was set for a few hundred standard-normal
            # values; at 32 Mi values a rank the inputs are cut to [-1, 1], where the
            # error of every rank, and so of the mean, cannot exceed 1
            grads = [{key: g[key].clamp(-1.0, 1.0) for key in g} for g in grads]
        expect = {key: sum(g[key].double() for g in grads) / K for key in ("a", "b")}
        comm = CommConfig(compression=compression, hierarchical=hier, mode="explicit")
        world = InProcessWorld(K, node_size=2 if hier else None)
        plan, _ = make_plan(grads[0], comm.fusion_buffer_mb)
        check(plan.n_buckets == 2, f"expected 2 buckets, got {plan.n_buckets}")
        build.reset_launch_counts()
        out = sync_grads_per_rank(grads, world, comm)
        torch.cuda.synchronize()
        err = max(float((out[r][key].double() - expect[key]).abs().max())
                  for r in range(K) for key in ("a", "b"))
        print(f"  {compression}/{'hier' if hier else 'flat'}: max abs err {err:.3e} "
              f"(tolerance {tol[compression]}), launches {dict(build.launch_counts)}")
        check(err <= tol[compression], f"grad sync {compression} out of tolerance")
        del out


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer through its entry point
# ---------------------------------------------------------------------------

def trainer_args(compression: str, steps: int, layers: int, extra=()) -> list:
    return ["--arch", "stablelm-3b", "--shape", "train_4k", "--batch", "1",
            "--steps", str(steps), "--comm-mode", "explicit", "--compression", compression,
            "--log-every", "1", "--layers", str(layers), *extra]


def run_trainer(argv: list) -> tuple:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    result = train.main(argv)
    counts = dict(build.launch_counts)
    torch.cuda.synchronize()
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return result, counts


def phase_trainer(layers: int) -> dict:
    steps = 5
    print(f"[4] trainer: stablelm-3b full width (d_model 2560, 32 heads of 80, d_ff 6912, "
          f"vocab 50432, bf16, remat), {layers} of 32 layers, S = 4096, batch 1, explicit "
          f"comm, int8, AdamW, {steps} steps")
    result, counts = run_trainer(trainer_args("int8", steps, layers))
    losses = result["losses"]
    print(f"  losses {losses}; median step {result['median_step_s']:.3f} s, "
          f"{result['tokens_per_s']:.0f} tokens/s, first step {result['compile_s']:.3f} s, "
          f"peak memory {result['peak_gib']:.1f} GiB; launches {counts}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(10.0 <= losses[0] <= 11.6, f"step-0 loss {losses[0]} outside [10.0, 11.6] (ln 50304 = 10.83)")
    check(counts["flash_attention"] >= layers * steps, "flash kernel was not on the path")
    check(counts["quantize_int8_2d"] > 0 and counts["fused_add_2d"] > 0,
          "the codec kernels were not on the path")
    cfg_run = get_config("stablelm-3b").replace(num_layers=layers)
    plan, _ = make_plan(get_model(cfg_run).init(None, device="meta"), 64.0)
    check(counts["quantize_int8_2d"] == plan.n_buckets * steps,
          f"expected one encode per bucket and step ({plan.n_buckets} x {steps})")
    check(counts["dequantize_int8_2d"] == counts["quantize_int8_2d"],
          "expected one decode per encode (the grad sync's dequantize kernel)")

    print("  the same seed on the plain versions (use_pallas=never: plain attention, plain codec), 2 steps")
    ref, ref_counts = run_trainer(trainer_args("int8", 2, layers, ["--use-pallas", "never"]))
    check(all(c == 0 for c in ref_counts.values()), "the plain run launched a kernel")
    for i in range(2):
        rel = abs(losses[i] - ref["losses"][i]) / abs(ref["losses"][i])
        print(f"  step {i}: kernels {losses[i]:.5f} vs plain {ref['losses'][i]:.5f} (rel diff {rel:.2e}, "
              f"tolerance 2e-2: bf16 model)")
        check(rel <= 2e-2, "kernel and plain trainer disagree")
    print(f"  plain run: median step {ref['median_step_s']:.3f} s")
    return {"result": result, "counts": counts, "buckets": plan.n_buckets}


def phase_ternary(layers: int) -> dict:
    print(f"[5] trainer, --compression ternary, {layers} layers, 2 steps")
    result, counts = run_trainer(trainer_args("ternary", 2, layers))
    print(f"  losses {result['losses']}; launches {counts}")
    check(all(math.isfinite(x) for x in result["losses"]), "a loss is not finite")
    check(counts["ternarize_2d"] > 0 and counts["fused_add_2d"] > 0
          and counts["flash_attention"] >= layers * 2, "ternary path missed a kernel")
    check(counts["dequantize_int8_2d"] == counts["ternarize_2d"],
          "expected one decode (the dequantize kernel) per ternary encode")
    return counts


def phase_topk_trainer(layers: int) -> dict:
    print(f"[9] trainer, --compression topk (ratio 0.01), stablelm-3b, {layers} layers, S = 4096, "
          f"batch 1, 2 steps")
    result, counts = run_trainer(trainer_args("topk", 2, layers))
    cfg_run = get_config("stablelm-3b").replace(num_layers=layers)
    plan, _ = make_plan(get_model(cfg_run).init(None, device="meta"), 64.0)
    print(f"  losses {result['losses']}; median step {result['median_step_s']:.3f} s; "
          f"{plan.n_buckets} buckets; launches {counts}")
    check(all(math.isfinite(x) for x in result["losses"]), "a loss is not finite")
    check(counts["topk_mask_2d"] == counts["fused_add_2d"] == plan.n_buckets * 2,
          f"expected one top-k mask and one fused add per bucket and step ({plan.n_buckets} x 2)")
    return counts


def phase_rwkv_trainer(layers: int) -> dict:
    steps = 2
    print(f"[10] trainer, rwkv6-1.6b full width, {layers} of 24 layers, S = 4096, batch 1, explicit "
          f"comm, int8, {steps} steps (WKV backward: recompute through the chunked form)")
    result, counts = run_trainer(["--arch", "rwkv6-1.6b", "--shape", "train_4k", "--batch", "1",
                                  "--steps", str(steps), "--comm-mode", "explicit",
                                  "--compression", "int8", "--log-every", "1",
                                  "--layers", str(layers)])
    losses = result["losses"]
    print(f"  losses {losses}; median step {result['median_step_s']:.3f} s, peak memory "
          f"{result['peak_gib']:.1f} GiB; launches {counts}")
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(abs(losses[0] - math.log(65536)) <= 0.5, f"step-0 loss {losses[0]} not near ln 65536 = 11.09")
    # forward and the remat recompute of every layer, every step
    check(counts["wkv"] == layers * steps * 2, f"expected {layers * steps * 2} wkv launches")
    return counts


# ---------------------------------------------------------------------------
# phases 7 and 8: serving through its entry point
# ---------------------------------------------------------------------------

def run_serve(argv: list) -> tuple:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    build.reset_launch_counts()
    result = serve.main(argv)
    counts = dict(build.launch_counts)
    torch.cuda.synchronize()
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  device memory held before the run {held:.2f} GiB, after it "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    return result, counts


def prefill_logits(arch: str, B: int, P: int, layers: int = 0, **overrides) -> torch.Tensor:
    """The next-token logits of ``serve.run``'s prefill (its seed-0
    parameters and prompts, at the depth ``--layers`` gave it), through the
    model API with config overrides."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    cfg = cfg.replace(**overrides)
    api = get_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    base = INPUT_SHAPES["prefill_32k"].smoke()
    shape = InputShape(base.name, max(P, base.seq_len), base.global_batch, base.kind)
    prompt = SyntheticLM(cfg, shape, seed=0).batch(0, batch_size=B)["tokens"][:, :P]
    with torch.inference_mode():
        logits, _ = api.prefill(params, {"tokens": torch.from_numpy(prompt).to(DEV)})
    return logits[:, -1].float().cpu()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


SERVE_B, SERVE_P, SERVE_G = 4, 4096, 32


def phase_serve(tag: str, arch: str, expect: dict, other_orders: list, layers: int = 0) -> dict:
    """Serve ``arch`` through ``serve.main`` (``layers`` cuts the depth);
    ``expect`` holds the launches of each kernel of the path, every other
    kernel must stay at 0; ``other_orders`` are config overrides that give
    the plain path another summation order.  Returns the launch counts."""
    B, P, G = SERVE_B, SERVE_P, SERVE_G
    cfg = get_config(arch)
    depth = (f"full depth ({cfg.num_layers} layers)" if not layers
             else f"{layers} of {cfg.num_layers} layers")
    print(f"[{tag}] serving {arch} at full width (d_model {cfg.d_model}, bf16), {depth}: batch {B}, "
          f"prompt {P}, {G} generated tokens")
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P)]
    if layers:
        argv += ["--layers", str(layers)]
    res, counts = run_serve(argv + ["--gen", str(G)])
    print(f"  prefill {res['prefill_s']:.3f} s, decode {res['decode_ms_per_token']:.2f} ms/token, "
          f"{res['decode_tok_per_s']:.1f} tokens/s, peak memory {res['peak_gib']:.1f} GiB; "
          f"launches {counts}")
    for kernel, n in expect.items():
        check(counts[kernel] == n, f"expected {n} {kernel} launches, got {counts[kernel]}")
    check(all(c == 0 for name, c in counts.items() if name not in expect),
          "serving launched a kernel off its path (a codec kernel)")
    check(res["tokens"].shape == (B, G + 1), "wrong number of generated tokens")
    logits = torch.from_numpy(res["prefill_logits"])
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")

    print("  the same seed on the plain versions (--use-pallas never), 2 generated tokens")
    ref, ref_counts = run_serve(argv + ["--gen", "2", "--use-pallas", "never"])
    check(all(c == 0 for c in ref_counts.values()), "the plain run launched a kernel")
    want = torch.from_numpy(ref["prefill_logits"])
    print(f"  plain run: prefill {ref['prefill_s']:.3f} s, decode {ref['decode_ms_per_token']:.2f} "
          f"ms/token, peak {ref['peak_gib']:.1f} GiB")
    # A bf16 model amplifies f32 rounding noise with depth and sequence (and
    # an MoE router turns it into other expert choices), so the yardstick is
    # the plain path's own spread: the same plain path with other summation
    # orders (other chunk sizes), same parameters and prompts, the largest
    # distance of them.  The kernel run may not stray further than twice that.
    same = prefill_logits(arch, B, P, layers, use_pallas="never")
    check(torch.equal(same, want), "the model-API prefill does not reproduce serve.run's")
    spreads = []
    for order in other_orders:
        spreads.append(rel_l2(prefill_logits(arch, B, P, layers, use_pallas="never", **order), want))
        print(f"  plain vs plain with {order}: rel L2 {spreads[-1]:.3e}")
    rel = rel_l2(logits, want)
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"  prefill logits, kernels vs plain: rel L2 {rel:.3e}, max abs "
          f"{float((logits - want).abs().max()):.3e}, argmax agrees on {agree:.2f} of the batch "
          f"(tolerance: within 2x the plain spread, {max(spreads):.3e})")
    check(rel <= 2 * max(spreads),
          f"{arch}: kernel and plain prefill logits disagree beyond the plain spread")
    return counts


def check_float32(arch: str, B: int, layers: int = 0) -> None:
    """In float32 the spread is gone: the kernel path against the plain one,
    prompt 4096."""
    f32_k = prefill_logits(arch, B, 4096, layers, dtype="float32")
    f32_p = prefill_logits(arch, B, 4096, layers, dtype="float32", use_pallas="never")
    rel = rel_l2(f32_k, f32_p)
    print(f"  float32 model, batch {B}, prompt 4096: prefill logits kernels vs plain rel L2 {rel:.3e} "
          f"(tolerance 1e-3: f32, summation order only)")
    check(rel <= 1e-3, f"{arch} float32: kernel and plain prefill logits disagree")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32, help="depth of the int8 trainer run")
    ap.add_argument("--ternary-layers", type=int, default=8,
                    help="depth of the ternary, topk and rwkv6 trainer runs")
    args = ap.parse_args()
    t_start = time.time()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {card} | python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.time()
    build.library(verbose=False)
    print(f"[1] kernels built with nvcc for sm_90a from {CSRC} ({', '.join(build.SOURCES)}) in "
          f"{time.time() - t0:.1f} s (set-up)")

    cfg = get_config("stablelm-3b")
    R_main = cfg.num_layers * cfg.d_model * cfg.d_ff // 256      # blocks.mlp.wi, the largest bucket
    check(cfg.num_layers * cfg.d_model * cfg.d_ff % (256 * 64) == 0, "largest bucket is not tile-aligned")
    rows = phase_quantizers(R_main)
    rows.append(phase_fused_add(R_main * 256))
    rows.append(phase_flash())
    rows.append(phase_topk(R_main))
    rows.append(phase_wkv())
    torch.cuda.empty_cache()
    rows.append(phase_ssm_scan())
    torch.cuda.empty_cache()
    rows.append(phase_dequantize(R_main))
    torch.cuda.empty_cache()
    rows.append(phase_probe(R_main))
    calib_counts = phase_calibration(R_main * 256)
    phase_addest()
    phase_grad_sync()
    trained = phase_trainer(args.layers)
    phase_timeline(trained)
    ternary_counts = phase_ternary(args.ternary_layers)
    phase_serve("7", "stablelm-3b", {"flash_attention": get_config("stablelm-3b").num_layers},
                [{"attn_chunk": 512}])
    rwkv_cfg = get_config("rwkv6-1.6b")
    rwkv_counts = phase_serve("8", "rwkv6-1.6b", {"wkv": rwkv_cfg.num_layers * (1 + SERVE_G)},
                              [{"ssm": dataclasses.replace(rwkv_cfg.ssm, chunk_size=64)}])
    check_float32("rwkv6-1.6b", 2)
    topk_counts = phase_topk_trainer(args.ternary_layers)
    phase_rwkv_trainer(args.ternary_layers)
    phase_mamba_mixer()
    # jamba-v0.1-52b: one super-block at full width (26.6 GB of bf16 weights;
    # two are 53 GB before any activation, the 32-layer model's 104 GB do not
    # fit one card).  Per super-block 7 Mamba layers (one scan per prefill and
    # per decode step) and 1 attention layer (flash in the prefill only)
    jamba_cfg = get_config("jamba-v0.1-52b")
    n_mamba = sum(mixer == "mamba" for mixer, _ in jamba_layout(jamba_cfg))
    jamba_orders = [{"attn_chunk": 512, "ssm": dataclasses.replace(jamba_cfg.ssm, chunk_size=64)},
                    {"ssm": dataclasses.replace(jamba_cfg.ssm, chunk_size=256)}]
    jamba_counts = phase_serve("12", "jamba-v0.1-52b",
                               {"ssm_scan": n_mamba * (1 + SERVE_G),
                                "flash_attention": jamba_cfg.hybrid_block_layers - n_mamba},
                               jamba_orders, layers=jamba_cfg.hybrid_block_layers)
    # 53 GB of float32 weights: batch 1 keeps the plain path under 60 GiB
    check_float32("jamba-v0.1-52b", 1, layers=jamba_cfg.hybrid_block_layers)

    # each kernel's launches on the path that runs it: ternarize on the
    # ternary trainer run, topk_mask on the topk run, wkv on rwkv6 serving,
    # ssm_scan on jamba serving, the copy probe on the calibration, the
    # others (dequantize among them) on the int8 trainer run
    paths = {"ternarize_2d": ternary_counts, "topk_mask_2d": topk_counts,
             "wkv": rwkv_counts, "ssm_scan": jamba_counts, "probe_copy_2d": calib_counts}
    for row in rows:
        row["launches"] = paths.get(row["name"], trained["counts"])[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was never launched on its path")
    check(len(rows) == 9, f"expected a row for each of the nine TPU kernels, got {len(rows)}")
    print(f"[17] total {time.time() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
