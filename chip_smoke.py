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
  rwkv6-1.6b (int8), 8 layers each;
- the paper's own workloads, VGG-16, ResNet-50 and ResNet-101 at full width
  (batch 32, 224x224, 1,000 classes, float32): the measured fwd+bwd
  ``t_batch`` with TF32 off (the V100 constants the simulator uses are
  float32) and a TF32 reading, through ``examples/torch_measured_whatif.main``,
  which also prices each model on 64 workers at 10 / 25 / 100 Gbps
  (``timeline.from_cnn`` + ``core.simulator.simulate``) beside the V100's
  ``t_batch``; two momentum-SGD steps of each model through
  ``launch.train.make_train_step`` with int8 gradient sync (and ternary and
  topk for ResNet-50), held against the plain codec under cuDNN's
  deterministic algorithms;
- the experiment engine as a user runs it: ``python -m
  repro_torch.experiments run`` on each of the eight golden suites and
  ``compare`` against ``artifacts/golden/``, a process each; then
  ``core.whatif.h100_whatif`` prices the stablelm-3b fwd+bwd measured above
  on 8, 64 and 256 H100s, at an assumed MFU of 0.4 and at the MFU the
  measurement reaches, with the add model of the data sheet and the one
  ``AddEst.measure`` took on the card.

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

from examples import torch_measured_whatif as whatif  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, CommConfig, InputShape, get_config  # noqa: E402
from repro_torch.core import flops, timeline  # noqa: E402
from repro_torch.core.addest import H100_LAUNCH_OVERHEAD, AddEst  # noqa: E402
from repro_torch.core.whatif import h100_whatif  # noqa: E402
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
from repro_torch.models.cnn import CNN_NAMES, CNNConfig, cnn_api  # noqa: E402
from repro_torch.models.jamba import block_layout as jamba_layout  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.parallel.collectives import InProcessWorld  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedule import get_schedule  # noqa: E402
from repro_torch.parallel.grad_sync import make_plan, sync_grads, sync_grads_per_rank  # noqa: E402
from repro_torch.utils.tree import value_and_grad  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = timeline.H100_BF16_FLOPS   # dense tensor-core rate, bf16
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


def flash_case(BH, S, hd, dtype, causal, H, KV, seed, Skv=None, q_scale=1.0):
    q = randn(BH, S, hd, seed=seed) * q_scale
    k = randn(BH // H * KV, Skv or S, hd, seed=seed + 1, dtype=dtype)
    v = randn(BH // H * KV, Skv or S, hd, seed=seed + 2, dtype=dtype)
    return q.to(dtype), k, v


def time_device_ms(fn, reps: int = 10) -> float:
    """Median device time of one call, by CUDA events, each sample queued
    behind a stream spin of about 1 ms so that the events do not time the
    host's launch (10-20 us, 5 % of a 0.3 ms kernel)."""
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


def flash_padded(q, k, v, H, KV) -> torch.Tensor:
    """The bf16 kernel with its second product at N = 128 on the zero-padded
    rows (``repro_flash_attn_bf16_nv``), for comparing hd 80's tile choices."""
    out = torch.empty_like(q)
    BH, Sq, hd = q.shape
    lib = build.library()
    build.check(lib.repro_flash_attn_bf16_nv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq, k.shape[1], hd, H, KV,
        1, 1.0 / math.sqrt(hd), 128, build.current_stream(q.device)), "repro_flash_attn_bf16_nv")
    return out


def flash_shape(label: str, B: int, H: int, KV: int, S: int, hd: int, seed: int) -> dict:
    """The bf16 kernel at a main path's causal shape: held against the plain
    version, timed beside it, beside scaled_dot_product_attention and
    beside its bound."""
    q, k, v = flash_case(B * H, S, hd, torch.bfloat16, True, H, KV, seed=seed)
    out = fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)
    ref = fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)
    check(bool(torch.isfinite(out).all()), f"flash output not finite at {label}")
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-2, atol=1e-2)
    err = float((out.float() - ref.float()).abs().max())
    del out, ref
    torch.cuda.empty_cache()
    ms = time_device_ms(lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV))
    plain_ms = time_ms(lambda: fl.flash_attention_plain(q, k, v, causal=True, n_heads=H, n_kv_heads=KV),
                       reps=3, warmup=1)
    q4, k4, v4 = q.reshape(B, H, S, hd), k.reshape(B, KV, S, hd), v.reshape(B, KV, S, hd)
    lib = time_device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                                enable_gqa=KV != H))
    flops = 4.0 * hd * B * H * (S * (S + 1) / 2)          # two products over the causal triangle
    nbytes = 2 * S * hd * (2 * B * H + 2 * B * KV)        # q and o; k and v, bf16
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  ({B * H},{S},{hd}) bf16 causal Hq={H} Hkv={KV} ({label}): err {err:.3e}, kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {lib:.4f} ms ({ms / lib:.2f}x), bound "
          f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})")
    if hd == 80:
        torch.testing.assert_close(flash_padded(q, k, v, H, KV).float(),
                                   fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H,
                                                           n_kv_heads=KV).float(), rtol=1e-2, atol=1e-2)
        padded = time_device_ms(lambda: flash_padded(q, k, v, H, KV))
        print(f"    the same with the second product at N = 128 on zero-padded rows: {padded:.4f} ms "
              f"({padded / ms:.2f}x the kernel)")
    return {"name": "flash_attention", "route": "cuda", "source": CSRC + "flash_attn_sm90.cu",
            "replaces": "src/repro/kernels/flash_attn.py:84", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib}


def phase_flash() -> dict:
    print("[2c] flash attention vs plain (tolerance: f32 rtol = atol = 2e-3; bf16 rtol = atol "
          "= 1e-2, one bf16 rounding of P and of the output); bf16 runs on the tensor cores "
          "(flash_attn_sm90.cu), f32 on the CUDA cores (flash_attn.cu)")
    bf16 = torch.bfloat16
    cases = [  # BH, Sq, hd, dtype, causal, Hq, Hkv[, Skv, q scale]
        (4, 256, 64, torch.float32, True, 1, 1), (2, 128, 64, torch.float32, False, 1, 1),
        (1, 512, 32, torch.float32, True, 1, 1), (3, 128, 128, torch.float32, True, 1, 1),
        (8, 256, 80, torch.float32, True, 4, 2), (8, 256, 64, bf16, True, 4, 2),
        (4, 1024, 128, bf16, True, 2, 2), (4, 512, 80, bf16, False, 4, 1),
        (2, 192, 72, torch.float32, True, 2, 1), (8, 4096, 80, torch.float32, True, 8, 8),
        # the tensor-core kernel's edges: hd 72/80/96/128 (and 32, padded to 64),
        # S not a multiple of its 128-row tiles, Sq != Skv, GQA groups 1/2/4,
        # q x 8 for scores of a large range (the running max)
        (4, 192, 72, bf16, True, 4, 4), (4, 64, 80, bf16, True, 2, 1),
        (4, 192, 96, bf16, True, 4, 1), (2, 256, 128, bf16, True, 2, 2),
        (2, 256, 32, bf16, True, 1, 1), (4, 128, 80, bf16, False, 2, 1, 320),
        (4, 192, 128, bf16, False, 4, 1, 64), (8, 512, 80, bf16, True, 8, 2, None, 8.0),
        (8, 256, 64, bf16, False, 4, 2, None, 8.0), (4, 192, 128, bf16, True, 4, 1, None, 8.0),
    ]
    for i, (BH, S, hd, dtype, causal, H, KV, *rest) in enumerate(cases):
        Skv = rest[0] if rest else None
        q_scale = rest[1] if len(rest) > 1 else 1.0
        q, k, v = flash_case(BH, S, hd, dtype, causal, H, KV, seed=10 * i, Skv=Skv, q_scale=q_scale)
        out = fl.flash_attention_cuda(q, k, v, causal=causal, n_heads=H, n_kv_heads=KV)
        torch.cuda.synchronize()
        ref = fl.flash_attention_plain(q, k, v, causal=causal, n_heads=H, n_kv_heads=KV)
        tol = 2e-3 if dtype == torch.float32 else 1e-2
        err = float((out.float() - ref.float()).abs().max())
        print(f"  (BH,Sq,Skv,hd)=({BH},{S},{k.shape[1]},{hd}) {str(dtype).split('.')[-1]} "
              f"causal={causal} Hq={H} Hkv={KV} q x {q_scale}: max abs err {err:.3e}")
        check(bool(torch.isfinite(out).all()), "flash output not finite")
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    bad_shapes = [(64, 64, 136, True), (64, 64, 84, True), (96, 96, 64, True), (64, 128, 64, True)]
    for Sq, Skv, hd, causal in bad_shapes:                # a bf16 CUDA tensor it cannot take raises
        q, k, v = flash_case(1, Sq, hd, bf16, causal, 1, 1, seed=7, Skv=Skv)
        try:
            fl.flash_attention_cuda(q, k, v, causal=causal)
        except ValueError:
            continue
        check(False, f"flash took Sq={Sq} Skv={Skv} hd={hd} causal={causal}")
    # stablelm-3b (32 heads of 80): the trainer at batch 1, S = 4096, and the
    # serving prefill at batch 4, prompt 4096; jamba-v0.1-52b's attention
    # layer at serving: batch 4, Hq 32 / Hkv 8, hd 128
    row = flash_shape("stablelm-3b trainer", 1, 32, 32, 4096, 80, seed=999)
    flash_shape("stablelm-3b serving prefill", SERVE_B, 32, 32, SERVE_P, 80, seed=777)
    flash_shape("jamba-v0.1-52b serving prefill", SERVE_B, 32, 8, SERVE_P, 128, seed=1234)
    return row


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


def wkv_inputs(B, H, S, hd, seed, decay="random"):
    r, k, v = (randn(B, H, S, hd, seed=seed + i) * 0.5 for i in range(3))
    if decay == "model":
        # the model's init: per-channel w0 from -6 (slow) to -1 (fast) plus a small data term
        ratio = torch.arange(H * hd, device=DEV, dtype=torch.float32).reshape(H, hd) / (H * hd - 1)
        w0 = -6.0 + 5.0 * ratio ** 0.7
        logw = -torch.exp(w0[None, :, None, :] + 0.1 * randn(B, H, S, hd, seed=seed + 3))
    elif decay == "harsh":
        # per-step log-decay from -0.05 down to -20: a chunk's cumsums underflow exp
        g = torch.Generator(device=DEV).manual_seed(seed + 3)
        logw = -torch.exp(torch.rand(B, H, S, hd, generator=g, device=DEV) * 6.0 - 3.0)
    else:
        logw = -torch.exp(randn(B, H, S, hd, seed=seed + 3) * 0.5 - 2.0)
    u = randn(H, hd, seed=seed + 4) * 0.1
    s0 = randn(B, H, hd, hd, seed=seed + 5) * 0.1
    return r, k, v, logw, u, s0


def wkv_err(got, want) -> float:
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def wkv_step(r, k, v, logw, u, s0):
    """The step kernel (``csrc/wkv.cu``) at any shape, for holding it beside
    the chunked one where the wrapper would take the chunked route; (B, H,
    S, hd) contiguous inputs."""
    B, H, S, hd = r.shape
    y, s_out = torch.empty_like(r), torch.empty_like(s0)
    sb, sh, st, _ = r.stride()
    build.check(build.library().repro_wkv_f32(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), B, H, S, hd, sb, sh, st, build.current_stream(r.device)),
        "repro_wkv_f32")
    return y, s_out


def wkv_bound_ms(B, H, S, hd) -> tuple:
    """(bound ms, by): bytes of r, k, v, logw, y, s0, s_out and u against the
    f32 operations of the recurrence (y and the state update)."""
    n = B * H * S * hd
    t_bytes = 4 * (5 * n + 2 * B * H * hd * hd + H * hd) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * hd * n / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_wkv() -> dict:
    print("[2e] wkv vs its plain chunked form (tolerance rtol = atol = 1e-4: f32 sums in another "
          "order, and the chunked form clips each pairwise decay at exp(-60) where the "
          "recurrence underflows); chunked route (wkv_sm90.cu, tensor cores in 3xTF32) for "
          "S >= 64 and hd 16 or 64, step route (wkv.cu) for the rest")
    cases = [  # B, H, S, hd, plain chunk, decay
        (2, 8, 64, 16, 16, "random"),         # rwkv6-1.6b smoke
        (2, 8, 37, 16, 16, "random"),         # ragged S
        (1, 4, 192, 64, 64, "random"), (2, 3, 100, 128, 32, "random"), (1, 2, 50, 8, 16, "random"),
        (4, 32, 1, 64, 128, "random"),        # one decode step
        # the chunked route's edges: one chunk, a chunk and one step, ragged;
        # 64, 32 and 16 value columns a block; decays that underflow
        (2, 4, 64, 64, 64, "random"), (2, 4, 65, 64, 65, "random"), (2, 4, 127, 64, 127, "random"),
        (2, 32, 128, 64, 64, "model"), (4, 32, 256, 64, 64, "model"),
        (1, 4, 128, 64, 64, "harsh"), (2, 8, 64, 16, 64, "harsh"), (2, 4, 127, 64, 127, "harsh"),
        (2, 3, 100, 32, 100, "harsh"),
    ]
    for B, H, S, hd, chunk, decay in cases:
        args = wkv_inputs(B, H, S, hd, seed=B * 100 + S + hd, decay=decay)
        want = wk.wkv_plain(*args, chunk=chunk)
        build.reset_launch_counts()
        err = wkv_err(wk.wkv(*args), want)
        chunked = build.route_counts["wkv_chunked"] == 1
        check(chunked == wk.chunked_route(S, hd), f"wkv took the wrong route at S={S} hd={hd}")
        line = f"  (B,H,S,hd)=({B},{H},{S},{hd}) {decay}: {'chunked' if chunked else 'step'} max abs err {err:.2e}"
        if chunked:
            line += f" (EV {wk.value_columns(B, H, hd)}); step kernel {wkv_err(wkv_step(*args), want):.2e}"
        print(line)
    # state chain: two half-sequence calls equal one call over the whole, and
    # a chunked prefill then a step equal one call over both
    r, k, v, logw, u, s0 = wkv_inputs(1, 4, 513, 64, seed=7, decay="model")
    y, s = wk.wkv(r, k, v, logw, u, s0)
    h = 256
    y1, s1 = wk.wkv(r[:, :, :h], k[:, :, :h], v[:, :, :h], logw[:, :, :h], u, s0)
    y2, s2 = wk.wkv(r[:, :, h:512], k[:, :, h:512], v[:, :, h:512], logw[:, :, h:512], u, s1)
    y3, s3 = wk.wkv(r[:, :, 512:], k[:, :, 512:], v[:, :, 512:], logw[:, :, 512:], u, s2)
    err = wkv_err((torch.cat([y1, y2, y3], dim=2), s3), (y, s))
    print(f"  state chain, 256 + 256 steps (chunked) + 1 step (step kernel) = 513: max abs err {err:.2e}")
    # the model's layout, read through a transpose
    tr = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, logw)]
    err = wkv_err(wk.wkv(*tr, u, s0), (y, s))
    print(f"  (B,S,H,hd) layout through strides: max abs err {err:.2e}")

    # rwkv6-1.6b: serving prefill (batch 4, prompt 4096), trainer (batch 1,
    # S = 4096), decode step (batch 4); each route timed at each shape
    row = None
    for label, B, S in [("serving prefill", SERVE_B, SERVE_P), ("trainer", 1, 4096)]:
        H, hd = 32, 64
        args = wkv_inputs(B, H, S, hd, seed=11 + B, decay="model")
        want = wk.wkv_plain(*args, chunk=128)
        err = wkv_err(wk.wkv(*args), want)
        step_err = wkv_err(wkv_step(*args), want)
        del want
        ms = time_device_ms(lambda: wk.wkv(*args))
        step_ms = time_device_ms(lambda: wkv_step(*args))
        bound, by = wkv_bound_ms(B, H, S, hd)
        print(f"  {label} (B,H,S,hd)=({B},{H},{S},{hd}) f32: chunked (EV {wk.value_columns(B, H, hd)}) "
              f"{ms:.4f} ms, err {err:.2e}; step {step_ms:.4f} ms, err {step_err:.2e} "
              f"({step_ms / ms:.2f}x the chunked); bound {bound:.4f} ms ({by}, "
              f"{100 * bound / ms:.0f} % of the chunked)")
        if row is None:
            plain_ms = time_ms(lambda: wk.wkv_plain(*args, chunk=128), reps=3, warmup=1)
            print(f"    plain {plain_ms:.3f} ms")
            row = {"name": "wkv", "route": "cuda", "source": CSRC + "wkv_sm90.cu",
                   "replaces": "src/repro/kernels/wkv.py:78", "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
        del args
        torch.cuda.empty_cache()
    args = wkv_inputs(SERVE_B, 32, 1, 64, seed=13)
    err = wkv_err(wk.wkv(*args), wk.wkv_plain(*args))
    ms = time_device_ms(lambda: wk.wkv(*args))
    bound, by = wkv_bound_ms(SERVE_B, 32, 1, 64)
    print(f"  decode step (B,H,S,hd)=({SERVE_B},32,1,64): step {ms:.4f} ms, err {err:.2e}, bound "
          f"{bound:.4f} ms ({by})")
    return row


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
    del args
    torch.cuda.empty_cache()
    # the decode step, the shape of 224 of the 231 launches of jamba serving
    # (7 Mamba layers x 32 tokens): timed behind the stream spin, as the wkv
    # decode step is, since its device time is microseconds
    dB = B
    dargs = ssm_inputs(dB, 1, n, di, seed=52)
    derr = ssm_err(ss.ssm_scan(*dargs), ss.ssm_scan_plain(*dargs))
    dms = time_device_ms(lambda: ss.ssm_scan(*dargs))
    d_state = dB * n * di
    dbytes = 4 * (2 * d_state + dB * di + dB * n + 2 * dB * n * di)
    d_bytes, d_ops = dbytes / HBM_BYTES_PER_S * 1e3, 4.0 * d_state / F32_FLOPS * 1e3
    print(f"  decode step (B,S,n,d_inner)=({dB},1,{n},{di}) f32, model layout: max abs err {derr:.2e}, "
          f"kernel {dms:.4f} ms (behind a stream spin), bound {max(d_bytes, d_ops):.4f} ms "
          f"({'bytes' if d_bytes >= d_ops else 'operations'}, {dbytes} B)")
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


def phase_addest() -> AddEst:
    print("[15] AddEst.measure on the card (CUDA events, L2 flushed before each add), against "
          "AddEst.h100()")
    est, model = AddEst.measure(device="cuda"), AddEst.h100()
    for x, t in zip(est.sizes, est.times):
        rate = 3 * x / t
        print(f"  {int(x):>10d} B: {t * 1e6:9.3f} us ({rate / 1e9:7.1f} GB/s); model {model(x) * 1e6:9.3f} us")
        check(0 < rate <= HBM_BYTES_PER_S * 1.05,
              f"AddEst.measure read {rate / 1e9:.0f} GB/s at {int(x)} B: above the card's peak")
    return est


def phase_timeline(trained: dict = None) -> tuple:
    """``timeline.measure`` at full width and depth: (timeline, launches)."""
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
    step = (f" (the int8 trainer's median step, fwd+bwd+sync+AdamW: "
            f"{trained['result']['median_step_s']:.3f} s)" if trained else "")
    print(f"  t_batch {tl.t_batch:.3f} s{step}; t_back {tl.t_back:.3f} s; {len(ready)} "
          f"groups, {tl.total_bytes / 2 ** 30:.2f} GiB of f32 gradients; ready at "
          f"{', '.join(f'{r:.4f}' for r in ready)} s; launches {counts}")
    check(math.isfinite(tl.t_batch) and tl.t_batch > 0, "t_batch not a positive time")
    check(all(a < b for a, b in zip(ready, ready[1:])), "ready times do not ascend")
    check(counts["flash_attention"] > 0, "timeline.measure did not run the flash kernel")
    gc.collect()
    torch.cuda.empty_cache()
    return tl, counts


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
    counts = {**build.launch_counts, **build.route_counts}
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
    check(counts["wkv_chunked"] == counts["wkv"], "a wkv launch of the trainer missed the chunked route")
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
    counts = {**build.launch_counts, **build.route_counts}
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


# ---------------------------------------------------------------------------
# phases 18-20: the paper's workloads (VGG-16, ResNet-50/101) at full width
# ---------------------------------------------------------------------------

CNN_BATCH = 32


def phase_cnn_step() -> dict:
    """``examples/torch_measured_whatif.main`` per model: the measured f32
    ``t_batch`` (TF32 off), the TF32 reading and both what-if tables."""
    print(f"[18] the paper's workloads through examples/torch_measured_whatif.py: full width, batch "
          f"{CNN_BATCH}, 224x224, 1000 classes, float32; 2 warm-ups + 5 timed fwd+bwd per model "
          f"and precision")
    out = {}
    for name in CNN_NAMES:
        gc.collect()
        torch.cuda.empty_cache()
        build.reset_launch_counts()
        res = whatif.main(["--model", name, "--batch", str(CNN_BATCH), "--repeats", "5",
                           "--warmup", "2"])
        check(all(c == 0 for c in build.launch_counts.values()),
              "a fwd+bwd of a CNN launched a codec kernel")
        for key in ("t_batch_f32", "t_batch_tf32"):
            check(math.isfinite(res[key]) and res[key] > 0, f"{name}: {key} not a positive time")
        for table in (res["scaling"], *res["schedulers"].values()):
            check(all(0.0 < f <= 1.0 for row in table.values() for f in row.values()),
                  f"{name}: a scaling factor outside (0, 1]")
        out[name] = res
    return out


def cnn_batches(steps: int) -> list:
    g = torch.Generator(device=DEV).manual_seed(1)
    return [{"images": torch.randn(CNN_BATCH, 224, 224, 3, generator=g, device=DEV),
             "labels": torch.randint(0, 1000, (CNN_BATCH,), generator=g, device=DEV)}
            for _ in range(steps)]


def run_cnn_trainer(name: str, compression: str, steps: int = 2,
                    use_pallas: str = "auto") -> dict:
    """``steps`` momentum-SGD steps (constant lr 0.01, explicit comm) of a
    full-width CNN through ``launch.train.make_train_step``, seed 0; then the
    grad sync alone on the last gradients, timed by CUDA events."""
    gc.collect()
    torch.cuda.empty_cache()
    api = cnn_api(CNNConfig(name, use_pallas=use_pallas))
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    opt, world = get_optimizer("momentum"), InProcessWorld(1)
    comm = CommConfig(mode="explicit", compression=compression)
    step_fn = train.make_train_step(api, opt, world, comm, get_schedule("constant", 0.01, 0, steps))
    opt_state = opt.init(params)
    batches = cnn_batches(steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _, grads = value_and_grad(api.loss_fn, params, batches[-1])
    sync_ms = time_ms(lambda: sync_grads(grads, world, comm, use_kernels=use_pallas != "never"),
                      reps=3, warmup=1)
    plan, _ = make_plan(api.init(None, device="meta"), comm.fusion_buffer_mb)
    return {"losses": losses, "step_s": statistics.median(times[1:]), "first_s": times[0],
            "sync_ms": sync_ms, "peak_gib": peak, "counts": counts, "buckets": plan.n_buckets}


def phase_cnn_trainer() -> dict:
    steps = 2
    print(f"[19] CNN trainer through launch.train.make_train_step: full width, batch {CNN_BATCH}, "
          f"224x224, float32 (TF32 off), explicit comm, momentum SGD, lr 0.01, {steps} steps; "
          f"int8 for each model (against a use_pallas=never run of the same seed), ternary and topk "
          f"for resnet50")
    out = {}
    with whatif.tf32(False):                   # the V100 times are float32
        for name, compression in [(n, "int8") for n in CNN_NAMES] + [("resnet50", "ternary"),
                                                                     ("resnet50", "topk")]:
            r = run_cnn_trainer(name, compression, steps)
            c, nb = r["counts"], r["buckets"]
            print(f"  {name} {compression}: losses {r['losses']}; step {r['step_s'] * 1e3:.2f} ms "
                  f"(median of steps after the first; first {r['first_s'] * 1e3:.1f} ms), "
                  f"{CNN_BATCH / r['step_s']:.1f} images/s, grad sync alone {r['sync_ms']:.3f} ms, "
                  f"peak memory {r['peak_gib']:.2f} GiB; {nb} buckets; launches {c}")
            check(all(math.isfinite(x) for x in r["losses"]), f"{name} {compression}: a loss is not finite")
            if compression == "int8":
                check(c["quantize_int8_2d"] == c["dequantize_int8_2d"] == c["fused_add_2d"] == nb * steps,
                      f"{name}: expected one int8 encode, decode and add per bucket and step ({nb} x {steps})")
                ref = run_cnn_trainer(name, compression, steps, use_pallas="never")
                check(all(n == 0 for n in ref["counts"].values()), "the plain run launched a kernel")
                print(f"    plain codec: losses {ref['losses']}; step {ref['step_s'] * 1e3:.2f} ms, "
                      f"grad sync alone {ref['sync_ms']:.3f} ms")
                # cuDNN's default backward algorithms accumulate in an order that changes
                # from run to run, and one flipped int8 code moves the next loss: the runs
                # held against each other take cuDNN's deterministic algorithms
                torch.backends.cudnn.deterministic = True
                try:
                    det = [run_cnn_trainer(name, compression, steps, use_pallas=u)["losses"]
                           for u in ("auto", "never")]
                finally:
                    torch.backends.cudnn.deterministic = False
                for i in range(steps):
                    spread = abs(r["losses"][i] - ref["losses"][i]) / abs(ref["losses"][i])
                    rel = abs(det[0][i] - det[1][i]) / abs(det[1][i])
                    print(f"    step {i}, cuDNN deterministic: kernels {det[0][i]:.7f} vs plain "
                          f"{det[1][i]:.7f} (rel diff {rel:.2e}, tolerance 1e-6: float32 model, "
                          f"bit-exact codes); default algorithms {spread:.2e} apart")
                    check(rel <= 1e-6, f"{name}: kernel and plain CNN trainer disagree")
                r["plain"] = ref
            elif compression == "ternary":
                check(c["ternarize_2d"] == c["dequantize_int8_2d"] == nb * steps,
                      f"expected one ternary encode and decode per bucket and step ({nb} x {steps})")
            else:
                check(c["topk_mask_2d"] == c["fused_add_2d"] == nb * steps,
                      f"expected one top-k mask and one add per bucket and step ({nb} x {steps})")
            out[f"{name}/{compression}"] = r
    return out


def phase_cnn_whatif(measured: dict) -> None:
    print("[20] what-if on the measured timelines: timeline.from_cnn(name, t_batch) and "
          "simulate(n_workers=64, transport='ideal'); scaling factor at 10 / 25 / 100 Gbps")
    for name, res in measured.items():
        v100 = res["t_batch_v100"]
        print(f"  {name}: t_batch f32 {res['t_batch_f32'] * 1e3:.2f} ms "
              f"({CNN_BATCH / res['t_batch_f32']:.1f} img/s), TF32 {res['t_batch_tf32'] * 1e3:.2f} ms "
              f"({CNN_BATCH / res['t_batch_tf32']:.1f} img/s); V100 constant {v100 * 1e3:.2f} ms "
              f"({32 / v100:.0f} img/s at batch 32); bounds f32 {res['bound_f32'] * 1e3:.2f} ms, "
              f"TF32 {res['bound_tf32'] * 1e3:.2f} ms")
        for label, row in res["scaling"].items():
            print(f"    {label:<14}" + "".join(f"  {bw:>3} Gbps {f:.4f}" for bw, f in row.items()))
        check(res["scaling"]["this-device"][100] <= res["scaling"]["paper-V100"][100] + 1e-12
              or res["t_batch_f32"] >= v100,
              f"{name}: a shorter step than the V100's hid more communication")
    print("  vgg16, scheduler x bandwidth on the measured f32 timeline (horovod_tcp, 64 workers):")
    for sched, row in measured["vgg16"]["schedulers"]["this-device"].items():
        print(f"    {sched:<10}" + "".join(f"  {bw:>3} Gbps {f:.4f}" for bw, f in row.items()))


# ---------------------------------------------------------------------------
# phase 21: the experiment engine and the H100 what-if of the measured trainer
# ---------------------------------------------------------------------------

# the eight suites CI gates, with the golden each is compared with
GOLDEN_SUITES = {"paper": "paper_suite.json", "scheduler": "scheduler_suite.json",
                 "scenario": "scenario_suite.json", "compression": "compression_suite.json",
                 "churn": "churn_suite.json", "fabric": "fabric_suite.json",
                 "wan": "wan_suite.json", "xxl": "xxl_contention_suite.json"}


def run_engine(argv: list) -> tuple:
    """``python -m repro_torch.experiments ARGV`` in a process of its own (the
    engine's process pool must not fork this one, which holds a CUDA
    context): (completed process, wall seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO / "src"), env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.experiments", *argv], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    return proc, time.perf_counter() - t0


def phase_engine(tl: timeline.GradTimeline, tl_counts: dict, measured_add: AddEst) -> None:
    print("[21] the experiment engine as a user runs it: python -m repro_torch.experiments run "
          "--grid G (to its default, artifacts/experiments/G.json), then compare against "
          "artifacts/golden/ (1e-9), a process each")
    for grid, golden in GOLDEN_SUITES.items():
        out = REPO / "artifacts" / "experiments" / f"{grid}.json"
        run, t_run = run_engine(["run", "--grid", grid])
        check(run.returncode == 0, f"experiments run --grid {grid} exited {run.returncode}:\n"
              f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        cmp, t_cmp = run_engine(["compare", str(REPO / "artifacts" / "golden" / golden), str(out)])
        check(cmp.returncode == 0, f"experiments compare {golden} exited {cmp.returncode}:\n"
              f"{cmp.stdout[-3000:]}{cmp.stderr[-2000:]}")
        print(f"  {grid:<12} run {t_run:6.2f} s, compare {t_cmp:6.2f} s (wall, with the interpreter's "
              f"start): {cmp.stdout.strip().splitlines()[0]}")

    # the what-if of the measured trainer: phase 16's stablelm-3b fwd+bwd at
    # full width and depth, S = 4096, batch 1 (one replica's step)
    cfg = get_config("stablelm-3b")
    shape = InputShape("train_4k", INPUT_SHAPES["train_4k"].seq_len, 1, "train")
    fwd = flops.total_fwd_flops(cfg, shape)
    mfu = 3.0 * fwd / (tl.t_batch * BF16_FLOPS)
    mfu_6nd = flops.model_flops(cfg, shape) / (tl.t_batch * BF16_FLOPS)
    print(f"  stablelm-3b fwd+bwd measured in phase 16 (flash launches {tl_counts['flash_attention']}): "
          f"t_batch {tl.t_batch:.4f} s; 3 x forward FLOPs {3.0 * fwd:.4e} -> MFU {mfu:.4f} of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s; 6 N D {flops.model_flops(cfg, shape):.4e} "
          f"-> MFU {mfu_6nd:.4f}")
    check(math.isfinite(mfu) and 0.0 < mfu < 1.0, f"measured MFU {mfu} not in (0, 1)")
    modelled = timeline.from_transformer(cfg, shape, mfu=mfu)
    check(abs(modelled.t_batch - tl.t_batch) <= 1e-9 * tl.t_batch,
          "from_transformer at the measured MFU does not reproduce the measured t_batch")
    print("  h100_whatif(stablelm-3b, S = 4096, batch 1 a GPU; NVLink 3600 Gbps in a node of 8, "
          "InfiniBand a GPU across nodes; ideal transport): scaling factor (t_sync ms)")
    for add_label, add in (("AddEst.h100()", AddEst.h100()), ("AddEst.measure", measured_add)):
        for m_label, m in (("0.4", 0.4), ("measured", mfu)):
            for ib in (100.0, 400.0):
                for ratio in (1.0, 4.0):
                    res = {n: h100_whatif(cfg, shape, n_gpus=n, ib_gbps=ib, mfu=m,
                                          compression_ratio=ratio, addest=add)
                           for n in (8, 64, 256)}
                    for n, r in res.items():
                        check(0.0 < r.scaling_factor <= 1.0,
                              f"scaling factor {r.scaling_factor} at {n} GPUs not in (0, 1]")
                    check(res[256].scaling_factor <= res[64].scaling_factor + 1e-12,
                          f"256 GPUs better than 64 ({add_label}, mfu {m}, IB {ib}, {ratio}x)")
                    print(f"    {add_label:<14} mfu {m_label:<8} IB {ib:3.0f} Gbps "
                          f"{'int8 4x' if ratio == 4.0 else 'none   '}:" + "".join(
                              f"  {n:>3} GPUs {r.scaling_factor:.4f} ({r.t_sync * 1e3:8.3f})"
                              for n, r in res.items()))


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
    measured_add = phase_addest()
    phase_grad_sync()
    trained = phase_trainer(args.layers)
    tl, tl_counts = phase_timeline(trained)
    ternary_counts = phase_ternary(args.ternary_layers)
    phase_serve("7", "stablelm-3b", {"flash_attention": get_config("stablelm-3b").num_layers},
                [{"attn_chunk": 512}])
    rwkv_cfg = get_config("rwkv6-1.6b")
    # every layer's prefill on the chunked route, every decode step on the step route
    rwkv_counts = phase_serve("8", "rwkv6-1.6b", {"wkv": rwkv_cfg.num_layers * (1 + SERVE_G),
                                                  "wkv_chunked": rwkv_cfg.num_layers},
                              [{"ssm": dataclasses.replace(rwkv_cfg.ssm, chunk_size=64)}])
    print(f"  wkv launches on rwkv6-1.6b serving: {rwkv_counts['wkv']}, of them "
          f"{rwkv_counts['wkv_chunked']} on the chunked route (the prefill's)")
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
    measured = phase_cnn_step()
    phase_cnn_trainer()
    phase_cnn_whatif(measured)
    phase_engine(tl, tl_counts, measured_add)

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
    print(f"[22] total {time.time() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
