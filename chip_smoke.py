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
  gradients, through the fused selective scan (``csrc/ssm_scan_sm90.cu``,
  the discretisation inside the scan) against the plain scan, and one
  ``bf16_stream`` forward through the TPU-signature scan
  (``csrc/ssm_scan.cu``);
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
  ``AddEst.measure`` took on the card;
- last, the trainer across processes: ``launch.train.main`` under the
  environment torchrun gives rank 0 of a world of one, so that it runs over
  an NCCL process group, held to phase 4's losses and launch counts;
  ``sync_grads`` of a full-width stablelm-3b gradient tree, none and int8,
  and the NCCL gather of the largest bucket's codes against its copy bound,
  each in the NCCL world and in the in-process world of one; then ``python
  -m torch.distributed.run --standalone --nproc_per_node <device count> -m
  repro_torch.launch.train`` at 2 layers with ``--ckpt-dir``, its step-2
  checkpoint restored on the card through ``checkpoint.store`` and a save ->
  restore round trip of that state checked bit for bit.  One card runs an
  NCCL world of one rank: nothing there is wire time;
- then the other model families (phases 24-30): ``launch.train.main`` on
  moonshot-v1-16b-a3b (MoE, full width, 1 dense + 3 MoE layers, int8)
  against a plain run, its ``sync_grads`` time and gradient bytes beside
  stablelm-3b's; and ``launch.serve.main`` at full width on moonshot-v1-16b-a3b
  and command-r-35b, deepseek-coder-33b, internvl2-2b (256 prefix embeddings
  ahead of the prompt) and whisper-base (1500 frames, prompt 384) at full
  depth, deepseek-v2-236b (MLA; 4 layers, no kernel on its path, so kernel
  and plain runs agree bit for bit) and arctic-480b (2 layers) cut in depth,
  each held against the plain path's own spread and under 75 GiB of peak
  memory.  The flash kernel is held to its plain version at those decoders'
  head layouts in phase 2c;
- last (phases 31-36), the production mesh's code paths: the step of
  ``launch/specs.make_step_fn`` on DTensors of a one-rank NCCL
  ``DeviceMesh``, stablelm-3b at full width and depth on the kernels and on
  the plain versions, beside the roofline terms ``utils/step_analysis``
  reads from the same step; ``python -m repro_torch.launch.dryrun`` in
  subprocesses on the host's cores (one architecture of each family, every
  shape, both production meshes, with and without ``--production``) and
  ``benchmarks/torch_roofline.py``'s table of it; ``launch.train.main`` on
  deepseek-coder-33b (4 layers), internvl2-2b and whisper-base (full depth),
  int8, against plain runs; and one full-width MLA block of
  deepseek-v2-236b, forward and backward in bf16, against float64. [31]
  also runs the specs' step once under ``seq_parallel="data"`` (the same
  loss on one rank). [32] also checks that every train_4k traced on both
  meshes counts, per device, 0.45-0.55 of 16x16's FLOPs on 2x16x16 and
  gathers over `pod` no more than its bf16 parameters a device, and that
  every combination's FLOPs and collective bytes by kind and axis equal the
  committed ``artifacts/dryrun/torch_results.json`` (traced on a CPU under
  another torch release), and prints on one line the long_500k FLOPs and
  `data` bytes a device of seven architectures beside the record before
  their products were split over `data` (``PARENT_LONG_500K``);
- last (phase 37), ``examples/torch_train_e2e.main``: repro-100m (the
  reference example's ~100M float32 decoder), S 256, batch 4, 300 steps
  under each of none, fp16, int8, ternary and topk, every loss falling and
  fp16 within 0.15 of none, the first 3 steps of none and int8 against the
  plain versions; then ``examples/torch_gradient_compression.main``,
  ``examples/torch_serve_batch.main`` and ``benchmarks/torch_run.py`` (a
  subprocess that must exit 0) on the card;
- last (phase 38), ``remat_policy="dots"`` against "full": stablelm-3b at
  full width and depth through ``launch.train.main`` (int8, 5 steps) under
  "dots", held to phase 4's run of the same arguments under the config's
  "full": the median step, peak memory and flash launches of each and the
  same losses.

Launch counters, reset right before each run and read right after, show
that the run went through the kernels.

Any failed phase raises, so the exit code is non-zero and the closing JSON
lines are not printed.  Without a CUDA device it exits non-zero at once.
``--layers N`` cuts the depth of the int8 trainer run (default: the model's 32).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import socket
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
import torch.distributed as dist  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch.nn.functional as F  # noqa: E402

from benchmarks import torch_roofline as roofline  # noqa: E402
from examples import torch_measured_whatif as whatif  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
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
from repro_torch.launch import dryrun, serve, train  # noqa: E402
from repro_torch.launch import specs as specs_lib  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as MESH_HBM_BW  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16, make_smoke_mesh  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import mamba as mb  # noqa: E402
from repro_torch.models.cnn import CNN_NAMES, CNNConfig, cnn_api  # noqa: E402
from repro_torch.models.jamba import block_layout as jamba_layout  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.parallel.collectives import DistributedWorld, InProcessWorld  # noqa: E402
from repro_torch.optim.optimizers import get_optimizer  # noqa: E402
from repro_torch.optim.schedule import get_schedule  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.parallel.grad_sync import make_plan, sync_grads, sync_grads_per_rank  # noqa: E402
from repro_torch.utils import trace  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths, value_and_grad  # noqa: E402

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOPS = timeline.H100_BF16_FLOPS   # dense tensor-core rate, bf16
F32_FLOPS = 67e12                  # CUDA cores, f32
TF32_FLOPS = 495e12                # dense tensor-core rate, TF32
F32_TOL = 1e-5                     # the f32 flash kernel against its plain version (3xTF32)
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
    return statistics.median(interleaved_ms({"fn": fn}, reps)["fn"])


def interleaved_ms(fns: dict, reps: int) -> dict:
    """Device time of one call of each function, the functions taken in
    turns ``reps`` times, each sample behind the stream spin of
    ``time_device_ms``; a list of samples by name."""
    for fn in fns.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return times


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


def flash_shape(label: str, B: int, H: int, KV: int, S: int, hd: int, seed: int,
                dtype=torch.bfloat16) -> dict:
    """The kernel at a main path's causal shape (bf16: ``flash_attn_sm90.cu``
    in bf16 on the tensor cores; f32: ``flash_attn.cu`` in 3xTF32 on the
    tensor cores): held against the plain version, timed beside it, beside
    scaled_dot_product_attention and beside its bound (f32: and beside the
    3xTF32 floor, three TF32 products at 495 TFLOP/s)."""
    f32 = dtype == torch.float32
    q, k, v = flash_case(B * H, S, hd, dtype, True, H, KV, seed=seed)
    out = fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV)
    # the plain version holds its (B·H, S, S) f32 scores three times over:
    # above 8 GiB of them it runs one batch row a call
    rows = 1 if B * H * S * S * 4 > 8 * 2 ** 30 else B

    def plain():
        return torch.cat([fl.flash_attention_plain(q[b * H:(b + rows) * H], k[b * KV:(b + rows) * KV],
                                                   v[b * KV:(b + rows) * KV], causal=True,
                                                   n_heads=H, n_kv_heads=KV)
                          for b in range(0, B, rows)])

    ref = plain()
    check(bool(torch.isfinite(out).all()), f"flash output not finite at {label}")
    for tol in ((2e-3, F32_TOL) if f32 else (1e-2,)):
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    err = float((out.float() - ref.float()).abs().max())
    del out, ref
    torch.cuda.empty_cache()
    ms = time_device_ms(lambda: fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H, n_kv_heads=KV))
    plain_ms = time_ms(plain, reps=3, warmup=1)
    q4, k4, v4 = q.reshape(B, H, S, hd), k.reshape(B, KV, S, hd), v.reshape(B, KV, S, hd)
    lib = time_device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                                enable_gqa=KV != H))
    flops = 4.0 * hd * B * H * (S * (S + 1) / 2)          # two products over the causal triangle
    nbytes = q.element_size() * S * hd * (2 * B * H + 2 * B * KV)    # q and o; k and v
    t_ops = flops / (F32_FLOPS if f32 else BF16_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  ({B * H},{S},{hd}) {'f32' if f32 else 'bf16'} causal Hq={H} Hkv={KV} ({label}): "
          f"err {err:.3e}, kernel "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms"
          f"{'' if rows == B else f' ({B} calls of one batch row)'}, "
          f"scaled_dot_product_attention {lib:.4f} ms ({ms / lib:.2f}x), bound "
          f"{max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'})"
          + (f", 3xTF32 floor {3 * flops / TF32_FLOPS * 1e3:.4f} ms" if f32 else ""))
    if hd == 80 and not f32:
        torch.testing.assert_close(flash_padded(q, k, v, H, KV).float(),
                                   fl.flash_attention_cuda(q, k, v, causal=True, n_heads=H,
                                                           n_kv_heads=KV).float(), rtol=1e-2, atol=1e-2)
        padded = time_device_ms(lambda: flash_padded(q, k, v, H, KV))
        print(f"    the same with the second product at N = 128 on zero-padded rows: {padded:.4f} ms "
              f"({padded / ms:.2f}x the kernel)")
    return {"name": "flash_attention", "route": "cuda",
            "source": CSRC + ("flash_attn.cu" if f32 else "flash_attn_sm90.cu"),
            "replaces": "src/repro/kernels/flash_attn.py:84", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": lib}


def phase_flash() -> dict:
    print("[2c] flash attention vs plain (tolerance: f32 rtol = atol = 2e-3 and 1e-5; bf16 rtol "
          "= atol = 1e-2, one bf16 rounding of P and of the output); both on the tensor cores: "
          "bf16 in bf16 (flash_attn_sm90.cu), f32 in 3xTF32 (flash_attn.cu)")
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
        err = float((out.float() - ref.float()).abs().max())
        print(f"  (BH,Sq,Skv,hd)=({BH},{S},{k.shape[1]},{hd}) {str(dtype).split('.')[-1]} "
              f"causal={causal} Hq={H} Hkv={KV} q x {q_scale}: max abs err {err:.3e}")
        check(bool(torch.isfinite(out).all()), "flash output not finite")
        for tol in ((2e-3, F32_TOL) if dtype == torch.float32 else (1e-2,)):
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
    # the decoders served in phases 25, 28 and 29 at their prefills: G = Hq / Hkv of 1, 2, 8, 7
    flash_shape("moonshot-v1-16b-a3b serving prefill", SERVE_B, 16, 16, SERVE_P, 128, seed=1301)
    flash_shape("internvl2-2b serving prefill, 256 prefix + 4096", SERVE_B, 16, 8,
                VLM_PREFIX + SERVE_P, 128, seed=1302)
    flash_shape("command-r-35b serving prefill", SERVE_B, 64, 8, SERVE_P, 128, seed=1303)
    flash_shape("deepseek-coder-33b serving prefill", SERVE_B, 56, 8, SERVE_P, 128, seed=1304)
    # whisper-base's decoder self-attention in phase 35's trainer: 8 heads of 64, MHA
    flash_shape("whisper-base trainer (decoder self-attention)", 1, 8, 8, 4096, 64, seed=1305)
    # repro-100m in phase 37's 300-step runs: f32, batch 4, S 256, 12 heads of 64, 4 kv heads;
    # and the f32 route at a long sequence, stablelm-3b's head_dim
    flash_shape("repro-100m trainer (examples/torch_train_e2e.py)", 4, 12, 4, 256, 64, seed=1306,
                dtype=torch.float32)
    flash_shape("f32 at a long sequence", 1, 8, 8, 4096, 80, seed=1307, dtype=torch.float32)
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
        trace.reset_counts()
        err = wkv_err(wk.wkv(*args), want)
        chunked = trace.counts("route")["wkv_chunked"] == 1
        check(chunked == wk.chunked_route(S, hd), f"wkv took the wrong route at S={S} hd={hd}")
        line = f"  (B,H,S,hd)=({B},{H},{S},{hd}) {decay}: {'chunked' if chunked else 'step'} max abs err {err:.2e}"
        if chunked:
            line += f" (EV {wk.value_columns(B, H, hd)}); step kernel {wkv_err(wkv_step(*args), want):.2e}"
        else:
            line += f", {time_device_ms(lambda: wk.wkv(*args)):.4f} ms"
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
    floor = launch_floor_ms()
    bound, by = wkv_bound_ms(SERVE_B, 32, 1, 64)
    print(f"  decode step (B,H,S,hd)=({SERVE_B},32,1,64): step {ms:.4f} ms, err {err:.2e}, bound "
          f"{bound:.4f} ms ({by}); launch floor (an empty kernel, one block) {floor:.4f} ms: the "
          f"step is {ms / floor:.2f}x the floor")
    return row


def launch_floor_ms() -> float:
    """An empty kernel of one block (``repro_empty``), timed as every
    kernel here: the least a launch costs behind the stream spin."""
    lib = build.library()
    stream = build.current_stream(DEV)
    return time_device_ms(lambda: build.check(lib.repro_empty(stream), "repro_empty"))


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


def fused_inputs(B, S, n, di, seed, x_dtype=torch.bfloat16, h0_model=True):
    """dt, x, b_t, c_t, a, h0 for ``ss.ssm_scan_fused`` as the mixer makes
    them: dt the softplus of noise around the model's dt_bias, x in its own
    dtype, a = -(1..n) (the S4D-real init), h0 in the model's (B, di, n)
    layout or as a strided view of a (B, n, di) tensor."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    dt0 = torch.exp(torch.rand(di, generator=g, device=DEV) * math.log(100.0) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))            # the model's dt_bias
    dt = F.softplus(torch.randn(B, S, di, generator=g, device=DEV) * 0.5 + bias)
    x = torch.randn(B, S, di, generator=g, device=DEV).to(x_dtype)
    b_t = torch.randn(B, S, n, generator=g, device=DEV)
    c_t = torch.randn(B, S, n, generator=g, device=DEV)
    a = -torch.arange(1, n + 1, device=DEV, dtype=torch.float32).expand(di, n).contiguous()
    if h0_model:
        h0 = torch.randn(B, di, n, generator=g, device=DEV) * 0.1
    else:
        h0 = (torch.randn(B, n, di, generator=g, device=DEV) * 0.1).transpose(1, 2)
    return dt, x, b_t, c_t, a, h0


def sm_clock_hz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def fused_bound_ms(B, S, n, di, x_bytes, clock_hz) -> tuple:
    """(bound, by, bytes term, f32 operations term, exp term) in ms: dt f32,
    x and y f32 each once per (b, t, d); B and C; a; h0 and h.  About 6 f32
    operations a state element (dt*a, dtx*b, the state's multiply-add and
    y's) and dt*x per channel; one exp a state element on the
    special-function units, 16 a clock on each SM."""
    nbytes = B * S * di * (4 + x_bytes + 4) + 2 * B * S * n * 4 + di * n * 4 + 2 * B * di * n * 4
    elems = B * S * di * n
    n_sm = torch.cuda.get_device_properties(DEV).multi_processor_count
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (6.0 * elems + B * S * di) / F32_FLOPS * 1e3
    t_exp = elems / (16.0 * n_sm * clock_hz) * 1e3
    bound = max(t_bytes, t_ops, t_exp)
    return bound, ("bytes" if bound == t_bytes else "operations"), t_bytes, t_ops, t_exp


def phase_ssm_fused() -> dict:
    """The fused selective scan (csrc/ssm_scan_sm90.cu) against
    ``ssm_scan_fused_plain`` at the main path's shapes and ragged ones."""
    print("[2g] ssm_scan_fused (csrc/ssm_scan_sm90.cu: exp(dt*A) and dt*x*B formed inside the scan) "
          "vs ssm_scan_fused_plain (tolerance rtol = atol = 1e-4, phase 2f's: f32 state, fused "
          "multiply-adds and a shuffle sum against separate roundings)")
    clock = sm_clock_hz()
    print(f"  SM clock (nvidia-smi clocks.max.sm) {clock / 1e6:.0f} MHz, "
          f"{torch.cuda.get_device_properties(DEV).multi_processor_count} SMs")

    def line(label, B, S, n, di, x_dtype, err, ms, plain_ms):
        bound, by, tb, to, te = fused_bound_ms(B, S, n, di, torch.finfo(x_dtype).bits // 8, clock)
        print(f"  {label} (B,S,d_inner,n)=({B},{S},{di},{n}) x {str(x_dtype).split('.')[-1]}: max abs "
              f"err {err:.2e}, kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; "
              f"bytes {tb:.4f}, f32 operations {to:.4f}, exp {te:.4f}), {100 * bound / ms:.0f} % of "
              f"the bound")
        return bound, by

    # S and d_inner not multiples of 128; each of the launch's shapes (4
    # states a thread below 64 steps or at n <= 4, 8 above) with and without
    # the bulk copies (d_inner % 8, n % NPT), and 1 to 8 lanes a channel
    for i, (B, S, di, n) in enumerate([(2, 100, 200, 16), (1, 300, 96, 8), (3, 65, 130, 12),
                                       (2, 50, 64, 5), (2, 40, 33, 16), (1, 33, 8192, 16),
                                       (8, 40, 4100, 12), (2, 40, 64, 32), (5, 70, 4100, 12),
                                       (3, 70, 8200, 5), (4, 100, 8192, 16), (2, 96, 8192, 32),
                                       (2, 80, 96, 3), (2, 80, 128, 4)]):
        for x_dtype in (torch.float32, torch.bfloat16):
            for h0_model in (True, False):
                args = fused_inputs(B, S, n, di, seed=70 + i, x_dtype=x_dtype, h0_model=h0_model)
                err = ssm_err(ss.ssm_scan_fused(*args), ss.ssm_scan_fused_plain(*args))
            ms = time_device_ms(lambda: ss.ssm_scan_fused(*args), reps=5)
            plain_ms = time_ms(lambda: ss.ssm_scan_fused_plain(*args), reps=3, warmup=1)
            line("ragged", B, S, n, di, x_dtype, err, ms, plain_ms)
    print("  (each ragged shape also with h0 a strided (B, n, d_inner) view: equal within tolerance)")
    # state chain: two calls that carry h equal one call over both halves
    dt, x, b_t, c_t, a, h0 = fused_inputs(2, 512, 16, 1024, seed=80)
    y, h = ss.ssm_scan_fused(dt, x, b_t, c_t, a, h0)
    y1, h1 = ss.ssm_scan_fused(dt[:, :200], x[:, :200], b_t[:, :200], c_t[:, :200], a, h0)
    y2, h2 = ss.ssm_scan_fused(dt[:, 200:], x[:, 200:], b_t[:, 200:], c_t[:, 200:], a, h1)
    err = ssm_err((torch.cat([y1, y2], dim=1), h2), (y, h))
    print(f"  state chain, 200 + 312 = 512 steps: max abs err {err:.2e}")
    for bad, why in (((dt.double(), x, b_t, c_t, a, h0), "float64 dt"),
                     ((dt, x, b_t[..., :4], c_t, a, h0), "b_t of another n"),
                     ((dt, x, torch.zeros(2, 512, 40, device=DEV), torch.zeros(2, 512, 40, device=DEV),
                       torch.zeros(1024, 40, device=DEV), torch.zeros(2, 1024, 40, device=DEV)),
                      "n = 40 > 32")):
        try:
            ss.ssm_scan_fused(*bad)
        except ValueError:
            pass
        else:
            check(False, f"ssm_scan_fused took {why}")
    del dt, x, b_t, c_t, a, h0, y, h, y1, y2, h1, h2
    torch.cuda.empty_cache()

    row = None
    # jamba-v0.1-52b: serving prefill (batch 4, prompt 4096, bf16 x), the
    # trainer's batch 1; then the decode step, 224 of the 231 launches of
    # jamba serving (7 Mamba layers x 32 tokens), timed behind the stream spin
    for label, B, S in (("serving prefill", SERVE_B, SERVE_P), ("trainer", 1, 4096),
                        ("decode step", SERVE_B, 1)):
        n, di = 16, 8192
        args = fused_inputs(B, S, n, di, seed=90 + B + S)
        want = ss.ssm_scan_fused_plain(*args)
        err = ssm_err(ss.ssm_scan_fused(*args), want)
        y_max = float(want[0].abs().max())
        del want
        ms = time_device_ms(lambda: ss.ssm_scan_fused(*args))
        plain_ms = time_ms(lambda: ss.ssm_scan_fused_plain(*args), reps=3, warmup=1)
        bound, by = line(label, B, S, n, di, torch.bfloat16, err, ms, plain_ms)
        if row is None:
            print(f"    |y| up to {y_max:.2f}; library: none (no single PyTorch call)")
            row = {"name": "ssm_scan", "route": "cuda", "source": CSRC + "ssm_scan_sm90.cu",
                   "sources": [CSRC + "ssm_scan_sm90.cu", CSRC + "ssm_scan.cu"],
                   "replaces": "src/repro/kernels/ssm_scan.py:65", "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
        del args
        torch.cuda.empty_cache()
    return row


def phase_mamba_mixer(S: int = 4096) -> None:
    """One Mamba layer of jamba-v0.1-52b at full width in float32: the
    fused kernel route against the plain ``assoc`` scan, forward and
    gradients; then one forward under ``bf16_stream``, the path that keeps
    the TPU-signature kernel (csrc/ssm_scan.cu), against its plain twin."""
    B = 1
    cfg = get_config("jamba-v0.1-52b").replace(dtype="float32")
    print(f"[6] Mamba mixer, jamba-v0.1-52b full width (d_model {cfg.d_model}, d_inner "
          f"{mb.dims(cfg)[0]}, d_state {cfg.ssm.d_state}), float32, batch {B}, prompt {S}: the fused "
          f"kernel route vs use_pallas=never (tolerance: output 1e-4, gradients 1e-3 relative L2; "
          f"f32, order of sums)")
    torch.cuda.empty_cache()
    params = mb.init_mamba(torch.Generator(device=DEV).manual_seed(0), cfg)
    x = randn(B, S, cfg.d_model, seed=60)
    cot = randn(B, S, cfg.d_model, seed=61)
    results, peaks = {}, {}
    for mode in ("auto", "never"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        trace.reset_counts()
        xg = x.clone().requires_grad_(True)
        w_in = params["w_in"].detach().clone().requires_grad_(True)
        out, state = mb.mamba_mixer({**params, "w_in": w_in}, xg, cfg.replace(use_pallas=mode))
        gx, gw = torch.autograd.grad(torch.sum(out * cot), (xg, w_in))
        torch.cuda.synchronize()
        peaks[mode] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        results[mode] = (out.detach(), state["ssm"].detach(), gx, gw,
                         trace.counts("launch")["ssm_scan"], trace.counts("route")["ssm_scan_fused"])
        del out, state, xg, w_in
    check(results["auto"][4:] == (1, 1) and results["never"][4:] == (0, 0),
          "expected one ssm_scan launch, on the fused route, on the kernel path and none on the plain one")
    print(f"  peak device memory above the inputs, forward and backward: fused route "
          f"{peaks['auto']:.2f} GiB, plain {peaks['never']:.2f} GiB")
    names = ["output", "final state", "d loss / d x", "d loss / d w_in"]
    tols = [1e-4, 1e-4, 1e-3, 1e-3]
    for i, (name, tol) in enumerate(zip(names, tols)):
        a, b = results["auto"][i], results["never"][i]
        check(bool(torch.isfinite(a).all()), f"mixer {name} not finite")
        rel = rel_l2(a, b)
        print(f"  {name}: rel L2 {rel:.3e} (tolerance {tol:.0e})")
        check(rel <= tol, f"Mamba mixer {name}: kernel and plain disagree")
    del results
    # bf16_stream: decay, bx, C and h0 rounded to bf16, the scan in f32 on
    # the TPU-signature kernel; its plain twin is the seq scan on the same
    # bf16 inputs (the chunked one would carry a bf16 state)
    outs = {}
    for mode, extra in (("auto", {}), ("never", {"mamba_scan_impl": "seq"})):
        trace.reset_counts()
        with torch.no_grad():
            outs[mode], _ = mb.mamba_mixer(params, x, cfg.replace(use_pallas=mode, bf16_stream=True,
                                                                   **extra))
        torch.cuda.synchronize()
        outs[mode + " counts"] = (trace.counts("launch")["ssm_scan"], trace.counts("route")["ssm_scan_fused"])
    check(outs["auto counts"] == (1, 0) and outs["never counts"] == (0, 0),
          "bf16_stream: expected one launch of csrc/ssm_scan.cu and none of the fused route")
    rel = rel_l2(outs["auto"], outs["never"])
    print(f"  bf16_stream forward (csrc/ssm_scan.cu, 1 launch) vs the plain seq scan on the same bf16 "
          f"inputs: output rel L2 {rel:.3e} (tolerance 1e-4)")
    check(bool(torch.isfinite(outs["auto"]).all()) and rel <= 1e-4,
          "Mamba mixer under bf16_stream: kernel and plain disagree")
    del params, outs
    torch.cuda.empty_cache()


def phase_dequantize(R_main: int) -> dict:
    print("[2h] dequantize_int8_2d vs plain (tolerance: equal bit for bit, one rounded product)")
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
    print("[2i] probe_copy_2d vs plain (tolerance: equal bit for bit)")
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
    bits = x.view(-1).view(torch.int32)
    bits[1], bits[2], bits[300] = 0x7FC00123, -(2 ** 31), -1     # a NaN's payload, -0.0, a NaN
    bits[-1] = -(2 ** 31)
    out, ref = pb.probe_copy_2d(x), pb.probe_copy_2d_plain(x)
    torch.cuda.synchronize()
    check(torch.equal(_bits(out), _bits(ref)), "probe_copy_2d differs at the largest bucket")
    del out, ref
    # the probe, x.clone() and the plain version's empty_like + copy_, in turns
    copies = {"probe_copy_2d": lambda: pb.probe_copy_2d(x), "x.clone()": lambda: x.clone(),
              "empty_like + copy_": lambda: pb.probe_copy_2d_plain(x)}
    times = interleaved_ms(copies, reps=21)
    ms, lib = statistics.median(times["probe_copy_2d"]), statistics.median(times["x.clone()"])
    plain_ms = statistics.median(times["empty_like + copy_"])
    nbytes = R_main * 256 * 4 * 2
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  edge R=64 and R=1 (with NaN and -0.0): equal; largest stablelm-3b bucket R={R_main} "
          f"(with NaNs and -0.0): equal, "
          f"kernel {ms:.3f} ms ({nbytes / ms / 1e6:.0f} GB/s), bound {bound_ms:.3f} ms (bytes)")
    spread = {}
    for name, ts in times.items():
        q1, _, q3 = statistics.quantiles(ts, n=4)
        spread[name] = q3 - q1
        print(f"    {name}: median {statistics.median(ts):.4f} ms, interquartile spread {q3 - q1:.4f} "
              f"ms, range {min(ts):.4f}-{max(ts):.4f} ms (21 repeats in turns, behind a stream spin)")
    gap = ms - lib
    print(f"    probe - x.clone(): {gap:+.4f} ms; "
          + ("slower beyond the spread" if gap > max(spread["probe_copy_2d"], spread["x.clone()"])
             else "within the spread"))
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
        trace.reset_counts()
        rc = kb.main(["--calibrate", "--elements", str(elements), "--out", f"{tmp}/big.json",
                      "--check", str(H100_TABLE)])
        counts = trace.counts("launch")
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
    trace.reset_counts()
    tl = timeline.measure(api, cfg, batch, repeats=2)
    counts = trace.counts("launch")
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
        trace.reset_counts()
        out = sync_grads_per_rank(grads, world, comm)
        torch.cuda.synchronize()
        err = max(float((out[r][key].double() - expect[key]).abs().max())
                  for r in range(K) for key in ("a", "b"))
        print(f"  {compression}/{'hier' if hier else 'flat'}: max abs err {err:.3e} "
              f"(tolerance {tol[compression]}), launches {dict(trace.counts('launch'))}")
        check(err <= tol[compression], f"grad sync {compression} out of tolerance")
        del out


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer through its entry point
# ---------------------------------------------------------------------------

def trainer_args(compression: str, steps: int, layers: int, extra=(),
                 arch: str = "stablelm-3b") -> list:
    return ["--arch", arch, "--shape", "train_4k", "--batch", "1",
            "--steps", str(steps), "--comm-mode", "explicit", "--compression", compression,
            "--log-every", "1", "--layers", str(layers), *extra]


def run_trainer_with(fn) -> tuple:
    """``fn()``'s trainer result and the kernel launches it made, counted
    from 0, and its peak device memory."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trace.reset_counts()
    result = fn()
    counts = trace.counts("launch") + trace.counts("route")
    torch.cuda.synchronize()
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return result, counts


def run_trainer(argv: list) -> tuple:
    return run_trainer_with(lambda: train.main(argv))


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
    trace.reset_counts()
    result = serve.main(argv)
    counts = trace.counts("launch") + trace.counts("route")
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
    with torch.inference_mode():
        logits, _ = api.prefill(params, serve.prompt_batch(cfg, B, P, 0, DEV))
    return logits[:, -1].float().cpu()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


SERVE_B, SERVE_P, SERVE_G = 4, 4096, 32
VLM_PREFIX = get_config("internvl2-2b").prefix_embeds          # 256 patch embeddings


def phase_serve(tag: str, arch: str, expect: dict, other_orders: list, layers: int = 0,
                P: int = SERVE_P, exact: bool = False, why: str = "") -> tuple:
    """Serve ``arch`` through ``serve.main`` (``layers`` cuts the depth, for
    the reason ``why``); ``expect`` holds the launches of each kernel of the
    path, every other kernel must stay at 0; ``other_orders`` are config
    overrides that give the plain path another summation order.  With
    ``exact`` (no kernel on the path) the kernel and plain runs must agree
    bit for bit.  Returns the launch counts and the kernel run's result."""
    B, G = SERVE_B, SERVE_G
    cfg = get_config(arch)
    depth = (f"full depth ({cfg.num_layers} layers)" if not layers
             else f"{layers} of {cfg.num_layers} layers ({why})")
    front = (f" behind {cfg.prefix_embeds} prefix embeddings" if cfg.family == "vlm" else
             f", {cfg.encoder_seq} frames" if cfg.family == "encdec" else "")
    print(f"[{tag}] serving {arch} at full width (d_model {cfg.d_model}, bf16), {depth}: batch {B}, "
          f"prompt {P}{front}, {G} generated tokens")
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
    if exact:
        print(f"  prefill logits, kernel run vs plain run: max abs "
              f"{float((logits - want).abs().max()):.3e} (tolerance: equal bit for bit, no kernel "
              f"on the path)")
        check(torch.equal(logits, want), f"{arch}: the two runs differ with no kernel on the path")
        return counts, res
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
    return counts, res


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
        trace.reset_counts()
        res = whatif.main(["--model", name, "--batch", str(CNN_BATCH), "--repeats", "5",
                           "--warmup", "2"])
        check(all(c == 0 for c in trace.counts("launch").values()),
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
    trace.reset_counts()
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    counts = trace.counts("launch")
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


# ---------------------------------------------------------------------------
# phase 22: the trainer over torch.distributed (NCCL), the grad sync against
# the in-process world, torchrun as a user starts it, and checkpoints
# ---------------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def rank_env():
    """The environment torchrun gives the one rank of a world of one (one
    process holds one rank), restored after."""
    env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_nccl_trainer(layers: int, phase4: dict) -> None:
    steps = 5
    t_phase = time.perf_counter()
    print(f"[22a] the int8 trainer of phase 4 over NCCL, in this process: RANK 0 of WORLD_SIZE 1, "
          f"{layers} layers, {steps} steps")
    with rank_env():
        result, counts = run_trainer(trainer_args("int8", steps, layers))
    losses, ref = result["losses"], phase4["result"]["losses"]
    check(result["world"] == 1 and result["backend"] == "nccl",
          f"expected world 1 on nccl, got {result['world']} on {result['backend']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    print(f"  losses {losses}; phase 4 {ref}: largest rel diff {rel:.3e} (limit 1e-5), "
          f"{'bitwise equal' if losses == ref else 'not bitwise equal'}")
    check(rel <= 1e-5, "the NCCL trainer's losses differ from phase 4's")
    codec = ("quantize_int8_2d", "dequantize_int8_2d", "fused_add_2d", "flash_attention")
    print(f"  launches {counts}")
    for name in codec:
        check(counts[name] == phase4["counts"][name],
              f"{name}: {counts[name]} launches over NCCL, {phase4['counts'][name]} in phase 4")
    check(counts["quantize_int8_2d"] == phase4["buckets"] * steps, "one encode per bucket and step")
    r4 = phase4["result"]
    print(f"  median step {result['median_step_s']:.4f} s, {result['tokens_per_s']:.1f} tokens/s "
          f"(phase 4, in-process: {r4['median_step_s']:.4f} s, {r4['tokens_per_s']:.1f} tokens/s); "
          f"peak memory {result['peak_gib']:.1f} GiB; phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_nccl_turns(layers: int = 32, steps: int = 5) -> None:
    """Not part of the run: the int8 trainer in process and over NCCL in
    turns (in-process, NCCL, NCCL, in-process) in one call, the comparison
    that tells a difference from the spread between calls."""
    print(f"[22t] the int8 trainer, {layers} layers, {steps} steps, in turns: in-process, NCCL, "
          f"NCCL, in-process")
    for label in ("in-process", "nccl", "nccl", "in-process"):
        with rank_env() if label == "nccl" else contextlib.nullcontext():
            result, _ = run_trainer(trainer_args("int8", steps, layers))
        print(f"  {label:<10}: median step {result['median_step_s']:.4f} s "
              f"({result['tokens_per_s']:.1f} tokens/s), {result['backend']}")


def phase_nccl_sync() -> None:
    t_phase = time.perf_counter()
    cfg = get_config("stablelm-3b")
    shapes = get_model(cfg).init(None, device="meta")
    gen = torch.Generator(device=DEV).manual_seed(22)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=DEV, dtype=p.dtype),
                     shapes)
    plan, _ = make_plan(grads, 64.0)
    largest = max(plan.bucket_sizes)
    print(f"[22b] sync_grads alone: stablelm-3b full width, random bf16 gradients, {plan.n_buckets} "
          f"buckets (largest {largest:,} f32 = {largest * 4 / 1e9:.2f} GB), in-process world of 1 "
          f"against NCCL world of 1; CUDA events behind a stream spin, median of 5")
    check(plan.n_buckets == 11 and largest == cfg.num_layers * cfg.d_model * cfg.d_ff,
          "not phase 4's bucket plan")
    with rank_env():
        dist.init_process_group("nccl", device_id=DEV)
        try:
            worlds = {"in-process": InProcessWorld(1), "nccl": DistributedWorld()}
            for compression in ("none", "int8"):
                comm = CommConfig(mode="explicit", compression=compression)
                for label, world in worlds.items():
                    ms = time_device_ms(lambda: sync_grads(grads, world, comm), reps=5)
                    print(f"  {compression:<4} {label:<10}: {ms:8.3f} ms a sync")
            q, s_, n = ops.quantize_int8(torch.randn(largest, generator=gen, device=DEV))
            nbytes = q.numel() * q.element_size() + s_.numel() * s_.element_size()
            bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
            for label, world in worlds.items():
                ms = time_device_ms(lambda: (world.all_gather([q]), world.all_gather([s_])), reps=5)
                print(f"  all_gather of the largest bucket's int8 codes {q.numel() * q.element_size():,} B "
                      f"+ scales {s_.numel() * s_.element_size():,} B, {label:<10}: {ms:.4f} ms "
                      f"(copy bound {bound:.4f} ms: {nbytes:,} B read and written at 3.35 TB/s)")
            got = worlds["nccl"].all_gather([q])[0]
            check(torch.equal(got[0], q), "the NCCL gather of one rank is not a copy")
        finally:
            dist.destroy_process_group()
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")


def phase_torchrun_checkpoint() -> None:
    t_phase = time.perf_counter()
    n = torch.cuda.device_count()
    layers, steps = 2, 3
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    argv = ["--arch", "stablelm-3b", "--shape", "train_4k", "--batch", str(n), "--layers",
            str(layers), "--steps", str(steps), "--comm-mode", "explicit", "--compression", "int8",
            "--ckpt-dir", str(tmp / "run"), "--ckpt-every", "2", "--log-every", "1"]
    print(f"[22c] python -m torch.distributed.run --standalone --nproc_per_node {n} "
          f"-m repro_torch.launch.train {' '.join(argv)}")
    try:
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                            "MASTER_ADDR", "MASTER_PORT")}
        env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO / "src"), env.get("PYTHONPATH")) if p)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", str(n), "-m", "repro_torch.launch.train", *argv],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        print("  " + "\n  ".join(l for l in proc.stdout.strip().splitlines() if l.startswith(("[train]", "  step"))))
        check(proc.returncode == 0, f"torchrun exited {proc.returncode}:\n{proc.stdout[-3000:]}"
              f"{proc.stderr[-3000:]}")
        print(f"  exit 0 in {time.perf_counter() - t0:.1f} s (wall, {n} process(es) and the launcher)")

        cfg = get_config("stablelm-3b").replace(num_layers=layers)
        params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(1))
        template = {"params": params, "opt": get_optimizer("adamw").init(params)}
        manifest = json.loads((tmp / "run" / "step_00000002" / "manifest.json").read_text())
        check(store.latest_step(tmp / "run") == 2, "torchrun wrote no step 2")
        t0 = time.perf_counter()
        state = store.restore(tmp / "run", template, step=2)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        leaves = tree_leaves(state)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        check(list(manifest["leaves"]) == store.leaf_names(template), "leaf names differ")
        for (name, ent), t in zip(manifest["leaves"].items(), leaves):
            dtype = str(t.dtype).replace("torch.", "")
            check(ent["shape"] == list(t.shape) and ent["dtype"] == dtype and t.device == DEV,
                  f"{name}: manifest {ent} against {tuple(t.shape)} {dtype} on {t.device}")
        check(int(state["opt"].count) == 3, "step 2's checkpoint holds no count of 3")
        print(f"  restored step_00000002 ({len(leaves)} leaves, {nbytes / 1e9:.3f} GB) into a "
              f"{layers}-layer template on the card in {t_restore:.2f} s; names, shapes, dtypes "
              f"as the manifest")
        shutil.rmtree(tmp / "run")

        t0 = time.perf_counter()
        store.save(tmp / "trip", state, 7)
        t_save = time.perf_counter() - t0
        blank = tree_map(torch.zeros_like, state)
        t0 = time.perf_counter()
        back = store.restore(tmp / "trip", blank)
        torch.cuda.synchronize()
        t_back = time.perf_counter() - t0
        for a, b in zip(tree_leaves(back), leaves):
            check(a.dtype == b.dtype and torch.equal(_bits(a) if a.is_floating_point() else a,
                                                     _bits(b) if b.is_floating_point() else b),
                  "a leaf did not come back bit for bit")
        print(f"  round trip of that live state: save {t_save:.2f} s, restore {t_back:.2f} s "
              f"({nbytes / 1e9:.3f} GB; host-bound), bit for bit; phase wall "
              f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 24-30: the remaining model families (the MoE trainer; serving MoE,
# MLA, the large dense decoders, the VLM prefix and Whisper)
# ---------------------------------------------------------------------------

def sync_reading(arch: str, layers: int = 0) -> dict:
    """``sync_grads`` alone, int8, in-process world of one, on random bf16
    gradients of ``arch``'s full-width tree (CUDA events behind a stream
    spin, median of 5): ms, the gradient's bf16 bytes, the f32 bucket bytes
    and the int8 wire bytes (codes and scales) of a step."""
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    gen = torch.Generator(device=DEV).manual_seed(24)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=DEV, dtype=p.dtype),
                     get_model(cfg).init(None, device="meta"))
    plan, _ = make_plan(grads, 64.0)
    comm = CommConfig(mode="explicit", compression="int8")
    ms = time_device_ms(lambda: sync_grads(grads, InProcessWorld(1), comm), reps=5)
    n = sum(t.numel() for t in tree_leaves(grads))
    rows = sum(-(-size // (256 * 64)) * 64 for size in plan.bucket_sizes)   # padded to 64-row tiles
    out = {"ms": ms, "params": n, "grad_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(grads)),
           "bucket_bytes": 4 * sum(plan.bucket_sizes), "wire_bytes": rows * 256 + rows * 4,
           "buckets": plan.n_buckets}
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


MOE_ARCH = "moonshot-v1-16b-a3b"


def phase_moe_trainer(phase4: dict) -> dict:
    """The MoE trainer: ``launch.train.main`` on moonshot-v1-16b-a3b at full
    width, 1 dense + 3 MoE layers, int8, against a plain run; then the
    communication share beside stablelm-3b's."""
    steps, layers = 3, 4
    cfg = get_config(MOE_ARCH)
    cfg_run = cfg.replace(num_layers=layers)
    t_phase = time.perf_counter()
    print(f"[24] the MoE trainer: {MOE_ARCH} full width (d_model {cfg.d_model}, {cfg.num_heads} heads "
          f"of {cfg.head_dim}, {cfg.moe.num_experts} experts top-{cfg.moe.top_k} of d_ff "
          f"{cfg.moe.d_ff_expert} + {cfg.moe.num_shared_experts} shared, vocab {cfg.padded_vocab}, "
          f"bf16, remat), {layers} of {cfg.num_layers} layers (1 dense + {layers - 1} MoE; the "
          f"48-layer AdamW state would be about 450 GB), S = 4096, batch 1, explicit comm, int8, "
          f"AdamW, {steps} steps")
    result, counts = run_trainer(trainer_args("int8", steps, layers, arch=MOE_ARCH))
    losses = result["losses"]
    plan, _ = make_plan(get_model(cfg_run).init(None, device="meta"), 64.0)
    print(f"  losses {losses}; median step {result['median_step_s']:.4f} s, "
          f"{result['tokens_per_s']:.1f} tokens/s, first step {result['compile_s']:.3f} s, peak "
          f"memory {result['peak_gib']:.1f} GiB; {plan.n_buckets} buckets; launches {counts}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), "a loss is not finite")
    # xent at a uniform guess is ln 163840 = 12.006; the three MoE layers add
    # their load-balance and router-z losses (about 0.03 each at init)
    check(11.6 <= losses[0] <= 12.6, f"step-0 loss {losses[0]} outside [11.6, 12.6]")
    check(counts["flash_attention"] == layers * steps * 2,
          f"expected {layers * steps * 2} flash launches (forward and remat recompute)")
    for name in ("quantize_int8_2d", "dequantize_int8_2d", "fused_add_2d"):
        check(counts[name] == plan.n_buckets * steps,
              f"expected one {name} per bucket and step ({plan.n_buckets} x {steps})")
    off = [name for name, c in counts.items()
           if c and name not in ("flash_attention", "quantize_int8_2d", "dequantize_int8_2d",
                                 "fused_add_2d")]
    check(not off, f"the MoE trainer launched kernels off its path: {off}")

    print("  the same seed on the plain versions (use_pallas=never), 2 steps")
    ref, ref_counts = run_trainer(trainer_args("int8", 2, layers, ["--use-pallas", "never"],
                                               arch=MOE_ARCH))
    check(all(c == 0 for c in ref_counts.values()), "the plain run launched a kernel")
    for i in range(2):
        rel = abs(losses[i] - ref["losses"][i]) / abs(ref["losses"][i])
        print(f"  step {i}: kernels {losses[i]:.5f} vs plain {ref['losses'][i]:.5f} (rel diff {rel:.2e}, "
              f"tolerance 2e-2: bf16 model)")
        check(rel <= 2e-2, "kernel and plain MoE trainer disagree")
    print(f"  plain run: median step {ref['median_step_s']:.4f} s")

    moe, dense = sync_reading(MOE_ARCH, layers), sync_reading("stablelm-3b")
    r4 = phase4["result"]
    for label, rd, step in ((f"{MOE_ARCH}, {layers} layers", moe, result["median_step_s"]),
                            ("stablelm-3b, 32 layers (phase 4)", dense, r4["median_step_s"])):
        print(f"  {label}: {rd['params'] / 1e9:.3f} B parameters, gradient {rd['grad_bytes'] / 1e9:.3f} GB "
              f"bf16 a step ({rd['buckets']} buckets, {rd['bucket_bytes'] / 1e9:.3f} GB f32, int8 wire "
              f"{rd['wire_bytes'] / 1e9:.3f} GB); sync_grads int8 alone {rd['ms']:.3f} ms of a "
              f"{step:.4f} s step = {100 * rd['ms'] / 1e3 / step:.2f} % of it")
    print(f"  tokens a step 4096 each; gradient bytes a token: {MOE_ARCH} {moe['grad_bytes'] / 4096 / 1e6:.3f} "
          f"MB, stablelm-3b {dense['grad_bytes'] / 4096 / 1e6:.3f} MB; phase wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"result": result, "counts": counts, "sync": moe, "sync_dense": dense}


def phase_families() -> dict:
    """Phases 25-30: the new families served through ``serve.main`` at full
    width; each cut in depth only where one card cannot hold it."""
    out = {}
    # full depth: 52.9 GiB of bf16 weights, the kernel run's peak under 75 GiB
    out["moe"], res = phase_serve("25", MOE_ARCH, {"flash_attention": get_config(MOE_ARCH).num_layers},
                                  [{"attn_chunk": 512}])
    peaks = {MOE_ARCH: res["peak_gib"]}

    ds = get_config("deepseek-v2-236b")
    ds_layers = 4
    counts, res = phase_serve("26", "deepseek-v2-236b", {}, [], layers=ds_layers, exact=True,
                              why="1 dense + 3 MoE layers: 13.6 B parameters, 25.4 GiB of bf16; "
                                  "the 60 layers are 448 GiB")
    tokens = SERVE_B * (SERVE_P + SERVE_G)
    latent = ds_layers * tokens * (ds.mla_kv_lora + ds.mla_rope_dim) * 2
    gqa = ds_layers * tokens * 2 * ds.num_heads * ds.head_dim * 2
    print(f"  MLA: prefill {res['prefill_s']:.3f} s, decode {res['decode_ms_per_token']:.2f} ms/token; "
          f"latent cache {latent / 2 ** 20:.1f} MiB ({ds.mla_kv_lora} + {ds.mla_rope_dim} bf16 a token "
          f"and layer) against {gqa / 2 ** 20:.1f} MiB for K/V of {ds.num_heads} heads of {ds.head_dim} "
          f"({gqa / latent:.1f}x)")
    out["mla"] = counts
    peaks["deepseek-v2-236b"] = res["peak_gib"]

    out["arctic"], res = phase_serve("27", "arctic-480b", {"flash_attention": 2}, [{"attn_chunk": 512}],
                                   layers=2, why="128 experts of d_ff 4864 a layer: 2 layers are 27.7 B "
                                                 "parameters, 51.6 GiB of bf16")
    peaks["arctic-480b"] = res["peak_gib"]
    for tag, arch in (("28a", "command-r-35b"), ("28b", "deepseek-coder-33b")):
        n = get_config(arch).num_layers
        out[arch], res = phase_serve(tag, arch, {"flash_attention": n}, [{"attn_chunk": 512}])
        peaks[arch] = res["peak_gib"]
    vlm = get_config("internvl2-2b")
    # S = 256 + 4096 = 4352: a multiple of 128 (the kernel's condition), not of
    # 512 or 1024, where the plain path takes one block; 256 divides it
    out["vlm"], res = phase_serve("29", "internvl2-2b", {"flash_attention": vlm.num_layers},
                                  [{"attn_chunk": 256}])
    peaks["internvl2-2b"] = res["peak_gib"]
    wh = get_config("whisper-base")
    # prompt 384: a multiple of 128 inside Whisper's 448-token text context
    out["encdec"], res = phase_serve("30", "whisper-base", {"flash_attention": wh.num_layers},
                                     [{"attn_chunk": 128}, {"attn_chunk": 500}], P=384)
    peaks["whisper-base"] = res["peak_gib"]
    print("  kernel runs' peak device memory, GiB: " + ", ".join(f"{a} {g:.1f}" for a, g in peaks.items()))
    check(max(peaks.values()) <= 75.0, "a served model passed 75 GiB: cut its depth")
    return out

# ---------------------------------------------------------------------------
# phases 31-36: the specs' step on the card, the dry run, the trainers the
# card had not run, MLA's backward
# ---------------------------------------------------------------------------

SPEC_STEPS, SPEC_PLAIN_STEPS = 3, 2


def spec_step_run(cfg, shape: InputShape, mesh, batches: list, steps: int) -> dict:
    """``specs.make_step_fn(api, "train", opt)`` for ``steps`` steps on
    DTensors of the one-rank mesh, from the specs' placements of seed-0
    parameters (phase 4's seed)."""
    api = get_model(cfg)
    opt = get_optimizer("adamw")
    spec = specs_lib.train_step_spec(api, shape, mesh, opt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    plain = api.init(torch.Generator(device=DEV).manual_seed(0))
    params = specs_lib.distribute(plain, spec.in_shardings[0], mesh)
    state = specs_lib.distribute(opt.init(plain), spec.in_shardings[1], mesh)
    del plain
    step = specs_lib.make_step_fn(api, "train", opt)
    losses, times = [], []
    trace.reset_counts()
    for i in range(steps):
        batch = specs_lib.distribute(batches[i], spec.in_shardings[2], mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"].full_tensor()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = trace.counts("launch") + trace.counts("route")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, state
    return {"losses": losses, "times": times, "counts": counts, "peak_gib": peak}


def phase_specs_step(phase4: dict, card: str) -> dict:
    """[31] ``launch/specs.make_step_fn`` on DTensors of a one-rank NCCL mesh:
    stablelm-3b at full width and depth, S 4096, batch 1, on the kernels and
    on the plain versions; beside it the roofline terms of the same step from
    ``utils/step_analysis`` (the dry run's trace on meta shards)."""
    cfg = get_config("stablelm-3b")
    shape = InputShape("train_4k", 4096, 1, "train")
    t_phase = time.perf_counter()
    print(f"[31] the specs' train step on the card: stablelm-3b full width and depth "
          f"({cfg.num_layers} layers), S {shape.seq_len}, batch 1, AdamW, DTensors on a one-rank "
          f"NCCL DeviceMesh (make_smoke_mesh('cuda')); {SPEC_STEPS} steps on the kernels, "
          f"{SPEC_PLAIN_STEPS} on use_pallas=never")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=DEV)
    try:
        mesh = make_smoke_mesh("cuda")
        data = iter(SyntheticLM(cfg, shape, seed=0))
        batches = [device_put_batch(next(data), DEV) for _ in range(SPEC_STEPS)]
        kern = spec_step_run(cfg, shape, mesh, batches, SPEC_STEPS)
        plain = spec_step_run(cfg.replace(use_pallas="never"), shape, mesh, batches,
                              SPEC_PLAIN_STEPS)
        seq = spec_step_run(cfg.replace(seq_parallel="data"), shape, mesh, batches, 1)
        t0 = time.perf_counter()
        rec = dryrun.dryrun_cfg(cfg, shape, mesh)
        trace_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    print(f"  kernels: losses {kern['losses']}, step times {[round(t, 4) for t in kern['times']]} s, "
          f"peak {kern['peak_gib']:.1f} GiB; launches {kern['counts']}")
    print(f"  plain:   losses {plain['losses']}, step times {[round(t, 4) for t in plain['times']]} s, "
          f"peak {plain['peak_gib']:.1f} GiB")
    check(all(math.isfinite(x) for x in kern["losses"] + plain["losses"]), "a loss is not finite")
    for i in range(SPEC_PLAIN_STEPS):
        rel = abs(kern["losses"][i] - plain["losses"][i]) / abs(plain["losses"][i])
        print(f"  step {i}: kernels {kern['losses'][i]:.5f} vs plain {plain['losses'][i]:.5f} "
              f"(rel diff {rel:.2e}, tolerance 2e-2: bf16 model)")
        check(rel <= 2e-2, "the specs' step on the kernels and on the plain versions disagree")
    rel = abs(seq["losses"][0] - kern["losses"][0]) / abs(kern["losses"][0])
    print(f"  seq_parallel=\"data\" (the residual stream held with S over `model`, a rank of one "
          f"here): step-0 loss {seq['losses'][0]:.6f} vs {kern['losses'][0]:.6f} (rel diff "
          f"{rel:.2e}, tolerance 1e-6: the same arithmetic on one rank), step "
          f"{seq['times'][0]:.3f} s, peak {seq['peak_gib']:.1f} GiB")
    check(rel <= 1e-6, "the specs' step under seq_parallel gives another loss")
    want = cfg.num_layers * SPEC_STEPS * 2
    check(kern["counts"]["flash_attention"] == want,
          f"expected {want} flash launches (layers x steps x 2: forward and remat recompute)")
    check(all(c == 0 for c in plain["counts"].values()), "the plain run launched a kernel")
    off = [n for n, c in kern["counts"].items() if c and n != "flash_attention"]
    check(not off, f"the specs' step launched kernels off its path: {off}")
    step_s = statistics.median(kern["times"][1:])
    tokens = shape.global_batch * shape.seq_len
    ana = rec["analyzed"]
    compute_s, memory_s = ana["flops"] / PEAK_FLOPS_BF16, ana["bytes"] / MESH_HBM_BW
    mfu = flops.model_flops(cfg, shape) / step_s / PEAK_FLOPS_BF16
    r4 = phase4["result"]
    print(f"  median step {step_s:.4f} s (steps 1-{SPEC_STEPS - 1}), {tokens / step_s:.1f} tokens/s, "
          f"first step {kern['times'][0]:.3f} s, peak {kern['peak_gib']:.1f} GiB; phase 4's trainer "
          f"(plain tensors, int8 sync): {r4['median_step_s']:.4f} s")
    print(f"  roofline of the same step (utils/step_analysis over the plain path, traced in "
          f"{trace_s:.1f} s): {ana['flops']:.4e} FLOPs -> compute {compute_s:.4f} s at "
          f"{PEAK_FLOPS_BF16:.3e} FLOP/s; {ana['bytes']:.4e} bytes -> memory {memory_s:.4f} s at "
          f"{MESH_HBM_BW:.3e} B/s; temp {rec['memory']['temp_size_in_bytes'] / 2 ** 30:.2f} GiB; "
          f"collectives {ana['collective_bytes']}")
    print(f"  {card}: measured {step_s:.4f} s against compute {compute_s:.4f} s and memory "
          f"{memory_s:.4f} s; MFU (6 N T / step / peak) {mfu:.4f}; traced FLOPs over the step "
          f"{ana['flops'] / step_s / 1e12:.1f} TFLOP/s; phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"kern": kern, "plain": plain, "rec": rec, "step_s": step_s, "mfu": mfu}


# (arch, shape, multi_pod, production), the slowest first: one architecture
# of each family on the 16x16 mesh as configured, every shape among them; on
# the 2x16x16 mesh with the production flags, every shape for some of them.
# About 1,000 s of the host's cores: rwkv6's prefill_32k alone takes 175 s
# there, so that shape runs for internvl2-2b and whisper-base only
DRYRUN_ARCHS = ["jamba-v0.1-52b", "rwkv6-1.6b", "deepseek-v2-236b", "moonshot-v1-16b-a3b",
                "stablelm-3b", "whisper-base", "internvl2-2b"]
DRYRUN_JOBS = ([(a, "train_4k", pod, False) for a in DRYRUN_ARCHS for pod in (False, True)]
               + [(a, "train_4k", True, True) for a in ("moonshot-v1-16b-a3b", "stablelm-3b",
                                                        "whisper-base", "internvl2-2b")]
               + [("whisper-base", "prefill_32k", True, True),
                  ("internvl2-2b", "prefill_32k", False, False)]
               + [(a, s, False, False) for a in DRYRUN_ARCHS + ["command-r-35b"]
                  for s in ("decode_32k", "long_500k")]
               + [(a, "decode_32k", True, True) for a in ("stablelm-3b", "moonshot-v1-16b-a3b",
                                                          "jamba-v0.1-52b")]
               + [(a, "long_500k", True, True) for a in ("stablelm-3b", "jamba-v0.1-52b",
                                                         "rwkv6-1.6b")])


def param_bytes_a_device(arch: str, axis_sizes: dict) -> int:
    """``arch``'s bf16 parameter bytes one device holds: each leaf split over
    the mesh axes its spec names."""
    cfg = get_config(arch)
    params = get_model(cfg).init(None, device="meta")
    total = 0
    for path, leaf in zip(tree_paths(params), tree_leaves(params)):
        ways = 1
        for entry in shd.param_specs(params, cfg)[path]:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                ways *= axis_sizes.get(axis, 1) if axis else 1
        total += leaf.numel() * 2 // ways
    return total


def check_pod_halves(recs: list) -> None:
    """Every train_4k traced on both meshes with the same flags: 2x16x16 splits
    the batch of 256 over 32 ranks where 16x16 splits it over 16, so each
    device's FLOPs are 0.45-0.55 of 16x16's; and `pod` carries no all-gather
    larger than the arch's bf16 parameter bytes a device (the weights' gathers
    at most, no activation)."""
    ok = {(r["arch"], r["shape"], r["mesh"], r["production"]): r for r in recs
          if r["status"] == "ok"}
    pairs = [(flat, ok.get((a, s, "2x16x16", p))) for (a, s, m, p), flat in ok.items()
             if s == "train_4k" and m == "16x16"]
    pairs = [(f, q) for f, q in pairs if q is not None]
    check(len(pairs) >= len(DRYRUN_ARCHS), f"expected train_4k on both meshes for every arch, "
                                           f"got {len(pairs)} pairs")
    print("  train_4k on both meshes: FLOPs a device 2x16x16 / 16x16 (0.45-0.55), the largest "
          "all-gather over `pod` against the bf16 parameter bytes a device")
    bad = []
    for flat, pod in pairs:
        ratio = pod["analyzed"]["flops"] / flat["analyzed"]["flops"]
        pod_ag = pod["analyzed"]["collective_bytes_by_axis"].get("pod", {}).get("all-gather", 0.0)
        limit = param_bytes_a_device(pod["arch"], {"pod": 2, "data": 16, "model": 16})
        print(f"  {pod['arch']}{' (production)' if pod['production'] else ''}: "
              f"{flat['analyzed']['flops']:.4e} -> {pod['analyzed']['flops']:.4e} FLOPs "
              f"(ratio {ratio:.4f}); pod all-gather {pod_ag:.4e} B against {limit:.4e} B; by "
              f"axis {pod['analyzed']['collective_bytes_by_axis']}")
        if not 0.45 <= ratio <= 0.55:
            bad.append(f"{pod['arch']} train_4k: 2x16x16 / 16x16 FLOPs {ratio:.3f}")
        if pod_ag > limit:
            bad.append(f"{pod['arch']} train_4k gathers {pod_ag:.3e} B over `pod`, above its "
                       f"{limit:.3e} B of bf16 parameters a device")
    check(not bad, "; ".join(bad))


DRYRUN_RECORD = REPO / "artifacts" / "dryrun" / "torch_results.json"


# long_500k on 16x16 as the committed record held it before the lowering
# that splits a batch of one's products over `data` (``layers.project``):
# per device, (FLOPs, `data` collective bytes), every layer and shape as
# configured; each `data` rank ran the whole step, and the fsdp models
# gathered their weights over `data` first
PARENT_LONG_500K = {"stablelm-3b": (3.385754e8, 2.0992e4), "moonshot-v1-16b-a3b": (3.525041e9, 2.4960e4),
                    "internvl2-2b": (2.156134e8, 1.99680e5), "command-r-35b": (2.852782e9, 3.033190e9),
                    "deepseek-v2-236b": (3.063829e10, 3.044186e10), "rwkv6-1.6b": (1.697788e9, 0.0),
                    "jamba-v0.1-52b": (6.167267e9, 6.025553e9)}


def print_long_context(recs: list) -> None:
    """One line: each ``PARENT_LONG_500K`` architecture's long_500k FLOPs and
    `data` collective bytes a device on 16x16, from this run, beside the
    record before the repair."""
    got = {r["arch"]: r for r in recs if r["status"] == "ok" and r["shape"] == "long_500k"
           and r["mesh"] == "16x16" and not r["production"]}
    check(set(PARENT_LONG_500K) <= set(got), f"long_500k rows missing: "
                                             f"{sorted(set(PARENT_LONG_500K) - set(got))}")
    line = {a: {"flops": got[a]["analyzed"]["flops"],
                "data_bytes": sum(got[a]["analyzed"]["collective_bytes_by_axis"].get("data", {})
                                  .values()),
                "parent_flops": f, "parent_data_bytes": b}
            for a, (f, b) in PARENT_LONG_500K.items()}
    print("  long_500k a device on 16x16, this run beside the parent's record: " + json.dumps(line))


def check_against_record(recs: list) -> None:
    """Each combination's counts under this torch release against the
    committed ``artifacts/dryrun/torch_results.json`` (written by ``python -m
    repro_torch.launch.dryrun --all --both-meshes`` with and without
    ``--production``, on a CPU under another release): FLOPs and collective
    bytes by kind and mesh axis must be equal.  The dry run places the
    residual stream, the attention, the recurrences, the Mamba mixer's
    products, the MoE experts and auxiliary means, the loss and the decode
    attention itself (``sharding.constrain_rows``, ``on_shards``), so that
    no count follows DTensor's per-op choices, which differ by release."""
    record = {(r["arch"], r["shape"], r["mesh"], r["production"]): r
              for r in json.loads(DRYRUN_RECORD.read_text()) if r["status"] == "ok"}
    print(f"  against the committed record ({DRYRUN_RECORD.relative_to(REPO)}, "
          f"{len(record)} combinations): FLOPs and collective bytes by kind and axis")
    bad = []
    for r in recs:
        if r["status"] != "ok":
            continue
        want = record.get((r["arch"], r["shape"], r["mesh"], r["production"]))
        if want is None:
            bad.append(f"{r['arch']} {r['shape']} {r['mesh']}: not in the record")
            continue
        got_ax, want_ax = (x["analyzed"]["collective_bytes_by_axis"] for x in (r, want))
        same = (r["analyzed"]["flops"] == want["analyzed"]["flops"] and got_ax == want_ax)
        print(f"  {r['arch']} | {r['shape']} | {r['mesh']} | {r['production']} | "
              f"{'equal' if same else 'DIFFERS'}: FLOPs {r['analyzed']['flops']:.6e} (record "
              f"{want['analyzed']['flops']:.6e})" + ("" if same else
                                                      f"; by axis {got_ax} (record {want_ax})"))
        if not same:
            bad.append(f"{r['arch']} {r['shape']} {r['mesh']} production={r['production']}")
    check(not bad, f"dry-run counts differ from the committed record: {bad}")


def phase_dryrun(parallel: int = 8) -> list:
    """[32] ``python -m repro_torch.launch.dryrun`` in subprocesses, ``parallel``
    at a time on the host's cores: every job's exit 0 and no FAIL row, then
    each combination's per-device numbers and ``benchmarks/torch_roofline.py``'s
    table."""
    print(f"[32] the dry run: python -m repro_torch.launch.dryrun, {len(DRYRUN_JOBS)} combinations "
          f"of {len(DRYRUN_ARCHS)} architectures (one of each family), {parallel} processes at a "
          f"time on the host's {os.cpu_count()} cores; each opens its own fake process group of "
          f"256 or 512 ranks and traces the step on meta shards")
    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "CUDA_VISIBLE_DEVICES": "",
           "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    pending = list(enumerate(DRYRUN_JOBS))
    running, failed = [], []
    try:
        while pending or running:
            while pending and len(running) < parallel:
                i, (arch, shape, pod, prod) = pending.pop(0)
                argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--out", str(out_dir / f"job{i:02d}.json")]
                argv += ["--multi-pod"] if pod else []
                argv += ["--production"] if prod else []
                log = open(out_dir / f"job{i:02d}.log", "w")
                running.append((i, subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                                    stderr=subprocess.STDOUT), log))
            time.sleep(0.5)
            for job in [j for j in running if j[1].poll() is not None]:
                running.remove(job)
                job[2].close()
                if job[1].returncode != 0:
                    failed.append(job[0])
                    print((out_dir / f"job{job[0]:02d}.log").read_text()[-3000:])
    finally:
        for _, proc, log in running:
            proc.kill()
            proc.wait()
            log.close()
    check(not failed, f"dry-run jobs exited non-zero: {[DRYRUN_JOBS[i] for i in failed]}")
    recs = []
    for i in range(len(DRYRUN_JOBS)):
        recs += json.loads((out_dir / f"job{i:02d}.json").read_text())
    merged = out_dir / "torch_results.json"
    merged.write_text(json.dumps(recs, indent=1))
    bad = [(r["arch"], r["shape"], r["mesh"]) for r in recs if r["status"] == "FAIL"]
    check(not bad, f"dry-run rows FAIL: {bad}")
    print("  arch | shape | mesh | production | per device: FLOPs | collective bytes by kind | "
          "temp GiB | trace s")
    for r in recs:
        if r["status"] != "ok":
            print(f"  {r['arch']} | {r['shape']} | {r['mesh']} | {r['production']} | {r['status']}: "
                  f"{r['note']}")
            continue
        coll = {k: f"{v:.4e}" for k, v in sorted(r["analyzed"]["collective_bytes"].items())}
        print(f"  {r['arch']} | {r['shape']} | {r['mesh']} | {r['production']} | "
              f"{r['analyzed']['flops']:.4e} | {coll} | "
              f"{r['memory']['temp_size_in_bytes'] / 2 ** 30:.3f} | {r['trace_s']}")
    check(any(r["status"] == "skipped" for r in recs), "whisper-base x long_500k must be skipped")
    check_pod_halves(recs)
    check_against_record(recs)
    print_long_context(recs)
    rows = roofline.load_table(merged)
    print(roofline.to_markdown(rows), end="")
    print(f"  {len(recs)} combinations, no FAIL; phase wall {time.perf_counter() - t_phase:.1f} s "
          f"(host, not the card)")
    shutil.rmtree(out_dir, ignore_errors=True)
    return recs


def phase_remat_dots(phase4: dict, layers: int = 32, steps: int = 5) -> dict:
    """[38] ``remat_policy="dots"`` against "full": stablelm-3b at full width
    and depth, S 4096, batch 1, int8, ``launch.train.main`` for ``steps``
    steps under "dots", held to phase 4's run of the same arguments under the
    config's "full".  "dots" saves the projections' outputs (q, k, v, o,
    gate, up, down: 26,560 bf16 columns x 4096 tokens a layer) and recomputes
    the attention, the flash kernel among it; the products saved are the
    values the recompute would make, so the losses agree to rounding."""
    print(f"[38] remat_policy: stablelm-3b full width, {layers} layers, S 4096, batch 1, int8, "
          f"{steps} steps through launch.train.main under \"dots\", against phase 4's \"full\"")
    dots, counts = run_trainer(trainer_args("int8", steps, layers, ["--remat-policy", "dots"]))
    full, full_counts = phase4["result"], phase4["counts"]
    for policy, res, c in (("full", full, full_counts), ("dots", dots, counts)):
        print(f"  {policy}: median step {res['median_step_s']:.4f} s, {res['tokens_per_s']:.0f} "
              f"tokens/s, peak {res['peak_gib']:.2f} GiB, flash launches "
              f"{c['flash_attention']}, losses {res['losses'][:3]}")
        check(c["flash_attention"] == layers * steps * 2,
              f"expected {layers * steps * 2} flash launches (layers x steps x 2: forward and "
              f"its recompute) under {policy}")
    for i in range(3):
        rel = abs(dots["losses"][i] - full["losses"][i]) / abs(full["losses"][i])
        print(f"  step {i}: dots {dots['losses'][i]:.6f} vs full {full['losses'][i]:.6f} "
              f"(rel diff {rel:.2e}, tolerance 1e-5: the same products, bit-equal on the card "
              f"so far)")
        check(rel <= 1e-5, "remat_policy dots and full disagree")
    print(f"  dots / full: step {dots['median_step_s'] / full['median_step_s']:.4f}, peak "
          f"{dots['peak_gib'] - full['peak_gib']:+.2f} GiB")
    return {"full": (full, full_counts), "dots": (dots, counts)}


NEW_TRAINERS = [
    # tag, arch, layers (0: full depth), why, flash launches a step
    ("33", "deepseek-coder-33b", 4, "4 of 62 layers: 2.58 B parameters, 28.9 GiB of bf16 p and g "
     "and f32 m and v", 4 * 2),
    ("34", "internvl2-2b", 0, "full depth; 256 prefix embeddings ahead of the 4096 tokens, which "
     "the loss drops", 24 * 2),
    ("35", "whisper-base", 0, "full depth; the kernel takes the decoder's causal self-attention "
     "only (6 layers): the encoder's 1500 frames and the cross-attention's 1500 keys are not "
     "multiples of 128", 6 * 2),
]


def phase_new_trainer(tag: str, arch: str, layers: int, why: str, flash_per_step: int) -> dict:
    """[33]-[35] ``launch.train.main``: int8, S 4096, batch 1, 2 steps on the
    kernels against 2 steps on the plain versions."""
    steps = 2
    cfg = get_config(arch)
    depth = layers or cfg.num_layers
    t_phase = time.perf_counter()
    print(f"[{tag}] trainer: {arch} full width (d_model {cfg.d_model}, {cfg.num_heads} heads of "
          f"{cfg.head_dim}, {cfg.num_kv_heads} kv heads, bf16, remat), {depth} layers ({why}), "
          f"S 4096, batch 1, explicit comm, int8, AdamW, {steps} steps")
    result, counts = run_trainer(trainer_args("int8", steps, depth, arch=arch))
    losses = result["losses"]
    plan, _ = make_plan(get_model(cfg.replace(num_layers=depth)).init(None, device="meta"), 64.0)
    print(f"  losses {losses}; median step {result['median_step_s']:.4f} s, first step "
          f"{result['compile_s']:.3f} s, peak memory {result['peak_gib']:.1f} GiB; {plan.n_buckets} "
          f"buckets; launches {counts}")
    check(all(math.isfinite(x) for x in losses), "a loss is not finite")
    check(counts["flash_attention"] == flash_per_step * steps,
          f"expected {flash_per_step * steps} flash launches ({flash_per_step // 2} attention "
          f"layers on the kernel x {steps} steps x 2: forward and remat recompute)")
    for name in ("quantize_int8_2d", "dequantize_int8_2d", "fused_add_2d"):
        check(counts[name] == plan.n_buckets * steps,
              f"expected one {name} per bucket and step ({plan.n_buckets} x {steps})")
    off = [n for n, c in counts.items() if c and n not in
           ("flash_attention", "quantize_int8_2d", "dequantize_int8_2d", "fused_add_2d")]
    check(not off, f"the trainer launched kernels off its path: {off}")
    ref, ref_counts = run_trainer(trainer_args("int8", steps, depth, ["--use-pallas", "never"],
                                               arch=arch))
    check(all(c == 0 for c in ref_counts.values()), "the plain run launched a kernel")
    for i in range(steps):
        rel = abs(losses[i] - ref["losses"][i]) / abs(ref["losses"][i])
        print(f"  step {i}: kernels {losses[i]:.5f} vs plain {ref['losses'][i]:.5f} (rel diff "
              f"{rel:.2e}, tolerance 2e-2: bf16 model)")
        check(rel <= 2e-2, f"kernel and plain {arch} trainer disagree")
    print(f"  plain run: median step {ref['median_step_s']:.4f} s, peak {ref['peak_gib']:.1f} GiB; "
          f"phase wall {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return {"result": result, "counts": counts}


MLA_TOL = 3e-2


def phase_mla_block() -> None:
    """[36] one full-width MLA attention block of deepseek-v2-236b, forward and
    backward in bf16 on the card, against the same block in float64 on the
    card (the attention core, rope and norm compute in float32 inside both,
    as the model code does)."""
    cfg = get_config("deepseek-v2-236b")
    S = 4096
    print(f"[36] MLA on the card: one deepseek-v2-236b attention block (attention.mla_forward) at "
          f"full width: d_model {cfg.d_model}, {cfg.num_heads} heads, d_qk {cfg.head_dim} + "
          f"{cfg.mla_rope_dim} = {cfg.head_dim + cfg.mla_rope_dim}, d_v {cfg.head_dim}, latent "
          f"{cfg.mla_kv_lora}; S {S}, batch 1; forward and backward in bf16 against float64")
    t_phase = time.perf_counter()
    params = attn_lib.init_mla(torch.Generator(device=DEV).manual_seed(0), cfg, 0, device=DEV)
    x = randn(1, S, cfg.d_model, seed=36, dtype=torch.bfloat16)
    g_out = randn(1, S, cfg.d_model, seed=37, dtype=torch.bfloat16)

    def run(dtype):
        p = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
        xx = x.detach().to(dtype).requires_grad_(True)
        out, _ = attn_lib.mla_forward(p, xx, cfg)
        grads = torch.autograd.grad(out, [xx, *p.values()], g_out.to(dtype))
        return [out.detach()] + [g.detach() for g in grads], list(p)

    torch.cuda.reset_peak_memory_stats()
    got, names = run(torch.bfloat16)
    torch.cuda.synchronize()
    peak_bf16 = torch.cuda.max_memory_allocated() / 2 ** 30
    want, _ = run(torch.float64)
    labels = ["output", "d x"] + [f"d {n}" for n in names]
    errs = {lab: rel_l2(a.double(), b) for lab, a, b in zip(labels, got, want)}
    print(f"  relative L2 to float64: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {MLA_TOL}: about ten bf16 roundings of 2^-9 in series)")
    print(f"  peak {peak_bf16:.1f} GiB for the bf16 block, {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} "
          f"GiB with the float64 one; phase wall {time.perf_counter() - t_phase:.1f} s")
    check(all(math.isfinite(v) for v in errs.values()), "an MLA output or gradient is not finite")
    check(max(errs.values()) <= MLA_TOL, f"MLA's bf16 block is off its float64 reference: {errs}")
    del got, want
    torch.cuda.empty_cache()


E2E_CODECS = ("none", "fp16", "int8", "ternary", "topk")
E2E_STEPS = 300
# the codec kernels each codec's sync launches once a bucket and step
E2E_KERNELS = {"none": (), "fp16": (), "int8": ("quantize_int8_2d", "dequantize_int8_2d"),
               "ternary": ("ternarize_2d", "dequantize_int8_2d"), "topk": ("topk_mask_2d",)}


def e2e_sync_ms(codec: str, params) -> float:
    """``sync_grads`` alone on repro-100m's float32 gradient tree, in-process
    world of one (CUDA events behind a stream spin, median of 5)."""
    gen = torch.Generator(device=DEV).manual_seed(37)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen, device=DEV, dtype=p.dtype),
                     params)
    comm = CommConfig(mode="explicit", compression=codec, topk_ratio=0.25)
    return time_device_ms(lambda: sync_grads(grads, InProcessWorld(1), comm), reps=5)


def phase_e2e_codecs(dryrun_recs: list) -> dict:
    """[37] ``examples/torch_train_e2e.main`` on the card: repro-100m (the
    reference's ~100M config, float32), S 256, batch 4, 300 steps under each
    codec; the first 3 steps of none and int8 against ``--use-pallas never``;
    then ``examples/torch_gradient_compression.main``,
    ``examples/torch_serve_batch.main`` and ``benchmarks/torch_run.py`` (a
    subprocess that must exit 0)."""
    from examples import torch_gradient_compression, torch_serve_batch, torch_train_e2e

    t_phase = time.perf_counter()
    cfg = get_config("repro-100m")
    meta = get_model(cfg).init(None, device="meta")
    plan, _ = make_plan(meta, 64.0)
    print(f"[37] codecs over {E2E_STEPS} steps: examples/torch_train_e2e.main, repro-100m ("
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{cfg.num_kv_heads} kv heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, float32, "
          f"{sum(t.numel() for t in tree_leaves(meta)) / 1e6:.1f} M parameters, {plan.n_buckets} "
          f"buckets), S 256, batch 4, explicit comm, AdamW, cosine lr 3e-4; each codec from the "
          f"same seed")
    ckpt = tempfile.mkdtemp(prefix="e2e_ckpt_")
    out = {}
    try:
        for codec in E2E_CODECS:
            argv = ["--steps", str(E2E_STEPS), "--compression", codec, "--ckpt-dir", ckpt,
                    "--ckpt-every", "150", "--log-every", "100", "--topk-ratio", "0.25"]
            res, counts = run_trainer_with(lambda: torch_train_e2e.main(argv))
            losses = res["losses"]
            sync_ms = e2e_sync_ms(codec, meta)
            step_ms = res["median_step_s"] * 1e3
            tail = statistics.mean(losses[-20:])
            out[codec] = {"first": losses[0], "last20": tail, "last": losses[-1], "step_ms": step_ms,
                          "sync_ms": sync_ms, "counts": counts, "losses": losses}
            print(f"  {codec}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the last 20: "
                  f"{tail:.4f}); median step {step_ms:.2f} ms, {res['tokens_per_s']:.0f} tokens/s; "
                  f"sync_grads {sync_ms:.3f} ms = {100 * sync_ms / step_ms:.2f} % of the step; "
                  f"peak {res['peak_gib']:.2f} GiB; launches: flash {counts['flash_attention']}, "
                  + ", ".join(f"{k} {counts[k]}" for k in ("quantize_int8_2d", "dequantize_int8_2d",
                                                           "ternarize_2d", "topk_mask_2d",
                                                           "fused_add_2d")))
            check(len(losses) == E2E_STEPS and all(math.isfinite(x) for x in losses),
                  f"{codec}: a loss is not finite")
            check(tail < losses[0], f"{codec}: the loss did not fall")
            check(counts["flash_attention"] == cfg.num_layers * E2E_STEPS,
                  f"{codec}: expected {cfg.num_layers * E2E_STEPS} flash launches (f32 route, "
                  f"forward only: no remat)")
            for name in E2E_KERNELS[codec]:
                check(counts[name] == plan.n_buckets * E2E_STEPS,
                      f"{codec}: expected one {name} per bucket and step")
            off = [n for n, c in counts.items() if c and n not in
                   ("flash_attention", "fused_add_2d", *E2E_KERNELS[codec])]
            check(not off, f"{codec}: launched kernels off its path: {off}")
        gap = abs(out["fp16"]["last"] - out["none"]["last"])
        print(f"  fp16 ends {gap:.4f} from none (the reference's check: < 0.15)")
        check(gap < 0.15, "fp16 does not track the uncompressed run")
        for codec in ("none", "int8"):
            argv = ["--steps", "3", "--compression", codec, "--ckpt-dir", "",
                    "--use-pallas", "never"]
            ref, ref_counts = run_trainer_with(lambda: torch_train_e2e.main(argv))
            check(all(c == 0 for c in ref_counts.values()), "the plain run launched a kernel")
            for i in range(3):
                # step 0 is the forward alone on the same weights: the f32 flash
                # route in 3xTF32 against the plain attention
                tol = 1e-5 if i == 0 else 2e-2
                got, want = out[codec]["losses"][i], ref["losses"][i]
                rel = abs(got - want) / abs(want)
                print(f"  {codec} step {i}: kernels {got:.7f} vs plain (--use-pallas never) "
                      f"{want:.7f} (rel diff {rel:.2e}, tolerance {tol:.0e})")
                check(rel <= tol, f"{codec}: kernel and plain e2e runs disagree at step {i}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    print("  examples/torch_gradient_compression.main on the card (stablelm-3b smoke, 10 steps "
          "each of none, fp16, int8, topk 0.25)")
    trace.reset_counts()
    torch_gradient_compression.main(["--device", "cuda"])
    check(trace.counts("launch")["quantize_int8_2d"] > 0 and trace.counts("launch")["topk_mask_2d"] > 0,
          "the compression example missed its codec kernels")
    print("  examples/torch_serve_batch.main on the card (smoke: batch 2, prompt 32, 8 tokens)")
    trace.reset_counts()
    served = torch_serve_batch.main(["--device", "cuda"])
    print(f"  launches: {dict(trace.counts('launch'))}")
    check(trace.counts("launch")["wkv"] > 0, "rwkv6 did not take the WKV kernel")
    check(all(r["tokens"].shape == (2, 9) for r in served.values()), "a served batch is misshapen")
    results = Path(tempfile.mkdtemp(prefix="torch_run_")) / "torch_results.json"
    results.write_text(json.dumps(dryrun_recs))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "benchmarks" / "torch_run.py"),
                           "--dryrun-results", str(results)], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    print("\n".join("    " + line for line in proc.stdout.splitlines()
                    if line.startswith(("SECTION", "golden", "scheduler-golden", "quantize",
                                        "ternarize", "topk", "fused", "h100_whatif",
                                        "ALL BENCHMARKS", "--"))))
    print(f"  benchmarks/torch_run.py: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
    check(proc.returncode == 0, f"benchmarks/torch_run.py failed: {proc.stderr[-3000:]}")
    shutil.rmtree(results.parent, ignore_errors=True)
    print(f"  phase wall {time.perf_counter() - t_phase:.1f} s")
    return out


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
    tpu_row = phase_ssm_scan()
    torch.cuda.empty_cache()
    ssm_row = phase_ssm_fused()           # the row carries the fused route, the main path's
    ssm_row["tpu_signature"] = {k: tpu_row[k] for k in ("source", "ms", "plain_ms", "bound_ms",
                                                         "max_abs_err")}
    rows.append(ssm_row)
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
    rwkv_counts, _ = phase_serve("8", "rwkv6-1.6b", {"wkv": rwkv_cfg.num_layers * (1 + SERVE_G),
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
    # per decode step, every one on the fused route) and 1 attention layer
    # (flash in the prefill only)
    jamba_cfg = get_config("jamba-v0.1-52b")
    n_mamba = sum(mixer == "mamba" for mixer, _ in jamba_layout(jamba_cfg))
    jamba_orders = [{"attn_chunk": 512, "ssm": dataclasses.replace(jamba_cfg.ssm, chunk_size=64)},
                    {"ssm": dataclasses.replace(jamba_cfg.ssm, chunk_size=256)}]
    jamba_counts, jamba_res = phase_serve("12", "jamba-v0.1-52b",
                                          {"ssm_scan": n_mamba * (1 + SERVE_G),
                                           "ssm_scan_fused": n_mamba * (1 + SERVE_G),
                                           "flash_attention": jamba_cfg.hybrid_block_layers - n_mamba},
                                          jamba_orders, layers=jamba_cfg.hybrid_block_layers,
                                          why="its 32 layers are 104 GB of bf16")
    print(f"  jamba-v0.1-52b serving with the fused scan: prefill {jamba_res['prefill_s']:.3f} s, peak "
          f"{jamba_res['peak_gib']:.1f} GiB (the TPU-signature scan over formed decay and bx, "
          f"PERF.md: 0.592 s, 45.8 GiB)")
    # 53 GB of float32 weights: batch 1 keeps the plain path under 60 GiB
    check_float32("jamba-v0.1-52b", 1, layers=jamba_cfg.hybrid_block_layers)
    measured = phase_cnn_step()
    phase_cnn_trainer()
    phase_cnn_whatif(measured)
    phase_engine(tl, tl_counts, measured_add)
    # last: no process pool may fork a parent that holds a process group
    phase_nccl_trainer(args.layers, trained)
    phase_nccl_sync()
    phase_torchrun_checkpoint()
    phase_moe_trainer(trained)
    phase_families()
    phase_specs_step(trained, card)
    dryrun_recs = phase_dryrun()
    for trainer in NEW_TRAINERS:
        phase_new_trainer(*trainer)
    phase_mla_block()
    phase_e2e_codecs(dryrun_recs)
    phase_remat_dots(trained, args.layers)

    # each kernel's launches on the path that runs it: ternarize on the
    # ternary trainer run, topk_mask on the topk run, wkv on rwkv6 serving,
    # ssm_scan on jamba serving (all on the fused route), the copy probe on
    # the calibration, the others (dequantize among them) on the int8 trainer run
    paths = {"ternarize_2d": ternary_counts, "topk_mask_2d": topk_counts,
             "wkv": rwkv_counts, "ssm_scan": jamba_counts, "probe_copy_2d": calib_counts}
    for row in rows:
        row["launches"] = paths.get(row["name"], trained["counts"])[row["name"]]
        check(row["launches"] > 0, f"{row['name']} was never launched on its path")
    check(len(rows) == 9, f"expected a row for each of the nine TPU kernels, got {len(rows)}")
    print(f"[23] total {time.time() - t_start:.0f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
