#!/usr/bin/env python3
"""The fused selective scan's launch shapes, timed against each other on the GPU.

    PYTHONPATH=src python benchmarks/torch_ssm_launch_shapes.py [--reps 10]

``csrc/ssm_scan_sm90.cu`` picks, per call, how many states of a channel a
thread holds (NPT) and how many consumer warps a block has (CW); its
``launch`` comment gives the rule.  This script compiles the
same source with a small C entry point that launches any (NPT, CW), holds every
shape's output to the wrapper's (``kernels.ssm_scan.ssm_scan_fused``) at
rtol = atol = 1e-4, and times each behind a stream spin at Jamba's three
main-path shapes: the serving prefill (4, 4096, d_inner 8192, n 16), the
trainer's batch of 1 and a decode step, x in bf16.  The rule's choice is
marked.  Needs a CUDA device and ``nvcc``; prints the card's name and power
limit beside the numbers.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import math
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402

ENTRY = r"""
#include "%s"
extern "C" int launch_shape(const void* dt, const void* x, const void* b, const void* c,
                            const void* a, const void* h0, void* y, void* h, int B, int S, int n,
                            int di, long long hb, long long hd, long long hn, int npt, int cw,
                            void* stream) {
  Args args;
  args.dt = static_cast<const float*>(dt); args.x = x;
  args.b = static_cast<const float*>(b); args.c = static_cast<const float*>(c);
  args.a = static_cast<const float*>(a); args.h0 = static_cast<const float*>(h0);
  args.y = static_cast<float*>(y); args.h = static_cast<float*>(h);
  args.S = S; args.n = n; args.di = di; args.ns = 0; args.lp2 = 0;
  args.hb = hb; args.hd = hd; args.hn = hn;
  auto cs = static_cast<cudaStream_t>(stream);
#define SHAPE(N, W) if (npt == N && cw == W) return launch_cw<bf16_bits, N, W>(args, B, cs);
  SHAPE(4, 1) SHAPE(4, 2) SHAPE(4, 4) SHAPE(8, 1) SHAPE(8, 2) SHAPE(8, 4)
  SHAPE(16, 1) SHAPE(16, 2) SHAPE(16, 4)
  return static_cast<int>(cudaErrorInvalidValue);
}
"""
SHAPES = [(npt, cw) for npt, cw in itertools.product((4, 8, 16), (1, 2, 4))]


def rule(S: int, n: int) -> tuple:
    """The (NPT, CW) that ``launch`` in csrc/ssm_scan_sm90.cu picks."""
    return (4, 4) if S < 64 or n <= 4 else (8, 4)


def inputs(B, S, n, di, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt0 = torch.exp(torch.rand(di, generator=g, device=dev) * math.log(100.0) + math.log(1e-3))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(torch.randn(B, S, di, generator=g, device=dev) * 0.5 + bias)
    x = torch.randn(B, S, di, generator=g, device=dev).to(torch.bfloat16)
    b_t = torch.randn(B, S, n, generator=g, device=dev)
    c_t = torch.randn(B, S, n, generator=g, device=dev)
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32).expand(di, n).contiguous()
    h0 = torch.randn(B, di, n, generator=g, device=dev) * 0.1
    return dt, x, b_t, c_t, a, h0


def device_ms(fn, reps: int) -> float:
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_ssm_launch_shapes: needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "shapes.cu"
        src.write_text(ENTRY % (build.CSRC / "ssm_scan_sm90.cu"))
        lib_path = Path(tmp) / "libshapes.so"
        out = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib_path),
                              str(src)], capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"nvcc failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(str(lib_path))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.launch_shape.argtypes = [P_] * 8 + [I_] * 4 + [L_] * 3 + [I_] * 2 + [P_]
    lib.launch_shape.restype = I_
    result = {}
    for label, B, S in (("serving prefill", 4, 4096), ("trainer", 1, 4096), ("decode step", 4, 1)):
        n, di = 16, 8192
        dt, x, b_t, c_t, a, h0 = inputs(B, S, n, di, 7, dev)
        want = ss.ssm_scan_fused(dt, x, b_t, c_t, a, h0)
        chosen = rule(S, n)
        print(f"{label} (B,S,d_inner,n)=({B},{S},{di},{n}), x bf16; the rule picks NPT {chosen[0]}, "
              f"CW {chosen[1]}; wrapper {device_ms(lambda: ss.ssm_scan_fused(dt, x, b_t, c_t, a, h0), args.reps):.4f} ms")
        rows = {}
        for npt, cw in SHAPES:
            y, h = torch.empty_like(want[0]), torch.empty_like(want[1])

            def run():
                code = lib.launch_shape(dt.data_ptr(), x.data_ptr(), b_t.data_ptr(), c_t.data_ptr(),
                                        a.data_ptr(), h0.data_ptr(), y.data_ptr(), h.data_ptr(), B, S,
                                        n, di, *h0.stride(), npt, cw,
                                        torch.cuda.current_stream(dev).cuda_stream)
                build.check(code, "launch_shape")

            run()
            torch.cuda.synchronize()
            torch.testing.assert_close(y, want[0], rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(h, want[1], rtol=1e-4, atol=1e-4)
            ms = device_ms(run, args.reps)
            rows[f"npt{npt}_cw{cw}"] = ms
            mark = "  <- the rule" if (npt, cw) == chosen else ""
            print(f"  NPT {npt:2d} CW {cw}: {ms:.4f} ms{mark}")
        result[label] = rows
    return result


if __name__ == "__main__":
    main()
