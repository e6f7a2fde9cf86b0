#!/usr/bin/env python3
"""Where a chunk's time goes inside the chunked WKV kernel on the GPU.

    PYTHONPATH=src python benchmarks/torch_wkv_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/wkv_sm90.cu`` in which
thread 0 of block 0 reads ``clock64()`` after every barrier of the chunk
loop, and runs it at rwkv6-1.6b's serving prefill (4, 32, 4096, 64) and
trainer (1, 32, 4096, 64) shapes on the model's decay init.  Prints, per
chunk, the cycles from barrier to barrier: the wait for the chunk's TMA
boxes (after the state's split for wgmma), the cumsums, the decay factors
and the split of v, the diagonal score tiles, the off-diagonal score
blocks (with the next chunk's TMA request), and the wgmma products (y and
the state update).  A phase's
count includes the wait for the slowest warp at its closing barrier.  The
marks cost a few cycles each; the kernel's own time comes from
``chip_smoke.py`` [2e].  Needs a CUDA device and nvcc; prints the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import wkv as wk  # noqa: E402

PHASES = ("TMA wait + state split", "cumsum", "decay factors + v split", "diagonal tiles",
          "off-diagonal blocks", "y + state (wgmma)")
LOOP = "for (int ci = 0; ci < nchunks; ++ci) {\n    mbar_wait"
DIAG = "    // the four diagonal 16 x 16 blocks"


def instrumented_source() -> str:
    """The kernel with a clock64 mark after each barrier of the chunk loop,
    and one more barrier (and mark) before the diagonal tiles."""
    src = (build.CSRC / "wkv_sm90.cu").read_text()
    for anchor in (LOOP, DIAG):
        if anchor not in src:
            raise RuntimeError(f"wkv_sm90.cu no longer has the anchor {anchor!r}")
    src = src.replace("namespace {\n", "__device__ unsigned long long g_phase[8];\nnamespace {\n", 1)
    head, tail = src.split(LOOP, 1)
    tail = tail.replace(DIAG, "    __syncthreads();\n" + DIAG, 1)
    count = [0]

    def mark(m):
        count[0] += 1
        return (m.group(0) + f"\n    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
                f"{{ const unsigned long long now = clock64(); g_phase[{count[0] - 1}] += now - t_mark; "
                f"t_mark = now; }}\n")

    body = re.sub(r"__syncthreads\(\);", mark, tail)       # the loop holds the kernel's last barriers
    if count[0] != len(PHASES):
        raise RuntimeError(f"expected {len(PHASES)} barriers in the chunk loop, found {count[0]}")
    return (head + "unsigned long long t_mark = clock64();\n  " + LOOP + body +
            '\nextern "C" int wkv_phases_read(unsigned long long* out) {\n'
            "  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n"
            "  const unsigned long long z[8] = {};\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, sizeof(z)));\n}\n")


def load(out_dir: Path) -> ctypes.CDLL:
    cu, so = out_dir / "wkv_phases.cu", out_dir / "libwkv_phases.so"
    cu.write_text(instrumented_source())
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.repro_wkv_chunked_f32.argtypes = build._SIGNATURES["repro_wkv_chunked_f32"]
    lib.wkv_phases_read.argtypes = [ctypes.c_void_p]
    return lib


def model_inputs(B, H, S, hd, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, k, v = (torch.randn(B, H, S, hd, generator=g, device="cuda") * 0.5 for _ in range(3))
    ratio = torch.arange(H * hd, device="cuda", dtype=torch.float32).reshape(H, hd) / (H * hd - 1)
    w0 = -6.0 + 5.0 * ratio ** 0.7
    logw = -torch.exp(w0[None, :, None, :] + 0.1 * torch.randn(B, H, S, hd, generator=g, device="cuda"))
    u = torch.randn(H, hd, generator=g, device="cuda") * 0.1
    s0 = torch.randn(B, H, hd, hd, generator=g, device="cuda") * 0.1
    return r, k, v, logw, u, s0


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_wkv_phases: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        lib = load(Path(tmp))
        buf = (ctypes.c_ulonglong * 8)()
        for label, B in (("serving prefill", 4), ("trainer", 1)):
            H, S, hd = 32, 4096, 64
            r, k, v, logw, u, s0 = model_inputs(B, H, S, hd, seed=11 + B)
            ev = wk.value_columns(B, H, hd)
            y, s_out = torch.empty_like(r), torch.empty_like(s0)
            sb, sh, st, _ = r.stride()
            args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
                    s0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, H, S, hd, ev, sb, sh, st,
                    torch.cuda.current_stream().cuda_stream)
            build.check(lib.repro_wkv_chunked_f32(*args), "instrumented wkv")   # warm-up
            torch.cuda.synchronize()
            lib.wkv_phases_read(buf)
            build.check(lib.repro_wkv_chunked_f32(*args), "instrumented wkv")
            torch.cuda.synchronize()
            lib.wkv_phases_read(buf)
            err = float((y - wk.wkv_plain(r, k, v, logw, u, s0, chunk=128)[0]).abs().max())
            chunks = (S + wk.CHUNK - 1) // wk.CHUNK
            cycles = [buf[i] / chunks for i in range(len(PHASES))]
            print(f"{label} (B,H,S,hd)=({B},{H},{S},{hd}), EV {ev}: {sum(cycles):.0f} cycles a chunk "
                  f"(block 0; y max abs err {err:.2e} against the plain version)")
            for name, c in zip(PHASES, cycles):
                print(f"  {name:26s} {c:8.0f}  {100 * c / sum(cycles):5.1f} %")


if __name__ == "__main__":
    main()
