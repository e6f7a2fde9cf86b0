#!/usr/bin/env python3
"""Where a key tile's time goes inside the float32 flash kernel on the GPU.

    PYTHONPATH=src python benchmarks/torch_flash_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/flash_attn.cu`` in which
thread 0 of block 0 (the first warp of the heaviest query tile: causal runs
the longest tiles first) reads ``clock64()`` at the phases of the key-tile
loop, and runs it causal at repro-100m's (48, 256, 64) with Hq 12 / Hkv 4
and at (8, 4096, 80).  Prints the cycles before the loop (the prologue's
copies and Q's split) and, summed over the tiles, the wait for a tile's
copies with the barrier, the issue of the next tile's copies and of the
S = Q K^T products (with the split of K's fragments), the online softmax
(which waits for them), and the P V products (with the split of V's
fragments) with the loop's turn.  Marks read issue times, so an
asynchronous product shows up in the phase that first waits for it.
The marks cost a few cycles each; the kernel's own time comes from
``chip_smoke.py`` [2c].  Needs a CUDA device and nvcc; prints the card's
name, power limit and SM clock.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attn as fl  # noqa: E402

# (anchor in the source, the mark goes before it or after it, the phase that
# ends at the mark); a phase runs from the mark before
MARKS = [
    ("  for (int j = 0; j < n_kv; ++j) {\n", "before", "prologue: copies issued, Q split"),
    ("    __syncthreads();                   // tile j has landed; tile j - 1 is no longer read\n",
     "after", "tile wait + barrier"),
    ("    // online softmax;", "before", "next copies + S = Q K^T (issue)"),
    ("    // O += P V", "before", "online softmax"),
    ("  // the two halves of each row group meet", "before", "P V + the loop's turn"),
]
LOOP_TOP = "    cp_async_wait_all();\n    __syncthreads();"


def mark(i: int, cond: str = "") -> str:
    return (f"if (threadIdx.x == 0 && blockIdx.x == 0{cond}) {{ const unsigned long long now = "
            f"clock64(); g_phase[{i}] += now - t_mark; t_mark = now; }}\n")


def instrumented_source() -> str:
    src = (build.CSRC / "flash_attn.cu").read_text()
    src = src.replace("namespace {\n", "__device__ unsigned long long g_phase[8];\nnamespace {\n", 1)
    start = src.index("flash_fwd_kernel(")
    head, body = src[:start], src[start:]
    body = body.replace("  const int warp = threadIdx.x >> 5",
                        "  unsigned long long t_mark = clock64();\n  const int warp = threadIdx.x >> 5", 1)
    for anchor in [a for a, _, _ in MARKS] + [LOOP_TOP]:
        if anchor not in body:
            raise RuntimeError(f"flash_attn.cu no longer has the anchor {anchor!r}")
    for i, (anchor, where, _) in enumerate(MARKS):
        at = body.index(anchor)
        if where == "after":
            at += len(anchor.split("\n")[0]) + 1
        body = body[:at] + "    " + mark(i) + body[at:]
    # the top of each later turn closes the previous turn's P V
    body = body.replace(LOOP_TOP, "    " + mark(len(MARKS) - 1, " && j > 0") + LOOP_TOP, 1)
    return (head + body + '\nextern "C" int flash_phases_read(unsigned long long* out) {\n'
            "  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n"
            "  const unsigned long long z[8] = {};\n"
            "  return static_cast<int>(cudaMemcpyToSymbol(g_phase, z, sizeof(z)));\n}\n")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_flash_phases: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "flash_phases.cu", Path(tmp) / "libflash_phases.so"
        cu.write_text(instrumented_source())
        subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
                       check=True)
        lib = ctypes.CDLL(str(so))
        lib.repro_flash_attn_f32.argtypes = build._SIGNATURES["repro_flash_attn_f32"]
        lib.flash_phases_read.argtypes = [ctypes.c_void_p]
        buf = (ctypes.c_ulonglong * 8)()
        for B, H, KV, S, hd in ((4, 12, 4, 256, 64), (1, 8, 8, 4096, 80)):
            g = torch.Generator(device="cuda").manual_seed(S + hd)
            q = torch.randn(B * H, S, hd, generator=g, device="cuda")
            k, v = (torch.randn(B * KV, S, hd, generator=g, device="cuda") for _ in range(2))
            out = torch.empty_like(q)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, S, S, hd, H, KV,
                    1, 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
            for _ in range(2):                  # the second run is read; the first warms up
                lib.flash_phases_read(buf)
                build.check(lib.repro_flash_attn_f32(*args), "instrumented flash")
                torch.cuda.synchronize()
            lib.flash_phases_read(buf)
            err = float((out - fl.flash_attention_plain(q, k, v, causal=True, n_heads=H,
                                                        n_kv_heads=KV)).abs().max())
            cycles = [buf[i] for i in range(len(MARKS))]
            print(f"({B * H}, {S}, {hd}) Hq {H} / Hkv {KV} causal: block 0, warp 0: "
                  f"{sum(cycles)} cycles (max abs err {err:.2e} against the plain version)")
            for (_, _, name), c in zip(MARKS, cycles):
                print(f"  {name:36s} {c:9d}  {100 * c / max(sum(cycles), 1):5.1f} %")


if __name__ == "__main__":
    main()
