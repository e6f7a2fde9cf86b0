"""AddEst — the paper's element-wise vector-add timing model.

Counterpart of ``repro/core/addest.py``.  The paper measures vector-add
latency on a V100 across sizes and interpolates linearly.  Here:

- ``AddEst.from_bandwidth``: the analytic model ``t(x) = alpha + 3x /
  mem_bw`` (read two operands, write one), with the V100 (900 GB/s) for the
  faithful reproduction and the H100 (3.35 TB/s) for the port's card;
- ``AddEst.measure``: a measurement on the local device (torch adds, as the
  reference times jnp adds), with linear interpolation between sizes.

``__call__``, ``batch`` and the V100 model are bit-identical to the
reference's.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np

V100_MEM_BW = 900e9
V100_LAUNCH_OVERHEAD = 5e-6      # CUDA kernel launch latency
# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3, the peak every bound in
# PERF.md divides by.  The launch overhead is the copy probe's median time at
# 64 rows (16,384 f32), launches back to back on one stream, as
# `benchmarks/torch_kernel_bench.py --calibrate` measures it ("launch_probe_us"
# of its table): 2.29-2.33 us on an H100 80GB HBM3 at a 700 W power limit.
H100_MEM_BW = 3.35e12
H100_LAUNCH_OVERHEAD = 2.3e-6

_FLUSH_BYTES = 256 << 20          # > the H100's 50 MB L2


@dataclass(frozen=True)
class AddEst:
    """Piecewise-linear interpolated time (seconds) of adding two vectors of
    ``x`` bytes each."""

    sizes: Tuple[float, ...]          # bytes
    times: Tuple[float, ...]          # seconds

    def __call__(self, x: float) -> float:
        if x <= 0:
            return 0.0
        return float(np.interp(x, self.sizes, self.times))

    def batch(self, x: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`__call__` over a float64 size column:
        ``batch(x)[i]`` is bit-identical to ``self(x[i])`` (the same
        compiled interpolation)."""
        return np.where(x <= 0.0, 0.0, np.interp(x, self.sizes, self.times))

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_bandwidth(mem_bw: float, overhead: float = 0.0,
                       max_bytes: float = 1 << 33) -> "AddEst":
        sizes = np.logspace(0, np.log10(max_bytes), 64)
        times = overhead + 3.0 * sizes / mem_bw
        return AddEst(tuple(sizes), tuple(times))

    @staticmethod
    def v100() -> "AddEst":
        return AddEst.from_bandwidth(V100_MEM_BW, V100_LAUNCH_OVERHEAD)

    @staticmethod
    def h100() -> "AddEst":
        return AddEst.from_bandwidth(H100_MEM_BW, H100_LAUNCH_OVERHEAD)

    @staticmethod
    def measure(sizes: Sequence[int] = (1 << 12, 1 << 16, 1 << 20, 1 << 23, 1 << 26),
                repeats: int = 5, device="cuda") -> "AddEst":
        """Measured add times on ``device`` (paper section 3.1 methodology):
        the median of ``repeats`` adds after a warm-up (the reference takes
        the mean; one late sample of a few microseconds would move it).

        On CUDA each add is timed by CUDA events with the L2 cache flushed
        before it (a 256 MiB write), so a size below 50 MB is read from
        device memory, as a gradient bucket arriving cold would be; the
        flush also keeps the stream busy while the host enqueues the add, so
        the host's launch time is not in the reading.  On the CPU the host
        clock times each add."""
        import torch

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AddEst.measure: no CUDA device (pass device='cpu')")
        flush = (torch.empty(_FLUSH_BYTES, dtype=torch.uint8, device=device)
                 if device.type == "cuda" else None)
        out_s, out_t = [], []
        for nbytes in sizes:
            n = max(nbytes // 4, 1)
            a = torch.ones(n, dtype=torch.float32, device=device)
            b = torch.ones(n, dtype=torch.float32, device=device)
            torch.add(a, b)                                   # warm-up
            if flush is None:
                samples = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    torch.add(a, b)
                    samples.append(time.perf_counter() - t0)
            else:
                events = []
                for _ in range(repeats):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    flush.zero_()
                    e0.record()
                    torch.add(a, b)
                    e1.record()
                    events.append((e0, e1))
                torch.cuda.synchronize(device)
                samples = [e0.elapsed_time(e1) * 1e-3 for e0, e1 in events]
            out_s.append(float(nbytes))
            out_t.append(statistics.median(samples))
        return AddEst(tuple(out_s), tuple(out_t))
