"""The codec calibration's yardstick: a copy of a (R, 256) float32 grid.

Counterpart of ``probe_copy_2d`` in ``benchmarks/kernel_bench.py``.  The
calibration (``benchmarks/torch_kernel_bench.py --calibrate``) divides each
codec stage's time by this copy's, so the CUDA kernel in
``csrc/probe_copy.cu`` has the quantize kernels' launch shape (one warp per
256-element row, 8 warps a block): one read and one write per element of the
same kind of kernel, each warp-wide access 512 contiguous bytes, loads and
stores evict-first in L2.  It lives in the package because the package
builds every kernel of ``csrc/`` into one library.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace
from repro_torch.kernels.quantize import _check_aligned, _check_rows


def probe_copy_2d_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x).copy_(x)


def probe_copy_2d(x: torch.Tensor) -> torch.Tensor:
    """x: (R, 256) float32 -> a copy of x."""
    _check_rows(x)
    if not x.is_cuda:
        return probe_copy_2d_plain(x)
    _check_aligned(x)
    lib = build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.repro_probe_copy(x.data_ptr(), out.data_ptr(), x.shape[0],
                                    build.current_stream(x.device))
    build.check(code, "repro_probe_copy")
    trace.count("launch.probe_copy_2d")
    return out
