"""Fused multi-buffer element-wise add: (K, n) -> (n,) f32 sum over K.

Counterpart of ``repro/kernels/fused_add.py``: the reduction stage of the
all-reduce, the paper's ``AddEst(x)`` object.  Adding K buffers pairwise
reads 2(K-1) and writes K-1 vectors; the fused kernel reads K and writes 1.
The CUDA kernel is in ``csrc/fused_add.cu`` (memory-bound, 16-byte loads,
f32 accumulation in row order); it masks the ragged tail itself, so no
padding is needed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace

MAX_K = 64


def fused_add_2d_plain(buffers: torch.Tensor) -> torch.Tensor:
    return torch.sum(buffers.float(), dim=0)


def fused_add_2d(buffers: torch.Tensor) -> torch.Tensor:
    """buffers: (K, n) float32 or bfloat16, contiguous -> (n,) float32."""
    if buffers.dim() != 2:
        raise ValueError(f"expected (K, n), got {tuple(buffers.shape)}")
    if buffers.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected float32 or bfloat16, got {buffers.dtype}")
    K, n = buffers.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K must be in [1, {MAX_K}], got {K}")
    if not buffers.is_cuda:
        return fused_add_2d_plain(buffers)
    if not buffers.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    lib = build.library()
    out = torch.empty((n,), dtype=torch.float32, device=buffers.device)
    entry = ("repro_fused_add_f32" if buffers.dtype == torch.float32
             else "repro_fused_add_bf16")
    with torch.cuda.device(buffers.device):
        code = getattr(lib, entry)(buffers.data_ptr(), out.data_ptr(), K, n,
                                   build.current_stream(buffers.device))
    build.check(code, entry)
    trace.count("launch.fused_add_2d")
    return out
