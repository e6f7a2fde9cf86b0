"""Magnitude-threshold sparsification mask (DGC-style top-k).

Counterpart of ``repro/kernels/topk_mask.py``.  Top-k over a 64 MB fusion
bucket is done in two stages, as in the reference: the threshold comes from
``torch.topk`` on a sampled subset (``ops.topk_threshold``, outside the
kernel), and applying the mask, the bandwidth-bound full pass over the
bucket, is the CUDA kernel in ``csrc/topk_mask.cu`` (16-byte loads and
stores, f32 or bf16; the threshold stays in device memory, so no host sync
per bucket).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace


def topk_mask_2d_plain(x: torch.Tensor, threshold) -> torch.Tensor:
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=x.device)
    return torch.where(x.float().abs() >= thr, x, torch.zeros((), dtype=x.dtype, device=x.device))


def topk_mask_2d(x: torch.Tensor, threshold) -> torch.Tensor:
    """x: (R, C) float32 or bfloat16; threshold: 0-d f32 tensor (or a
    number) -> ``x`` where ``|float32(x)| >= threshold``, else 0, in x's dtype.

    Any R and C: the kernel masks its own ragged tail, so unlike the TPU
    kernel it needs no multiple of the row tile."""
    if x.dim() != 2:
        raise ValueError(f"expected (R, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected float32 or bfloat16, got {x.dtype}")
    if not x.is_cuda:
        return topk_mask_2d_plain(x, threshold)
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")
    thr = torch.as_tensor(threshold, device=x.device)
    if thr.numel() != 1 or thr.device != x.device:
        raise ValueError("the threshold must be one value on x's device")
    thr = thr.reshape(()).to(torch.float32).contiguous()
    lib = build.library()
    out = torch.empty_like(x)
    entry = "repro_topk_mask_f32" if x.dtype == torch.float32 else "repro_topk_mask_bf16"
    with torch.cuda.device(x.device):
        code = getattr(lib, entry)(x.data_ptr(), out.data_ptr(), thr.data_ptr(), x.numel(),
                                   build.current_stream(x.device))
    build.check(code, entry)
    trace.count("launch.topk_mask_2d")
    return out
