"""Row-wise gradient quantizers: int8 block quantization and deterministic
TernGrad ternarization, one 256-element quantization block per row.

Counterpart of ``repro/kernels/quantize.py``.  The CUDA kernels are in
``csrc/quantize.cu`` (one warp per row; memory-bound: 4 bytes read and 1
byte written per element).  ``*_plain`` are the plain PyTorch versions: the
wrappers use them for CPU tensors, and the kernels are held against them
on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

BLOCK = 256          # quantization block = one row


def quantize_int8_2d_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    amax = x.abs().amax(dim=1, keepdim=True)
    # tensor / tensor is IEEE division on every device (tensor / python scalar
    # may become a multiplication by the reciprocal on CUDA)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)   # round: half to even
    return q, scale


def ternarize_2d_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = x.abs().mean(dim=1, keepdim=True)
    t = torch.where(x.abs() >= scale, torch.sign(x), torch.zeros_like(x)).to(torch.int8)
    return t, scale


def _check_rows(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != BLOCK:
        raise ValueError(f"expected a float32 (R, {BLOCK}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _launch_rows(entry: str, counter: str, x: torch.Tensor):
    lib = build.library()
    rows = x.shape[0]
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = getattr(lib, entry)(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                                   build.current_stream(x.device))
    build.check(code, entry)
    build.launch_counts[counter] += 1
    return q, s


def quantize_int8_2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, 256) float32 -> (q int8 (R, 256), scale f32 (R, 1)).

    Per row: ``scale = max|x| / 127`` (1 for an all-zero row),
    ``q = clip(round_half_even(x / scale), -127, 127)``."""
    _check_rows(x)
    if not x.is_cuda:
        return quantize_int8_2d_plain(x)
    return _launch_rows("repro_quantize_int8", "quantize_int8_2d", x)


def ternarize_2d(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (R, 256) float32 -> (t int8 in {-1, 0, 1}, scale f32 (R, 1)).

    Per row: ``scale = mean|x|``; ``t = sign(x)`` where ``|x| >= scale``."""
    _check_rows(x)
    if not x.is_cuda:
        return ternarize_2d_plain(x)
    return _launch_rows("repro_ternarize", "ternarize_2d", x)
