"""Row-wise gradient quantizers: int8 block quantization, deterministic
TernGrad ternarization and their decode, one 256-element quantization block
per row.

Counterpart of ``repro/kernels/quantize.py``.  The CUDA kernels are in
``csrc/quantize.cu`` (one warp per row; memory-bound: an encode reads 4
bytes and writes 1 per element, the decode reads 1 and writes 4).
``*_plain`` are the plain PyTorch versions: the wrappers use them for CPU
tensors, and the kernels are held against them on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace

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


def dequantize_int8_2d_plain(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * s


def _check_rows(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != BLOCK:
        raise ValueError(f"expected a float32 (R, {BLOCK}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _check_aligned(t: torch.Tensor) -> None:
    """The kernels move 16 bytes a lane (codes: 4-byte words of 16-byte
    aligned rows); every row of an allocation starts on such a boundary."""
    if t.data_ptr() % 16:
        raise ValueError("the rows must start on a 16-byte boundary")


def _launch_rows(entry: str, counter: str, x: torch.Tensor):
    _check_aligned(x)
    lib = build.library()
    rows = x.shape[0]
    q = torch.empty((rows, BLOCK), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = getattr(lib, entry)(x.data_ptr(), q.data_ptr(), s.data_ptr(), rows,
                                   build.current_stream(x.device))
    build.check(code, entry)
    trace.count("launch." + counter)
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


def _check_codes(q: torch.Tensor, s: torch.Tensor) -> None:
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != BLOCK:
        raise ValueError(f"expected int8 (R, {BLOCK}) codes, got {q.dtype} {tuple(q.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (q.shape[0], 1):
        raise ValueError(f"expected float32 ({q.shape[0]}, 1) scales, got "
                         f"{s.dtype} {tuple(s.shape)}")
    if not (q.is_contiguous() and s.is_contiguous()):
        raise ValueError("expected contiguous codes and scales")
    if q.device != s.device:
        raise ValueError(f"codes on {q.device}, scales on {s.device}")


def dequantize_int8_2d(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """q: (R, 256) int8, s: (R, 1) float32 -> ``float32(q) * s``, (R, 256) f32.

    Any int8 codes: the ternary codes {-1, 0, 1} decode through it too."""
    _check_codes(q, s)
    if not q.is_cuda:
        return dequantize_int8_2d_plain(q, s)
    _check_aligned(q)
    lib = build.library()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        code = lib.repro_dequantize_int8(q.data_ptr(), s.data_ptr(), out.data_ptr(), q.shape[0],
                                         build.current_stream(q.device))
    build.check(code, "repro_dequantize_int8")
    trace.count("launch.dequantize_int8_2d")
    return out
