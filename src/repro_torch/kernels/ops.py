"""Public wrappers over the compression kernels.

Handle the 1-D <-> (rows, 256) layout and the zero padding; the 2-D
functions below them choose between the CUDA kernel (CUDA tensor) and the
plain version (CPU tensor).  ``use_kernel=False`` asks for the plain version
outright: the reference path of a comparison run.  Counterpart of ``repro/kernels/ops.py``;
``dequantize_int8``, ``deternarize`` and ``topk_sparsify`` are not ported
yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import fused_add as _fa
from repro_torch.kernels import quantize as _q

BLOCK = _q.BLOCK
_PAD_UNIT = BLOCK * 64       # callers see sizes rounded up to this many elements


def _to_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Flatten + zero-pad to a (R, BLOCK) grid with R a multiple of 64."""
    n = x.numel()
    flat = x.reshape(n)
    pad = (-n) % _PAD_UNIT
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def quantize_int8(x: torch.Tensor, use_kernel: bool = True):
    """x: any shape float -> (q int8 (R, BLOCK), scales (R, 1), n)."""
    rows, n = _to_rows(x.float())
    fn = _q.quantize_int8_2d if use_kernel else _q.quantize_int8_2d_plain
    q, s = fn(rows.contiguous())
    return q, s, n


def ternarize(x: torch.Tensor, use_kernel: bool = True):
    """x: any shape float -> (t int8 in {-1,0,1} (R, BLOCK), scales (R, 1), n)."""
    rows, n = _to_rows(x.float())
    fn = _q.ternarize_2d if use_kernel else _q.ternarize_2d_plain
    t, s = fn(rows.contiguous())
    return t, s, n


def fused_add(buffers: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """buffers: (K, n) -> (n,) f32 sum via the fused reduction."""
    fn = _fa.fused_add_2d if use_kernel else _fa.fused_add_2d_plain
    return fn(buffers.contiguous())
