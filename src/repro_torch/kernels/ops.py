"""Public wrappers over the compression kernels.

Handle the 1-D <-> (rows, 256) layout and the zero padding; the 2-D
functions below them choose between the CUDA kernel (CUDA tensor) and the
plain version (CPU tensor).  ``use_kernel=False`` asks for the plain version
outright: the reference path of a comparison run.  Counterpart of
``repro/kernels/ops.py``, every function of it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import fused_add as _fa
from repro_torch.kernels import quantize as _q
from repro_torch.kernels import topk_mask as _tm

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


def dequantize_int8(q: torch.Tensor, s: torch.Tensor, n: int,
                    use_kernel: bool = True) -> torch.Tensor:
    """(q int8 (R, BLOCK), scales (R, 1), n) -> the first n decoded values, 1-D f32."""
    fn = _q.dequantize_int8_2d if use_kernel else _q.dequantize_int8_2d_plain
    return fn(q, s).reshape(-1)[:n]


def ternarize(x: torch.Tensor, use_kernel: bool = True):
    """x: any shape float -> (t int8 in {-1,0,1} (R, BLOCK), scales (R, 1), n)."""
    rows, n = _to_rows(x.float())
    fn = _q.ternarize_2d if use_kernel else _q.ternarize_2d_plain
    t, s = fn(rows.contiguous())
    return t, s, n


def deternarize(t: torch.Tensor, s: torch.Tensor, n: int,
                use_kernel: bool = True) -> torch.Tensor:
    """The ternary decode: ``t * scale`` is the int8 decode of the codes
    {-1, 0, 1}, so it reuses that kernel, as the reference does."""
    return dequantize_int8(t, s, n, use_kernel)


def topk_threshold(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Exact magnitude threshold keeping ``max(int(ratio * n), 1)`` entries
    of the 1-D ``x``: the k-th largest ``|x|``, a 0-d f32 tensor on x's
    device (never brought to the host)."""
    k = max(int(ratio * x.shape[0]), 1)
    return torch.topk(x.float().abs(), k).values[-1]


def topk_sparsify(x: torch.Tensor, ratio: float, sample: int = 0,
                  use_kernel: bool = True) -> torch.Tensor:
    """DGC-style sparsification: keep the ~ratio largest-magnitude entries.

    ``sample > 0`` estimates the threshold from that many strided samples
    (the DGC trick: no full sort over a 64 MB bucket)."""
    flat = x.reshape(-1)
    n = flat.numel()
    if sample and sample < n:
        thr = topk_threshold(flat[::n // sample], ratio)
    else:
        thr = topk_threshold(flat, ratio)
    rows, _ = _to_rows(flat)
    fn = _tm.topk_mask_2d if use_kernel else _tm.topk_mask_2d_plain
    out = fn(rows.contiguous(), thr)
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def fused_add(buffers: torch.Tensor, use_kernel: bool = True) -> torch.Tensor:
    """buffers: (K, n) -> (n,) f32 sum via the fused reduction."""
    fn = _fa.fused_add_2d if use_kernel else _fa.fused_add_2d_plain
    return fn(buffers.contiguous())
