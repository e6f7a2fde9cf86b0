"""Mamba selective scan: per (batch, inner channel) a state h of d_state = n
values,

    h_t = decay_t * h_{t-1} + bx_t          y_t = sum_n h_t * c_t

Counterpart of ``repro/kernels/ssm_scan.py`` (``ssm_scan_pallas``), with
its signature and layout: decay, bx (B, S, n, d_inner), c_t (B, S, n), h0
(B, n, d_inner) -> y (B, S, d_inner) f32, h (B, n, d_inner) f32.  The state
and y are float32 whatever the inputs are (decay, bx and c_t may be bf16,
as under ``cfg.bf16_stream``), as the Pallas kernel's f32 scratch is.

``ssm_scan_plain`` is the sequential recurrence in float32, the kernel's
own dataflow.  The CUDA kernel in ``csrc/ssm_scan.cu`` takes any S >= 0
(the S = 1 of a decode step too), any d_inner and n up to 32, and ignores
``chunk``.  It reads decay and bx through their strides, so the model's
(B, S, d_inner, n) tensors are passed as ``transpose(2, 3)`` views and
never copied.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

MAX_STATE = 32
_DTYPES = (torch.float32, torch.bfloat16)


def ssm_scan_plain(decay, bx, c_t, h0, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step in float32 (``chunk`` is unused: the
    signature is the kernel's).  Differentiable."""
    h = h0.float()
    ys = []
    for t in range(decay.shape[1]):
        h = decay[:, t].float() * h + bx[:, t].float()
        ys.append(torch.einsum("bnd,bn->bd", h, c_t[:, t].float()))
    if not ys:
        return h.new_zeros((decay.shape[0], 0, decay.shape[3])), h
    return torch.stack(ys, dim=1), h


def _check(decay, bx, c_t, h0) -> None:
    if decay.dim() != 4 or bx.shape != decay.shape:
        raise ValueError(f"decay and bx must share one (B, S, n, d_inner) shape, got "
                         f"{tuple(decay.shape)} and {tuple(bx.shape)}")
    B, S, n, di = decay.shape
    if tuple(c_t.shape) != (B, S, n) or tuple(h0.shape) != (B, n, di):
        raise ValueError(f"c_t must be {(B, S, n)} and h0 {(B, n, di)}, got "
                         f"{tuple(c_t.shape)} and {tuple(h0.shape)}")
    if decay.dtype not in _DTYPES or bx.dtype != decay.dtype:
        raise ValueError(f"decay and bx must both be float32 or both bfloat16, got "
                         f"{decay.dtype} and {bx.dtype}")
    if c_t.dtype not in _DTYPES or h0.dtype not in _DTYPES:
        raise ValueError(f"c_t and h0 must be float32 or bfloat16, got {c_t.dtype} and {h0.dtype}")


def _dense(t: torch.Tensor) -> bool:
    """(B, n, di) laid out as itself or as the model's (B, di, n)."""
    return t.is_contiguous() or t.transpose(1, 2).is_contiguous()


def ssm_scan(decay, bx, c_t, h0, chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan with ``ssm_scan_pallas``'s signature (see the
    module docstring): the plain version on CPU tensors, the CUDA kernel on
    CUDA tensors.  On the card h comes back with h0's strides."""
    _check(decay, bx, c_t, h0)
    if not decay.is_cuda:
        return ssm_scan_plain(decay, bx, c_t, h0, chunk)
    B, S, n, di = decay.shape
    if n > MAX_STATE:
        raise ValueError(f"d_state must be at most {MAX_STATE}, got {n}")
    if B > 65535:
        raise ValueError(f"batch must be at most 65535, got {B}")
    if any(t.device != decay.device for t in (bx, c_t, h0)):
        raise ValueError("all inputs must lie on one device")
    if bx.stride() != decay.stride():
        decay, bx = decay.contiguous(), bx.contiguous()
    c = c_t.to(torch.float32).contiguous()              # (B, S, n): small
    h0 = h0.to(torch.float32)
    if not _dense(h0):
        h0 = h0.contiguous()
    y = torch.empty((B, S, di), dtype=torch.float32, device=decay.device)
    h_out = torch.empty_strided(h0.shape, h0.stride(), dtype=torch.float32, device=decay.device)
    lib = build.library()
    with torch.cuda.device(decay.device):
        code = lib.repro_ssm_scan(decay.data_ptr(), bx.data_ptr(), c.data_ptr(), h0.data_ptr(),
                                  y.data_ptr(), h_out.data_ptr(), int(decay.dtype == torch.bfloat16),
                                  B, S, n, di, *decay.stride(), *h0.stride(), *h_out.stride(),
                                  build.current_stream(decay.device))
    build.check(code, "repro_ssm_scan")
    build.launch_counts["ssm_scan"] += 1
    return y, h_out
