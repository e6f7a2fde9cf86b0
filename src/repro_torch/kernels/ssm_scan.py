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

``ssm_scan_fused`` is the same scan with the discretisation inside it, in
the model's layout: dt (B, S, d_inner) f32, x (B, S, d_inner) f32 or bf16,
b_t and c_t (B, S, n) f32, a (d_inner, n) f32 and h0 (B, d_inner, n) f32
-> y (B, S, d_inner) f32, h (B, d_inner, n) f32, where the scan above
takes decay = exp(dt * a) and bx = dt * x * b_t formed over (B, S, d_inner,
n).  ``ssm_scan_fused_plain`` forms them exactly as the Mamba mixer does and
runs ``ssm_scan_plain``; the CUDA kernel in ``csrc/ssm_scan_sm90.cu`` forms
them in registers and never writes them (same range: any S >= 0, any
d_inner, n up to 32).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace

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
    trace.count("launch.ssm_scan")
    return y, h_out


def discretise(dt, x, b_t, a) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba mixer's formation of the scan's inputs, as the reference
    writes it: decay = exp(dt * a) and bx = (dt * x) * b over (B, S,
    d_inner, n) in float32 (exp in place: the two are the mixer's largest
    tensors).  Differentiable."""
    decay = (dt[..., None] * a).exp_()
    bx = (dt * x.float())[..., None] * b_t[:, :, None, :]
    return decay, bx


def ssm_scan_fused_plain(dt, x, b_t, c_t, a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``discretise``, then ``ssm_scan_plain`` in the model's layout.
    Returns (y (B, S, d_inner), h (B, d_inner, n))."""
    decay, bx = discretise(dt, x, b_t, a)
    y, h = ssm_scan_plain(decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2))
    return y, h.transpose(1, 2)


def _check_fused(dt, x, b_t, c_t, a, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"dt and x must share one (B, S, d_inner) shape, got "
                         f"{tuple(dt.shape)} and {tuple(x.shape)}")
    B, S, di = dt.shape
    if b_t.dim() != 3 or tuple(b_t.shape[:2]) != (B, S) or c_t.shape != b_t.shape:
        raise ValueError(f"b_t and c_t must share one ({B}, {S}, n) shape, got "
                         f"{tuple(b_t.shape)} and {tuple(c_t.shape)}")
    n = b_t.shape[2]
    if tuple(a.shape) != (di, n) or tuple(h0.shape) != (B, di, n):
        raise ValueError(f"a must be {(di, n)} and h0 {(B, di, n)}, got {tuple(a.shape)} and "
                         f"{tuple(h0.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("dt", dt), ("b_t", b_t), ("c_t", c_t), ("a", a), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")


def ssm_scan_fused(dt, x, b_t, c_t, a, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan with the discretisation inside (see the module
    docstring): the plain version on CPU tensors, the CUDA kernel of
    ``csrc/ssm_scan_sm90.cu`` on CUDA tensors.  h comes back contiguous in
    the model's (B, d_inner, n) layout."""
    _check_fused(dt, x, b_t, c_t, a, h0)
    if not dt.is_cuda:
        return ssm_scan_fused_plain(dt, x, b_t, c_t, a, h0)
    B, S, di = dt.shape
    n = b_t.shape[2]
    if n > MAX_STATE:
        raise ValueError(f"d_state must be at most {MAX_STATE}, got {n}")
    if B > 65535:
        raise ValueError(f"batch must be at most 65535, got {B}")
    if any(t.device != dt.device for t in (x, b_t, c_t, a, h0)):
        raise ValueError("all inputs must lie on one device")
    dt, x, b_t, c_t, a = (t.contiguous() for t in (dt, x, b_t, c_t, a))
    y = torch.empty((B, S, di), dtype=torch.float32, device=dt.device)
    h = torch.empty((B, di, n), dtype=torch.float32, device=dt.device)
    lib = build.library()
    with torch.cuda.device(dt.device):
        code = lib.repro_ssm_scan_fused(dt.data_ptr(), x.data_ptr(), b_t.data_ptr(),
                                        c_t.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                                        h.data_ptr(), int(x.dtype == torch.bfloat16), B, S, n, di,
                                        *h0.stride(), build.current_stream(dt.device))
    build.check(code, "repro_ssm_scan_fused")
    trace.count("launch.ssm_scan")
    trace.count("route.ssm_scan_fused")
    return y, h
