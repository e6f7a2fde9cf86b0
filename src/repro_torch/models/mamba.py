"""Mamba (S6) selective-state-space mixer, the SSM half of Jamba.

Counterpart of ``repro/models/mamba.py``, with its parameter names and its
(B, S, d_inner, d_state) model layout.  Three plain scans, each the twin of
the JAX one of the same name:

- ``_ssm_scan_chunked`` (the default, ``mamba_scan_impl="assoc"``): chunks
  of ``cfg.ssm.chunk_size`` steps with a carried state, and inside a chunk
  a log-step (Hillis-Steele) scan where JAX runs ``lax.associative_scan``;
- ``_ssm_scan_chunked_fused_y`` (``cfg.mamba_fused_y``): the same, with
  d_state contracted against C inside the chunk;
- ``_ssm_scan_seq_fused_y`` (``mamba_scan_impl="seq"``): one step at a
  time, ``kernels.ssm_scan.ssm_scan_plain`` seen in the model's layout.
  It runs in float32 whatever the inputs are (JAX's carries bf16 under
  ``bf16_stream``).

Kernel dispatch differs from the reference on purpose.  JAX sends a scan
to its Pallas kernel only for ``S > 1``, ``S % chunk_size == 0`` and
``d_inner % 128 == 0``, and every decode step to the jnp path.  The port's
kernel (``repro_torch.kernels.ssm_scan``) takes any S and d_inner, so on a
CUDA tensor, with ``use_pallas`` not ``never``, *every* scan goes through
it, decode included.  It reads the model's tensors through transposed
views (JAX pays two transposes of the largest tensors of the mixer there).
Its gradient is ``_ssm_scan_chunked_fused_y``'s, recomputed in backward,
as ``_ssm_cv_bwd`` does.

``dt_bias``, ``a_log`` and ``d_skip`` are float32 whatever ``cfg.dtype``
is.  ``softplus`` is ``torch.nn.functional.softplus``, which returns x for
x > 20 where JAX computes ``logaddexp(x, 0)``: the two differ by less than
e^-20 relative.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.models.attention import use_pallas
from repro_torch.models.layers import Params, _device_of, dense_init, torch_dtype


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    di, dt_rank, n, d_conv = dims(cfg)
    D = cfg.d_model
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    f32 = dict(dtype=torch.float32, device=dev)
    # S4D-real initialization for A; dt bias spread over [1e-3, 1e-1]
    a = torch.arange(1, n + 1, **f32).expand(di, n)
    u = torch.rand(lead + (di,), generator=gen, **f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))          # inverse softplus
    return {
        "w_in": dense_init(gen, lead + (D, 2 * di), dtype, device=device),
        "conv_w": dense_init(gen, lead + (d_conv, di), dtype, scale=0.5, device=device),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "w_bcdt": dense_init(gen, lead + (di, dt_rank + 2 * n), dtype, device=device),
        "w_dt": dense_init(gen, lead + (dt_rank, di), dtype, device=device),
        "dt_bias": dt_bias * torch.ones(lead + (di,), **f32),
        "a_log": torch.log(a) * torch.ones(lead + (di, n), **f32),
        "d_skip": torch.ones(lead + (di,), **f32),
        "w_out": dense_init(gen, lead + (di, D), dtype, device=device),
    }


# ---------------------------------------------------------------------------
# selective scan: plain forms (model layout) and the kernel behind autograd
# ---------------------------------------------------------------------------

def _chunk_scan(d: torch.Tensor, b: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """States of one chunk: d, b (B, C, di, n), h (B, di, n) the carried
    state.  The combine ``(a0 * b0, a1 * b0 + b1)`` of the reference, as a
    log-step inclusive scan over axis 1."""
    C = d.shape[1]
    k = 1
    while k < C:
        d, b = (torch.cat([d[:, :k], d[:, :-k] * d[:, k:]], dim=1),
                torch.cat([b[:, :k], b[:, :-k] * d[:, k:] + b[:, k:]], dim=1))
        k *= 2
    return b + d * h[:, None]


def _chunks(S: int, chunk: int):
    if S % chunk != 0:
        chunk = S
    return [(c0, c0 + chunk) for c0 in range(0, S, chunk)]


def _ssm_scan_chunked(decay, bx, h0, chunk: int):
    """h_t = decay_t * h_{t-1} + bx_t, a chunk at a time.  decay, bx: (B, S,
    di, n); h0: (B, di, n).  Returns (states (B, S, di, n), h_final)."""
    states = decay.new_empty(decay.shape)
    h = h0
    for c0, c1 in _chunks(decay.shape[1], chunk):
        st = _chunk_scan(decay[:, c0:c1], bx[:, c0:c1], h)
        states[:, c0:c1] = st
        h = st[:, -1]
    return states, h


def _ssm_scan_chunked_fused_y(decay, bx, c_t, h0, chunk: int):
    """``cfg.mamba_fused_y``: d_state contracted against C inside the chunk,
    so the scan emits y (B, S, di).  c_t: (B, S, n).  Returns (y, h_final)."""
    ys = []
    h = h0
    for c0, c1 in _chunks(decay.shape[1], chunk):
        st = _chunk_scan(decay[:, c0:c1], bx[:, c0:c1], h)
        ys.append(torch.einsum("bcdn,bcn->bcd", st, c_t[:, c0:c1]))
        h = st[:, -1]
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def _ssm_scan_seq_fused_y(decay, bx, c_t, h0):
    """``mamba_scan_impl="seq"``: one step at a time, in float32.  Returns
    (y (B, S, di), h_final (B, di, n))."""
    y, h = ssm_scan_plain(decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2))
    return y, h.transpose(1, 2)


class _SSMKernelFn(torch.autograd.Function):
    """Kernel forward with ``_ssm_scan_chunked_fused_y``'s gradients
    (recomputed in backward): the counterpart of ``_ssm_pallas_cv``."""

    @staticmethod
    def forward(ctx, decay, bx, c_t, h0, chunk):
        y, h = ssm_scan(decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2), chunk)
        ctx.save_for_backward(decay, bx, c_t, h0)
        ctx.chunk = chunk
        return y, h.transpose(1, 2)

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, h = _ssm_scan_chunked_fused_y(*inputs, ctx.chunk)
        grads = torch.autograd.grad((y, h), inputs, (g_y, g_h), allow_unused=True)
        return (*grads, None)


# ---------------------------------------------------------------------------
# mixer
# ---------------------------------------------------------------------------

def _depthwise_conv(x, w, b, prev=None):
    """Causal depthwise conv.  x: (B, S, di); w: (d_conv, di); prev: (B,
    d_conv - 1, di) left context (zeros for a fresh sequence).  Returns (y,
    new_prev).  The products are summed left to right, as the reference's
    Python ``sum`` does (the order matters in bf16)."""
    d_conv = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(d_conv)) + b
    return y, xp[:, -(d_conv - 1):]


def mamba_mixer(params: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mixer.  x: (B, S, D) -> (out (B, S, D), final state)."""
    B, S, D = x.shape
    di, dt_rank, n, d_conv = dims(cfg)
    xz = x @ params["w_in"]                              # (B, S, 2*di)
    xs, z = xz[..., :di], xz[..., di:]
    prev = state["conv"] if state is not None else None
    xs, conv_state = _depthwise_conv(xs, params["conv_w"], params["conv_b"], prev)
    xs = F.silu(xs)

    bcdt = xs @ params["w_bcdt"]                         # (B, S, dt_rank+2n)
    dt = F.softplus((bcdt[..., :dt_rank] @ params["w_dt"]).float() + params["dt_bias"])
    b_t = bcdt[..., dt_rank:dt_rank + n].float()
    c_t = bcdt[..., dt_rank + n:].float()

    a = -torch.exp(params["a_log"])                      # (di, n)
    # the two (B, S, di, n) tensors are the largest of the mixer: exp in place
    decay = (dt[..., None] * a).exp_()
    bx = (dt * xs.float())[..., None] * b_t[:, :, None, :]
    h0 = (state["ssm"] if state is not None
          else torch.zeros((B, di, n), dtype=torch.float32, device=x.device))
    if cfg.bf16_stream:
        decay, bx, c_t, h0 = (t.to(torch.bfloat16) for t in (decay, bx, c_t, h0))
    if use_pallas(cfg, x):
        y, h_final = _SSMKernelFn.apply(decay, bx, c_t, h0, cfg.ssm.chunk_size)
    elif cfg.mamba_scan_impl == "seq":
        y, h_final = _ssm_scan_seq_fused_y(decay, bx, c_t, h0)
    elif cfg.mamba_fused_y:
        y, h_final = _ssm_scan_chunked_fused_y(decay, bx, c_t, h0, cfg.ssm.chunk_size)
    else:
        states, h_final = _ssm_scan_chunked(decay, bx, h0, cfg.ssm.chunk_size)
        del decay, bx
        y = torch.einsum("bsdn,bsn->bsd", states, c_t)
    y = y.float() + params["d_skip"] * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["w_out"]
    return out, {"conv": conv_state, "ssm": h_final.float()}


def mamba_decode(params: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: (B, 1, D); state: conv (B, d_conv-1, di), ssm (B,
    di, n).  Returns the new state; the caller writes it where it wants."""
    return mamba_mixer(params, x, cfg, state=state)


def state_spec(cfg: ModelConfig, batch: int):
    di, _, n, d_conv = dims(cfg)
    return {"conv": ((batch, d_conv - 1, di), torch_dtype(cfg.dtype)),
            "ssm": ((batch, di, n), torch.float32)}
