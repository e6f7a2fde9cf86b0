"""Core building blocks shared by every architecture, as plain functions on
tensors.

Parameters are plain nested dicts of tensors with the JAX package's key
paths and shapes, so they compose with ``repro_torch.utils.tree`` and the
bucketed grad-sync in ``repro_torch.parallel.grad_sync``.  Initializers take
an explicit ``torch.Generator``; tensors are created on ``device`` (with
``device="meta"`` only shapes and dtypes are made, no values are drawn).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.utils.tree import tree_leaves

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _device_of(gen: Optional[torch.Generator], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if gen is None:
        raise ValueError("need a torch.Generator or an explicit device")
    return gen.device


# a leaf of more elements is drawn in blocks of rows, so that its float32
# draw never holds more than one block (command-r-35b's stacked MLP leaf is
# 7.4 G elements: 30 GB in float32, beside 60 GB of bf16 weights)
_INIT_WHOLE_MAX = 1 << 30
_INIT_BLOCK = 1 << 28


def _trunc_normal(shape, gen, device, std: float, dtype: torch.dtype) -> torch.Tensor:
    """Inverse-CDF sampling of a normal of ``std`` cut to +-2 sigma."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)          # in place: the leaf may be GBs
    u.clamp_(-1.0 + 1e-7, 1.0 - 1e-7)
    x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std).to(dtype)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype: torch.dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init (LeCun style)."""
    device = _device_of(gen, device)
    shape = tuple(shape)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if math.prod(shape) <= _INIT_WHOLE_MAX:
        return _trunc_normal(shape, gen, device, std, dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _INIT_BLOCK // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - r0)
        rows[r0:r0 + n] = _trunc_normal((n, shape[-1]), gen, device, std, dtype)
    return out


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype: torch.dtype,
               device=None) -> torch.Tensor:
    device = _device_of(gen, device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, d) with d even; positions: broadcastable to (..., S).
    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                 # (d/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype: torch.dtype, n_layers: int = 0,
             device=None) -> Params:
    """SwiGLU MLP; stacked over a leading layer dim when n_layers > 0."""
    lead = (n_layers,) if n_layers else ()
    return {
        "wi": dense_init(gen, lead + (d_model, d_ff), dtype, device=device),
        "wg": dense_init(gen, lead + (d_model, d_ff), dtype, device=device),
        "wo": dense_init(gen, lead + (d_ff, d_model), dtype, device=device),
    }


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def chunked_softmax_xent(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, valid_vocab: int = 0) -> torch.Tensor:
    """Cross-entropy over a huge vocab without materializing (B, S, V).

    x: (B, S, D) final hidden states; lm_head: (D, V); labels: (B, S) int.
    Walks S in blocks of ``chunk``; each block computes logits, the
    logsumexp and the target logit.  ``valid_vocab``: logits of padded vocab
    columns >= this are masked to -1e30 (0 = all valid).  Mean over B*S.
    """
    B, S, D = x.shape
    V = lm_head.shape[-1]
    vocab_mask = (torch.arange(V, device=x.device) >= valid_vocab
                  if (valid_vocab and valid_vocab < V) else None)
    if S % chunk != 0:
        chunk = S  # one block for odd smoke shapes
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = labels.long()
    for start in range(0, S, chunk):
        xc = x[:, start:start + chunk]
        lc = labels[:, start:start + chunk]
        logits = (xc @ lm_head).float()                           # (B, chunk, V)
        if vocab_mask is not None:
            logits = logits.masked_fill(vocab_mask, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        # the difference before the [..., 0]: on a vocab-sharded DTensor the
        # gather is a masked partial sum, which a view must not come between
        total = total + torch.sum((lse[..., None] - torch.gather(logits, -1, lc[..., None]))[..., 0])
    return total / (B * S)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
