"""Flash attention forward (online softmax), causal or full, with
grouped-query heads.

Counterpart of ``repro/kernels/flash_attn.py`` (``flash_attention_pallas``).
The CUDA kernel is in ``csrc/flash_attn.cu``: one thread block per
(batch*head, 64-row query tile), a loop over key/value tiles inside the
block, running (max, denominator, accumulator) in f32 registers.  Forward
only: the gradient is taken through the plain chunked attention of
``repro_torch.models.attention``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
TILE = 64            # query and key/value rows per tile of the CUDA kernel
MAX_HEAD_DIM = 128


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, n_heads: int = 1,
                          n_kv_heads: int = 1) -> torch.Tensor:
    """Dense-softmax version of the same function, f32 inside."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    g = n_heads // max(n_kv_heads, 1)
    b = torch.arange(BH, device=q.device)
    kv_row = (b // n_heads) * n_kv_heads + (b % n_heads) // g
    qf = q.float() * (1.0 / math.sqrt(hd))
    s = torch.bmm(qf, k.float()[kv_row].transpose(1, 2))             # (BH, Sq, Skv)
    if causal:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.bmm(p, v.float()[kv_row]) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, n_heads: int = 1,
                         n_kv_heads: int = 1) -> torch.Tensor:
    """q: (B*Hq, Sq, hd); k, v: (B*Hkv, Skv, hd), heads flattened into the
    leading dim; returns (B*Hq, Sq, hd) in the input dtype.

    Query row ``b`` reads key/value row ``(b // Hq) * Hkv + (b % Hq) // g``
    with ``g = Hq / Hkv``; no repeat is materialised.  float32 or bfloat16;
    ``hd`` a multiple of 8 up to 128; ``Sq``, ``Skv`` multiples of 64;
    ``Sq == Skv`` when causal."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    BH, Sq, hd = q.shape
    BHkv, Skv, _ = k.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share one dtype, float32 or bfloat16")
    if k.shape[2] != hd or n_kv_heads < 1 or n_heads % n_kv_heads or BH % n_heads \
            or BHkv != BH // n_heads * n_kv_heads:
        raise ValueError("head counts do not match the leading dims")
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, n_heads=n_heads,
                                     n_kv_heads=n_kv_heads)
    if hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if Sq % TILE or Skv % TILE:
        raise ValueError(f"Sq and Skv must be multiples of {TILE}, got {Sq}, {Skv}")
    if causal and Sq != Skv:
        raise ValueError("causal attention needs Sq == Skv")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("expected contiguous tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    lib = build.library()
    out = torch.empty_like(q)
    entry = "repro_flash_attn_f32" if q.dtype == torch.float32 else "repro_flash_attn_bf16"
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   BH, Sq, Skv, hd, n_heads, n_kv_heads, int(causal),
                                   1.0 / math.sqrt(hd), build.current_stream(q.device))
    build.check(code, entry)
    build.launch_counts["flash_attention"] += 1
    return out
