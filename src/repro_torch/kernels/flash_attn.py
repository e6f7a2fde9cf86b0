"""Flash attention forward (online softmax), causal or full, with
grouped-query heads.

Counterpart of ``repro/kernels/flash_attn.py`` (``flash_attention_pallas``).
Two CUDA kernels, one per input type:

- bf16: ``csrc/flash_attn_sm90.cu``, on Hopper's tensor cores (``wgmma``).
  A block owns 128 query rows (two warpgroups of 64); one producer warp
  loads 128-row K and V tiles with TMA into a two-stage ring; both products
  run on the tensor cores with f32 accumulation, P rounded to bf16 in
  registers between them;
- float32: ``csrc/flash_attn.cu``, on the tensor cores in 3xTF32
  (``mma.sync``; each f32 operand split into a TF32 high part and a
  residual, three products summed in f32, as close as f32 itself): a block
  owns 64 query rows, each 16 of them taken by two warps, one for either
  half of every key tile; K and V tiles arrive by ``cp.async`` in two
  stages and are split once a block.

Both keep the running (max, denominator, accumulator) in f32 registers.
Forward only: the gradient is taken through the plain chunked attention of
``repro_torch.models.attention``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.utils import trace

NEG_INF = -1e30
TILE = 64            # Sq and Skv must be multiples of this for the CUDA kernels
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


def check_kernel_shape(Sq: int, Skv: int, hd: int, causal: bool) -> None:
    """Raise ``ValueError`` for a shape the CUDA kernels do not take."""
    if hd <= 0 or hd % 8 or hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to {MAX_HEAD_DIM}, got {hd}")
    if Sq <= 0 or Skv <= 0 or Sq % TILE or Skv % TILE:
        raise ValueError(f"Sq and Skv must be positive multiples of {TILE}, got {Sq}, {Skv}")
    if causal and Sq != Skv:
        raise ValueError("causal attention needs Sq == Skv")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, n_heads: int = 1,
                         n_kv_heads: int = 1) -> torch.Tensor:
    """q: (B*Hq, Sq, hd); k, v: (B*Hkv, Skv, hd), heads flattened into the
    leading dim; returns (B*Hq, Sq, hd) in the input dtype.

    Query row ``b`` reads key/value row ``(b // Hq) * Hkv + (b % Hq) // g``
    with ``g = Hq / Hkv``; no repeat is materialised.  float32 or bfloat16;
    ``hd`` a multiple of 8 up to 128; ``Sq``, ``Skv`` multiples of 64;
    ``Sq == Skv`` when causal; contiguous (and, in bf16, 16-byte aligned)."""
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
    check_kernel_shape(Sq, Skv, hd, causal)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("expected contiguous tensors")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k, v must start on 16-byte boundaries (TMA)")
    lib = build.library()
    out = torch.empty_like(q)
    entry = "repro_flash_attn_f32" if q.dtype == torch.float32 else "repro_flash_attn_bf16"
    with torch.cuda.device(q.device):
        code = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                   BH, Sq, Skv, hd, n_heads, n_kv_heads, int(causal),
                                   1.0 / math.sqrt(hd), build.current_stream(q.device))
    build.check(code, entry)
    trace.count("launch.flash_attention")
    return out
