"""Grouped-query attention: chunked online-softmax attention as plain tensor
code, the dispatch to the hand-written flash kernel, the GQA block, and
single-token decode against a ring-buffer KV cache.

Memory discipline: the plain path never materializes an (Sq, Skv) score
matrix larger than (chunk, chunk) per (batch, kv-head, group).  MLA is not
ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.models.layers import Params, apply_rope, dense_init, torch_dtype

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# chunked online-softmax attention core
# ---------------------------------------------------------------------------

def _flash_core(q, k, v, q_pos, kv_pos, *, causal: bool, window: int, chunk: int):
    """q: (B, Hkv, G, Sq, d); k, v: (B, Hkv, Skv, d).

    q_pos: (Sq,) absolute positions of queries; kv_pos: (Skv,).
    Returns (B, Hkv, G, Sq, d).  Walks the KV chunks with a running
    (max, denominator, accumulator) triple; f32 accumulation.
    """
    B, Hkv, G, Sq, d = q.shape
    dv = v.shape[-1]
    Skv = k.shape[2]
    chunk = min(chunk, Skv)
    if Skv % chunk != 0:
        chunk = Skv
    scale = 1.0 / math.sqrt(d)
    qf = q.float() * scale
    q_lo, q_hi = int(q_pos[0]), int(q_pos[-1])                   # positions ascend

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, Skv, chunk):
        pc = kv_pos[start:start + chunk]
        # a block no query can see adds exact zeros (p = exp(-1e30 - m) = 0
        # once m is finite, which the first block guarantees): skip it
        if start > 0 and ((causal and int(pc[0]) > q_hi)
                          or (window and int(pc[-1]) <= q_lo - window)):
            continue
        kc = k[:, :, start:start + chunk].float()
        vc = v[:, :, start:start + chunk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc)
        mask = torch.ones((Sq, pc.shape[0]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pc[None, :] <= q_pos[:, None]
        if window:
            mask &= pc[None, :] > q_pos[:, None] - window
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def use_pallas(cfg, x: torch.Tensor) -> bool:
    """Kernel dispatch policy (the field keeps its JAX name): the
    hand-written kernel on a CUDA tensor, or when forced for tests."""
    mode = getattr(cfg, "use_pallas", "auto")
    if mode == "always":
        return True
    if mode == "never":
        return False
    return x.is_cuda


class _FlashKernelFn(torch.autograd.Function):
    """Kernel forward with the plain path's gradients (recomputed in
    backward), the standard pattern until a backward kernel lands."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, Hq, Sq, d = q.shape
        Hkv = k.shape[1]
        out = flash_attention_cuda(
            q.reshape(B * Hq, Sq, d).contiguous(),
            k.reshape(B * Hkv, k.shape[2], d).contiguous(),
            v.reshape(B * Hkv, v.shape[2], d).contiguous(),
            causal=causal, n_heads=Hq, n_kv_heads=Hkv)
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return out.reshape(B, Hq, Sq, d)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _flash_reference(q, k, v, ctx.causal)
        gq, gk, gv = torch.autograd.grad(out, (q, k, v), g)
        return gq, gk, gv, None


def _flash_pallas_cv(q, k, v, causal: bool):
    return _FlashKernelFn.apply(q, k, v, causal)


def _flash_reference(q, k, v, causal):
    return flash_attention(q, k, v, causal=causal, chunk=1024, _allow_pallas=False)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    chunk: int = 1024, q_offset: int = 0,
                    cfg=None, _allow_pallas: bool = True) -> torch.Tensor:
    """GQA-aware chunked attention.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Skv, d); Hq % Hkv == 0.
    ``q_offset`` shifts query positions (prefill continuation).  Queries are
    processed in blocks of ``chunk`` so a long sequence never holds more
    than one (chunk x chunk) score tile per head-group.

    When ``cfg.use_pallas`` resolves true and the shape qualifies (no
    window/offset, same qk/v dims, 128-aligned), dispatches to the
    hand-written flash kernel (``repro_torch.kernels.flash_attn``).
    """
    if (_allow_pallas and cfg is not None and use_pallas(cfg, q)
            and window == 0 and q_offset == 0
            and q.shape[-1] == v.shape[-1]
            and q.shape[2] % 128 == 0 and k.shape[2] % 128 == 0):
        return _flash_pallas_cv(q, k, v, causal)
    B, Hq, Sq, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, d)
    kv_pos = torch.arange(k.shape[2], device=q.device)

    qchunk = min(chunk, Sq)
    if Sq % qchunk != 0:
        qchunk = Sq
    outs = []
    for i in range(Sq // qchunk):
        q_pos = q_offset + i * qchunk + torch.arange(qchunk, device=q.device)
        outs.append(_flash_core(qg[:, :, :, i * qchunk:(i + 1) * qchunk], k, v,
                                q_pos, kv_pos, causal=causal, window=window,
                                chunk=chunk))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out.reshape(B, Hq, Sq, v.shape[-1])


def decode_attention(q, k, v, valid_mask) -> torch.Tensor:
    """Single-token attention.  q: (B, Hq, 1, d); k, v: (B, Hkv, S, d);
    valid_mask: (B, S) bool (ring-buffer slots that hold real tokens)."""
    B, Hq, _, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, d).float() / math.sqrt(d)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k.float())
    s = torch.where(valid_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    return out.reshape(B, Hq, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def init_gqa(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    return {
        "wq": dense_init(gen, lead + (D, H * hd), dtype, device=device),
        "wk": dense_init(gen, lead + (D, KV * hd), dtype, device=device),
        "wv": dense_init(gen, lead + (D, KV * hd), dtype, device=device),
        "wo": dense_init(gen, lead + (H * hd, D), dtype, device=device),
    }


def gqa_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                q_offset: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training / prefill path.  x: (B, S, D) -> (out, cache)."""
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (x @ params["wk"]).reshape(B, S, KV, hd).transpose(1, 2)
    v = (x @ params["wv"]).reshape(B, S, KV, hd).transpose(1, 2)
    pos = q_offset + torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window,
                          chunk=cfg.attn_chunk, q_offset=q_offset, cfg=cfg)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    cache = {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}      # (B, S, KV, hd)
    return out @ params["wo"], cache


def gqa_decode(params: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cache_index: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, D); cache k/v: (B, W, KV, hd) ring buffer
    (W = sliding window if set, else max seq); cache_index: count of tokens
    already written.  The new token's k/v go into slot ``cache_index % W``
    *in place* (JAX returns an updated copy); the returned cache is the
    same dict."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = cache["k"].shape[1]
    cache_index = int(cache_index)
    q = (x @ params["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
    k = (x @ params["wk"]).reshape(B, 1, KV, hd)
    v = (x @ params["wv"]).reshape(B, 1, KV, hd)
    pos = torch.tensor([cache_index], device=x.device)           # absolute position
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k.transpose(1, 2), pos, cfg.rope_theta).transpose(1, 2)
    slot = cache_index % W
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    n_valid = min(cache_index + 1, W)
    valid = (torch.arange(W, device=x.device) < n_valid)[None, :].expand(B, W)
    out = decode_attention(q, cache["k"].transpose(1, 2), cache["v"].transpose(1, 2), valid)
    out = out.transpose(1, 2).reshape(B, 1, H * hd)
    return out @ params["wo"], cache
