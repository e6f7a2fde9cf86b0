"""Forward FLOPs of a decoder whose attention is multi-head latent attention
(DeepSeek-V2 §2.1, arXiv:2405.04434) with no query compression
(``q_lora_rank`` null), from the configuration's published widths: the
latent ``kv_lora_rank`` L, the rope part ``qk_rope_head_dim`` R, the
per-head ``qk_nope_head_dim`` and ``v_head_dim``.

A token's attention products: q, D·H·(nope + R); the latent and the
rope key, D·(L + R); the up-projection of keys and values, L·H·(nope + v);
the output, H·v·D; 2 FLOPs each.  The scores at nope + R and the values at
v over S/2 keys on average.  The MLP, MoE and head terms are
``counts/flops.py``'s.  The latent norm's L scales are no product.
"""
from __future__ import annotations

from portbench.counts.arch import Arch
from portbench.counts.flops import decoder_flops


def widths(a: Arch):
    """(L, R, nope, v) as published."""
    k = a.published
    return (int(k["kv_lora_rank"]), int(k["qk_rope_head_dim"]), int(k["qk_nope_head_dim"]),
            int(k["v_head_dim"]))


def attn_params(a: Arch) -> int:
    D, H = a.d_model, a.n_heads
    L, R, nope, v = widths(a)
    return D * H * (nope + R) + D * (L + R) + L * H * (nope + v) + H * v * D


def forward_flops(a: Arch, batch: int, seq: int) -> float:
    """FLOPs of one forward pass over ``batch`` rows of ``seq`` tokens."""
    _, R, nope, v = widths(a)
    tokens = float(batch) * seq
    scores = 2.0 * tokens * (seq / 2) * a.n_heads * (nope + R)
    values = 2.0 * tokens * (seq / 2) * a.n_heads * v
    return decoder_flops(a, tokens, 2.0 * attn_params(a) * tokens + scores + values)
