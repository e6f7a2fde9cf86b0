"""Forward FLOPs of one training step of a decoder, frozen here so that the
yardstick does not move with the program.

The arithmetic of the program's ``core/flops.layer_breakdown`` for the
decoder families (dense and MoE, multi-head attention), at the time the
benchmark was written: a product of ``n`` parameters costs ``2 n`` FLOPs a
token; causal attention sees S/2 keys on average; an MoE layer counts its
router, its top-k experts and its shared experts; the head counts the
published vocabulary.  Recomputation (remat) is not counted: a model FLOP
is one the step needs.

This is the default count; a configuration whose block it does not count
names its own module in ``port.counts`` (``counts/arch.py``), and
``step_flops`` takes that module's ``forward_flops``.
"""
from __future__ import annotations

from portbench.counts import arch as arch_lib
from portbench.counts.arch import Arch


def attn_params(a: Arch) -> int:
    D, H, KV, hd = a.d_model, a.n_heads, a.n_kv_heads, a.head_dim
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def mlp_params(a: Arch) -> int:
    return 3 * a.d_model * a.d_ff


def moe_active_params(a: Arch) -> int:
    m = a.moe
    return a.d_model * m.n_experts + 3 * (m.top_k + m.n_shared) * a.d_model * m.d_ff_expert


def decoder_flops(a: Arch, tokens: float, per_attn: float) -> float:
    """Forward FLOPs over ``tokens`` of every layer, ``per_attn`` its
    attention's, then its MLP or MoE's, and of the head."""
    total = 0.0
    for _, n, is_moe in a.stacks():
        ffn = moe_active_params(a) if is_moe else mlp_params(a)
        total += n * (per_attn + 2.0 * ffn * tokens)
    return total + 2.0 * a.d_model * a.vocab * tokens


def forward_flops(a: Arch, batch: int, seq: int) -> float:
    """FLOPs of one forward pass over ``batch`` rows of ``seq`` tokens."""
    tokens = float(batch) * seq
    per_attn = 2.0 * attn_params(a) * tokens + 2.0 * 2.0 * tokens * (seq / 2) * a.n_heads * a.head_dim
    return decoder_flops(a, tokens, per_attn)


def step_flops(a: Arch, batch: int, seq: int) -> float:
    """Model FLOPs of a training step: forward and backward, 3x the forward
    of the configuration's count."""
    return 3.0 * arch_lib.module(a, "counts").forward_flops(a, batch, seq)
