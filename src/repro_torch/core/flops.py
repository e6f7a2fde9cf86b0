"""Analytic per-layer parameter counts and FLOPs for every architecture.

Counterpart of ``repro/core/flops.py``, copied with ``repro.`` ->
``repro_torch.``.  Used by (1) the what-if simulator's H100 timelines
(``timeline.from_transformer``), (2) the MODEL_FLOPS = 6*N_active*D
reference, and (3) the measured timeline's FLOP shares
(``layer_breakdown_from_params``, which reads a torch parameter tree).  All
formulas are per *global* batch.
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

from repro_torch.configs.base import InputShape, ModelConfig

Layer = Tuple[str, int, float]   # (name, params, fwd_flops)


# ---------------------------------------------------------------------------
# per-layer parameter counts
# ---------------------------------------------------------------------------

def attn_params(cfg: ModelConfig) -> int:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention == "mla":
        L, R = cfg.mla_kv_lora, cfg.mla_rope_dim
        return D * L + D * R + 2 * L * H * hd + D * H * (hd + R) + H * hd * D + L
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def mlp_params(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff


def moe_params(cfg: ModelConfig, active: bool = False) -> int:
    moe = cfg.moe
    d_ff = moe.d_ff_expert or cfg.d_ff
    n_e = moe.top_k if active else moe.num_experts
    p = cfg.d_model * moe.num_experts              # router
    p += 3 * n_e * cfg.d_model * d_ff              # routed experts
    p += 3 * cfg.d_model * d_ff * moe.num_shared_experts
    return p


def mamba_params(cfg: ModelConfig) -> int:
    D = cfg.d_model
    di = cfg.ssm.expand * D
    dt = cfg.ssm.dt_rank or max(D // 16, 1)
    n = cfg.ssm.d_state
    return (D * 2 * di + cfg.ssm.d_conv * di + di * (dt + 2 * n)
            + dt * di + di * n + di + di * D)


def rwkv_params(cfg: ModelConfig) -> int:
    D = cfg.d_model
    lora = 64
    time_mix = 5 * D * D + D * lora + lora * D + D + 6 * D
    channel_mix = int(2 * D * cfg.d_ff) + D * D
    return time_mix + channel_mix


def norm_params(cfg: ModelConfig) -> int:
    return 2 * cfg.d_model


# ---------------------------------------------------------------------------
# per-layer forward FLOPs
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, tokens: float, ctx: float, causal: bool) -> float:
    """Projections + score/value matmuls."""
    proj = 2.0 * attn_params(cfg) * tokens
    eff_ctx = ctx / 2 if causal else ctx
    if cfg.sliding_window:
        eff_ctx = min(eff_ctx, cfg.sliding_window)
    qk_pv = 2.0 * 2.0 * tokens * eff_ctx * cfg.num_heads * cfg.head_dim
    return proj + qk_pv


def _mamba_flops(cfg: ModelConfig, tokens: float) -> float:
    di = cfg.ssm.expand * cfg.d_model
    n = cfg.ssm.d_state
    proj = 2.0 * mamba_params(cfg) * tokens
    scan = 6.0 * tokens * di * n
    return proj + scan


def _rwkv_flops(cfg: ModelConfig, tokens: float) -> float:
    H = cfg.d_model // cfg.ssm.head_dim
    hd = cfg.ssm.head_dim
    proj = 2.0 * rwkv_params(cfg) * tokens
    wkv = 4.0 * tokens * H * hd * hd
    return proj + wkv


# ---------------------------------------------------------------------------
# full model breakdown
# ---------------------------------------------------------------------------

def _decoder_layer_kinds(cfg: ModelConfig) -> List[str]:
    """Per-layer mixer/mlp type for the decoder stack."""
    kinds = []
    for i in range(cfg.num_layers):
        if cfg.family == "hybrid":
            in_block = i % cfg.hybrid_block_layers
            mixer = "attn" if in_block == cfg.hybrid_attn_period // 2 else "mamba"
            use_moe = cfg.moe is not None and (in_block % cfg.moe.every == 1)
        elif cfg.family == "ssm":
            mixer, use_moe = "rwkv", False
        else:
            mixer = "attn"
            use_moe = cfg.moe is not None and i >= (cfg.moe.first_dense or 0)
        kinds.append(f"{mixer}+{'moe' if use_moe else 'mlp'}")
    return kinds


def layer_breakdown(cfg: ModelConfig, shape: InputShape) -> List[Layer]:
    """[(name, grad_params, fwd_flops)] in forward order, global batch."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        tokens, ctx, causal = float(B), float(S), False
    else:
        tokens, ctx, causal = float(B) * S, float(S), True
        if cfg.family == "vlm" and cfg.prefix_embeds:
            tokens += float(B) * cfg.prefix_embeds

    layers: List[Layer] = [("embed", cfg.vocab_size * cfg.d_model, 0.0)]
    if cfg.family == "encdec":
        enc_tokens = float(B) * cfg.encoder_seq
        for i in range(cfg.encoder_layers):
            p = attn_params(cfg) + mlp_params(cfg) + norm_params(cfg)
            f = (_attn_flops(cfg, enc_tokens, cfg.encoder_seq, False)
                 + 2.0 * mlp_params(cfg) * enc_tokens)
            layers.append((f"enc{i}", p, f))

    for i, kind in enumerate(_decoder_layer_kinds(cfg)):
        mixer, mlp_kind = kind.split("+")
        p, f = norm_params(cfg), 0.0
        if mixer == "attn":
            p += attn_params(cfg)
            f += _attn_flops(cfg, tokens, ctx, causal)
            if cfg.family == "encdec":       # cross-attention
                p += attn_params(cfg)
                f += _attn_flops(cfg, tokens, cfg.encoder_seq, False)
        elif mixer == "mamba":
            p += mamba_params(cfg)
            f += _mamba_flops(cfg, tokens)
        else:
            p += rwkv_params(cfg)
            f += _rwkv_flops(cfg, tokens)
        if mlp_kind == "moe":
            p += moe_params(cfg)
            f += 2.0 * moe_params(cfg, active=True) * tokens
        elif mixer != "rwkv":          # rwkv_params includes its channel-mix
            p += mlp_params(cfg)
            f += 2.0 * mlp_params(cfg) * tokens
        layers.append((f"layer{i}", p, f))

    head_p = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    head_f = 2.0 * cfg.d_model * cfg.vocab_size * (tokens if shape.kind == "train"
                                                   else float(B))
    layers.append(("lm_head", head_p + cfg.d_model, head_f))
    return layers


def param_count(cfg: ModelConfig) -> int:
    shape = InputShape("probe", 128, 1, "train")
    return sum(p for _, p, _ in layer_breakdown(cfg, shape))


def active_param_count(cfg: ModelConfig) -> int:
    if cfg.moe is None:
        return param_count(cfg)
    total = 0
    shape = InputShape("probe", 128, 1, "train")
    for name, p, _ in layer_breakdown(cfg, shape):
        total += p
    # subtract inactive expert weights
    d_ff = cfg.moe.d_ff_expert or cfg.d_ff
    n_moe_layers = sum(1 for k in _decoder_layer_kinds(cfg) if k.endswith("moe"))
    inactive = 3 * (cfg.moe.num_experts - cfg.moe.top_k) * cfg.d_model * d_ff
    return total - n_moe_layers * inactive


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """The roofline's MODEL_FLOPS reference: 6*N_active*tokens for training,
    2*N_active*tokens for inference (fwd only)."""
    n_active = active_param_count(cfg) - cfg.vocab_size * cfg.d_model  # embed lookup is free
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch


def total_fwd_flops(cfg: ModelConfig, shape: InputShape) -> float:
    return sum(f for _, _, f in layer_breakdown(cfg, shape))


def layer_breakdown_from_params(params: Any, cfg=None) -> List[Layer]:
    """Chunk a parameter tree into its top-level entries, in the tree's own
    key order, with FLOPs proportional to the parameter count."""
    from repro_torch.utils.tree import tree_leaves

    out: List[Layer] = []
    for key, sub in params.items():
        n = sum(int(p.numel()) for p in tree_leaves(sub))
        out.append((key, n, float(n)))
    return out
