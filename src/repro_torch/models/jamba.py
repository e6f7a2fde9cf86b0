"""Jamba: hybrid Mamba + attention (1:7 interleave) with MoE every other
layer [arXiv:2403.19887].

Counterpart of ``repro/models/jamba.py``.  The stack is made of
*super-blocks* of ``hybrid_block_layers`` (8) layers whose kinds differ
(one attention layer at position ``hybrid_attn_period // 2``, Mamba
elsewhere; an MoE FFN at odd positions), so parameters are stored per
position, ``blocks.l0`` ... ``blocks.l7``, each leaf stacked over the
super-blocks: the key paths and shapes of the JAX tree.  ``forward`` is a
Python loop over super-blocks (``lax.scan`` in JAX) with the eight layers
written out, each super-block under ``torch.utils.checkpoint`` with
``cfg.remat`` while gradients are recorded.

The depth must be a whole number of super-blocks: ``n_super_blocks``
raises otherwise, where JAX floors ``num_layers // 8`` and drops layers.

Serving: ``prefill`` returns the attention layers' K/V (nb, B, S, KV, hd)
and the Mamba layers' (conv, ssm) states; ``decode_step`` writes each
layer's slice of that cache in place and returns the cache it was given.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (Params, _device_of, chunked_softmax_xent, dense_init,
                                       embed_init, init_mlp, mlp, rms_norm, torch_dtype)
from repro_torch.utils.tree import tree_map


def block_layout(cfg: ModelConfig):
    """[(mixer, use_moe)] for one super-block."""
    out = []
    for i in range(cfg.hybrid_block_layers):
        mixer = "attn" if i == cfg.hybrid_attn_period // 2 else "mamba"
        use_moe = cfg.moe is not None and (i % cfg.moe.every == 1)
        out.append((mixer, use_moe))
    return out


def n_super_blocks(cfg: ModelConfig) -> int:
    per = cfg.hybrid_block_layers
    if per <= 0 or cfg.num_layers <= 0 or cfg.num_layers % per:
        raise ValueError(f"{cfg.name}: num_layers must be a positive multiple of "
                         f"hybrid_block_layers = {per}, got {cfg.num_layers}")
    return cfg.num_layers // per


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen, cfg: ModelConfig, mixer: str, use_moe: bool, nb: int, device) -> Params:
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    p: Params = {
        "ln1": {"w": torch.ones((nb, cfg.d_model), dtype=dtype, device=dev)},
        "ln2": {"w": torch.ones((nb, cfg.d_model), dtype=dtype, device=dev)},
    }
    if mixer == "attn":
        p["attn"] = attn_lib.init_gqa(gen, cfg, nb, device=device)
    else:
        p["ssm"] = mamba_lib.init_mamba(gen, cfg, nb, device=device)
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, nb, device=device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, nb, device=device)
    return p


def init_model(gen, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` on its device (or only their
    shapes and dtypes with ``device="meta"``)."""
    nb = n_super_blocks(cfg)
    dtype = torch_dtype(cfg.dtype)
    blocks = {f"l{i}": _init_layer(gen, cfg, m, moe, nb, device)
              for i, (m, moe) in enumerate(block_layout(cfg))}
    return {
        "embed": {"w": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype, device=device)},
        "blocks": blocks,
        "final_norm": {"w": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=_device_of(gen, device))},
        "lm_head": {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype, scale=0.02,
                                    device=device)},
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_forward(lp: Params, x, cfg: ModelConfig, mixer: str, use_moe: bool):
    h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
    if mixer == "attn":
        a, cache = attn_lib.gqa_forward(lp["attn"], h, cfg)
    else:
        a, cache = mamba_lib.mamba_mixer(lp["ssm"], h, cfg)
    x = x + a
    h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
    if use_moe:
        m, aux = moe_lib.moe_block(lp["moe"], h, cfg)
    else:
        m, aux = mlp(lp["mlp"], h), {}
    return x + m, aux, cache


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, want_cache: bool = False):
    """tokens: (B, S) int -> (hidden (B, S, D), aux loss, caches).  With
    ``want_cache`` the caches are ``{"l<i>": {...}}``, each leaf stacked over
    the super-blocks; the super-blocks then run without checkpointing."""
    x = params["embed"]["w"][tokens.long()]
    layout = block_layout(cfg)
    aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, aux_acc, bp):
        caches = {}
        for i, (mixer, use_moe) in enumerate(layout):
            h, aux, cache = _layer_forward(bp[f"l{i}"], h, cfg, mixer, use_moe)
            if aux:
                aux_acc = aux_acc + sum(aux.values())
            caches[f"l{i}"] = cache
        return h, aux_acc, caches

    per_block = []
    for j in range(n_super_blocks(cfg)):
        bp = tree_map(lambda p: p[j], params["blocks"])
        if want_cache:
            x, aux_acc, caches = body(x, aux_acc, bp)
            per_block.append(caches)
        elif cfg.remat and torch.is_grad_enabled():
            x, aux_acc = checkpoint(lambda h, a, p: body(h, a, p)[:2], x, aux_acc, bp,
                                    use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux_acc, _ = body(x, aux_acc, bp)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    caches = ({name: {key: torch.stack([c[name][key] for c in per_block]) for key in layer}
               for name, layer in per_block[0].items()} if want_cache else None)
    return x, aux_acc, caches


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    x, aux, _ = forward(params, batch["tokens"], cfg)
    xent = chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                cfg.logit_chunk, valid_vocab=cfg.vocab_size)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """Last-position logits and the decode cache: full-sequence K/V for the
    attention layers, the O(1) (conv, ssm) states for the Mamba layers."""
    x, _, caches = forward(params, tokens, cfg, want_cache=True)
    return x[:, -1:] @ params["lm_head"]["w"], caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    nb = n_super_blocks(cfg)
    dtype = torch_dtype(cfg.dtype)
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    spec: Dict[str, Any] = {}
    for i, (mixer, _) in enumerate(block_layout(cfg)):
        if mixer == "attn":
            shape = (nb, batch, W, cfg.num_kv_heads, cfg.head_dim)
            spec[f"l{i}"] = {"k": (shape, dtype), "v": (shape, dtype)}
        else:
            spec[f"l{i}"] = {key: ((nb,) + shape, dt)
                             for key, (shape, dt) in mamba_lib.state_spec(cfg, batch).items()}
    return spec


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> Dict[str, Any]:
    return {name: {key: torch.zeros(shape, dtype=dtype, device=device)
                   for key, (shape, dtype) in layer.items()}
            for name, layer in cache_spec(cfg, batch, cache_len).items()}


def _layer_decode(lp: Params, x, cache, cache_index: int, cfg: ModelConfig,
                  mixer: str, use_moe: bool):
    """One layer of one token; ``cache`` (this layer's slice) is updated in
    place."""
    h = rms_norm(x, lp["ln1"]["w"], cfg.norm_eps)
    if mixer == "attn":
        a, _ = attn_lib.gqa_decode(lp["attn"], h, cache, cache_index, cfg)
    else:
        a, new_state = mamba_lib.mamba_decode(lp["ssm"], h, cache, cfg)
        for key, val in new_state.items():
            cache[key].copy_(val)
    x = x + a
    h = rms_norm(x, lp["ln2"]["w"], cfg.norm_eps)
    m = moe_lib.moe_block(lp["moe"], h, cfg)[0] if use_moe else mlp(lp["mlp"], h)
    return x + m


def decode_step(params: Params, token: torch.Tensor, cache, cache_index, cfg: ModelConfig):
    """token: (B, 1) int; cache_index: tokens already cached (an int).
    Returns (logits (B, 1, V), cache), the cache the one passed in."""
    cache_index = int(cache_index)
    x = params["embed"]["w"][token.long()]
    layout = block_layout(cfg)
    for j in range(n_super_blocks(cfg)):
        for i, (mixer, use_moe) in enumerate(layout):
            lp = tree_map(lambda p: p[j], params["blocks"][f"l{i}"])
            lc = {key: val[j] for key, val in cache[f"l{i}"].items()}
            x = _layer_decode(lp, x, lc, cache_index, cfg, mixer, use_moe)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x @ params["lm_head"]["w"], cache
