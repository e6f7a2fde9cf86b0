"""Decoder-only transformer stack: the dense, MoE and VLM families, with GQA
or MLA attention, for training and serving.

Layer parameters are stacked along a leading axis (``blocks.attn.wq`` is
``(n, d_model, d_model)``), exactly as in the JAX package, and each stack
is walked by a Python loop over ``param[i]`` views, the counterpart of
``lax.scan`` there.  An MoE config with ``moe.first_dense`` leading dense
layers keeps them in a stack of their own, ``first_blocks``, run before the
MoE stack ``blocks``.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint``, which carries the MoE auxiliary losses out with
the residual stream (the reference's scan carry).  A VLM prepends its
prefix embeddings to the token embeddings; the loss drops those positions,
the prefill's cache keeps them.  Serving: ``prefill`` returns the stacked
caches (K/V for GQA, the latent ``c_kv`` and ``k_rope`` for MLA),
``decode_step`` writes one token into them in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (Params, _device_of, chunked_softmax_xent, dense_init,
                                       embed_init, init_mlp, mlp, rms_norm, torch_dtype)
from repro_torch.parallel.sharding import lookup, stacked_empty
from repro_torch.utils.tree import tree_map


def n_first_dense(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.moe else 0


def n_scanned(cfg: ModelConfig) -> int:
    """Layers of the ``blocks`` stack.  JAX builds an unstacked MoE tree that
    its forward never runs when ``num_layers <= moe.first_dense``; the port
    refuses that depth."""
    n = cfg.num_layers - n_first_dense(cfg)
    if n <= 0:
        raise ValueError(f"{cfg.name}: num_layers must exceed moe.first_dense = "
                         f"{n_first_dense(cfg)}, got {cfg.num_layers}")
    return n


def _stacks(cfg: ModelConfig):
    """[(name, n_layers, use_moe)] in the order the forward runs them."""
    out = [("first_blocks", n_first_dense(cfg), False)] if n_first_dense(cfg) else []
    return out + [("blocks", n_scanned(cfg), cfg.moe is not None)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block_stack(gen, cfg: ModelConfig, n_layers: int, use_moe: bool,
                      device=None) -> Params:
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    init_attn = attn_lib.init_mla if cfg.attention == "mla" else attn_lib.init_gqa
    p: Params = {
        "attn": init_attn(gen, cfg, n_layers, device=device),
        "ln1": {"w": torch.ones((n_layers, cfg.d_model), dtype=dtype, device=dev)},
        "ln2": {"w": torch.ones((n_layers, cfg.d_model), dtype=dtype, device=dev)},
    }
    if use_moe:
        p["moe"] = moe_lib.init_moe(gen, cfg, n_layers, device=device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, n_layers, device=device)
    return p


def init_decoder(gen, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` on its device (or only their
    shapes and dtypes with ``device="meta"``)."""
    dtype = torch_dtype(cfg.dtype)
    params: Params = {
        "embed": {"w": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype, device=device)},
        "final_norm": {"w": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=_device_of(gen, device))},
    }
    for name, n, use_moe in _stacks(cfg):
        params[name] = _init_block_stack(gen, cfg, n, use_moe, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                             dtype, scale=0.02, device=device)}
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_forward(bp: Params, x: torch.Tensor, cfg: ModelConfig, use_moe: bool,
                   q_offset: int = 0):
    """One transformer layer.  Returns (x, aux, cache)."""
    attend = attn_lib.mla_forward if cfg.attention == "mla" else attn_lib.gqa_forward
    a, cache = attend(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps), cfg, q_offset)
    x = x + a
    h = rms_norm(x, bp["ln2"]["w"], cfg.norm_eps)
    if use_moe:
        m, aux = moe_lib.moe_block(bp["moe"], h, cfg)
    else:
        m, aux = mlp(bp["mlp"], h), {}
    return x + m, aux, cache


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None, want_cache: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """tokens: (B, S) int -> (hidden (B, P + S, D), aux_loss scalar, caches),
    P the prefix embeddings' length (0 without them).

    With ``want_cache`` the caches hold one entry a stack, each leaf stacked
    over its layers: ``{"k", "v"}`` (n, B, P + S, KV, hd) for GQA, ``{"c_kv",
    "k_rope"}`` (n, B, P + S, L | R) for MLA; the layers then run without
    checkpointing."""
    x = lookup(params["embed"]["w"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}

    def body(h, aux_acc, lp, use_moe):
        h, aux, cache = _block_forward(lp, h, cfg, use_moe)
        if aux:
            aux_acc = aux_acc + sum(aux.values())
        return h, aux_acc, cache

    for name, n_layers, use_moe in _stacks(cfg):
        aux_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n_layers):
            lp = tree_map(lambda p: p[i], params[name])
            if want_cache:
                x, aux_acc, cache = body(x, aux_acc, lp, use_moe)
                if i == 0:        # the stacked cache, written a layer at a time
                    caches[name] = {key: stacked_empty(val, n_layers)
                                    for key, val in cache.items()}
                for key, val in cache.items():
                    caches[name][key][i] = val
            elif cfg.remat and torch.is_grad_enabled():
                x, aux_acc = checkpoint(lambda h, a, p, m=use_moe: body(h, a, p, m)[:2],
                                        x, aux_acc, lp, use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                x, aux_acc, _ = body(x, aux_acc, lp, use_moe)
        aux_total = aux_total + aux_acc
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x, aux_total, caches


def lm_head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["lm_head"]["w"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    prefix = batch.get("prefix_embeds")
    x, aux, _ = forward(params, batch["tokens"], cfg, prefix_embeds=prefix)
    if prefix is not None:
        x = x[:, prefix.shape[1]:]
    xent = chunked_softmax_xent(x, lm_head_weight(params, cfg), batch["labels"],
                                cfg.logit_chunk, valid_vocab=cfg.vocab_size)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Prefill: hidden states of the final position -> next-token logits,
    plus per-layer caches (the prefix positions among them)."""
    x, _, caches = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                           want_cache=True)
    logits = x[:, -1:] @ lm_head_weight(params, cfg)
    return logits, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """Shapes of the decode cache (ring buffer of ``cache_len`` slots)."""
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    dtype = torch_dtype(cfg.dtype)

    def layer_cache(n):
        if cfg.attention == "mla":
            return {"c_kv": ((n, batch, W, cfg.mla_kv_lora), dtype),
                    "k_rope": ((n, batch, W, cfg.mla_rope_dim), dtype)}
        shape = (n, batch, W, cfg.num_kv_heads, cfg.head_dim)
        return {"k": (shape, dtype), "v": (shape, dtype)}

    return {name: layer_cache(n) for name, n, _ in _stacks(cfg)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> Dict[str, Any]:
    return {name: {key: torch.zeros(shape, dtype=dtype, device=device)
                   for key, (shape, dtype) in layer.items()}
            for name, layer in cache_spec(cfg, batch, cache_len).items()}


def _block_decode(bp: Params, x: torch.Tensor, cache, cache_index: int, cfg: ModelConfig,
                  use_moe: bool):
    attend = attn_lib.mla_decode if cfg.attention == "mla" else attn_lib.gqa_decode
    a, _ = attend(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps), cache, cache_index, cfg)
    x = x + a
    h = rms_norm(x, bp["ln2"]["w"], cfg.norm_eps)
    m = moe_lib.moe_block(bp["moe"], h, cfg)[0] if use_moe else mlp(bp["mlp"], h)
    return x + m


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any], cache_index,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B, 1) int; cache_index: entries already cached (an int; a
    VLM's prefix counts).

    Returns (logits (B, 1, V), cache).  Each layer's slice of the stacked
    cache is written in place, so the returned cache is the one passed in."""
    cache_index = int(cache_index)
    x = lookup(params["embed"]["w"], token)
    for name, n_layers, use_moe in _stacks(cfg):
        for i in range(n_layers):
            lp = tree_map(lambda p: p[i], params[name])
            lc = {key: val[i] for key, val in cache[name].items()}
            x = _block_decode(lp, x, lc, cache_index, cfg, use_moe)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x @ lm_head_weight(params, cfg), cache
