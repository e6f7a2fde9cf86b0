"""Decoder-only transformer stack, dense family: training and serving.

Layer parameters are stacked along a leading axis (``blocks.attn.wq`` is
``(num_layers, d_model, d_model)``), exactly as in the JAX package, and the
stack is walked by a Python loop over ``param[i]`` views, the counterpart of
``lax.scan`` there.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint``.  Serving: ``prefill`` returns the stacked K/V
caches, ``decode_step`` writes one token into them in place.  The MoE
branch and prefix embeddings are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (Params, chunked_softmax_xent, dense_init,
                                       embed_init, init_mlp, mlp, rms_norm,
                                       torch_dtype)
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ones(shape, dtype, gen, device) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype,
                      device=device if device is not None else gen.device)


def _init_block_stack(gen, cfg: ModelConfig, n_layers: int, device=None) -> Params:
    dtype = torch_dtype(cfg.dtype)
    lead = (n_layers,) if n_layers else ()
    return {
        "attn": attn_lib.init_gqa(gen, cfg, n_layers, device=device),
        "ln1": {"w": _ones(lead + (cfg.d_model,), dtype, gen, device)},
        "ln2": {"w": _ones(lead + (cfg.d_model,), dtype, gen, device)},
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, n_layers, device=device),
    }


def init_decoder(gen, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` on its device (or only their
    shapes and dtypes with ``device="meta"``)."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.attention != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported so far")
    dtype = torch_dtype(cfg.dtype)
    params: Params = {
        "embed": {"w": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype, device=device)},
        "final_norm": {"w": _ones((cfg.d_model,), dtype, gen, device)},
        "blocks": _init_block_stack(gen, cfg, cfg.num_layers, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                             dtype, scale=0.02, device=device)}
    return params


# ---------------------------------------------------------------------------
# forward (train)
# ---------------------------------------------------------------------------

def _block_forward(bp: Params, x: torch.Tensor, cfg: ModelConfig, q_offset: int = 0):
    """One transformer layer.  Returns (x, aux, cache)."""
    a, cache = attn_lib.gqa_forward(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps),
                                    cfg, q_offset)
    x = x + a
    h = rms_norm(x, bp["ln2"]["w"], cfg.norm_eps)
    return x + mlp(bp["mlp"], h), {}, cache


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig, want_cache: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """tokens: (B, S) int -> (hidden (B, S, D), aux_loss scalar, caches).

    With ``want_cache`` the caches are ``{"blocks": {"k", "v"}}``, each
    (num_layers, B, S, KV, hd); the layers then run without checkpointing."""
    x = params["embed"]["w"][tokens.long()]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(h, lp):
        return _block_forward(lp, h, cfg)[0]

    stack = params["blocks"]
    layer_caches = []
    for i in range(cfg.num_layers):
        lp = tree_map(lambda p: p[i], stack)
        if want_cache:
            x, _, cache = _block_forward(lp, x, cfg)
            layer_caches.append(cache)
        elif cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, lp, use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(x, lp)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    caches = ({"blocks": {key: torch.stack([c[key] for c in layer_caches]) for key in ("k", "v")}}
              if want_cache else {})
    return x, aux_total, caches


def lm_head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["w"].T
    return params["lm_head"]["w"]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, aux, _ = forward(params, batch["tokens"], cfg)
    xent = chunked_softmax_xent(x, lm_head_weight(params, cfg), batch["labels"],
                                cfg.logit_chunk, valid_vocab=cfg.vocab_size)
    return xent + aux, {"xent": xent, "aux": aux}


def prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig):
    """Prefill: hidden states of the final position -> next-token logits,
    plus per-layer KV caches."""
    x, _, caches = forward(params, tokens, cfg, want_cache=True)
    logits = x[:, -1:] @ lm_head_weight(params, cfg)
    return logits, caches


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    """Shapes of the decode cache (ring buffer of ``cache_len`` slots)."""
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    dtype = torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, W, cfg.num_kv_heads, cfg.head_dim)
    return {"blocks": {"k": (shape, dtype), "v": (shape, dtype)}}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None) -> Dict[str, Any]:
    spec = cache_spec(cfg, batch, cache_len)["blocks"]
    return {"blocks": {key: torch.zeros(shape, dtype=dtype, device=device)
                       for key, (shape, dtype) in spec.items()}}


def _block_decode(bp: Params, x: torch.Tensor, cache, cache_index: int, cfg: ModelConfig):
    a, new_cache = attn_lib.gqa_decode(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps),
                                       cache, cache_index, cfg)
    x = x + a
    h = rms_norm(x, bp["ln2"]["w"], cfg.norm_eps)
    return x + mlp(bp["mlp"], h), new_cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any], cache_index,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """token: (B, 1) int; cache_index: tokens already cached (an int).

    Returns (logits (B, 1, V), cache).  Each layer's slice of the stacked
    cache is written in place, so the returned cache is the one passed in."""
    cache_index = int(cache_index)
    x = params["embed"]["w"][token.long()]
    stack, stack_cache = params["blocks"], cache["blocks"]
    for i in range(cfg.num_layers):
        lp = tree_map(lambda p: p[i], stack)
        lc = {key: val[i] for key, val in stack_cache.items()}
        x, _ = _block_decode(lp, x, lc, cache_index, cfg)
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x @ lm_head_weight(params, cfg), cache
