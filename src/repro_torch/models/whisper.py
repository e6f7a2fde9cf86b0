"""Whisper-style encoder-decoder transformer backbone [arXiv:2212.04356].

Counterpart of ``repro/models/whisper.py``.  The mel-spectrogram and conv
frontend is a stub there too: the batch supplies frame embeddings (B,
encoder_seq, D).  This module is everything downstream: the bidirectional
audio encoder, the causal text decoder with cross-attention, and the decode
path whose flat cache ``{k, v, xk, xv}`` holds the self-attention ring
buffer and the cross-attention K/V computed once at prefill.

Dtypes follow JAX's promotion.  The frames are float32; in a bfloat16 model
JAX multiplies them by bf16 weights in float32, so the encoder's stream,
its output and the cross-attention K/V (``xk``, ``xv`` of the prefill's
cache) are float32, while the decoder's stream and ``k``, ``v`` are bf16.
``torch.matmul`` refuses mixed dtypes, so every product here promotes its
operands first (``_mm``).  ``cache_spec`` declares ``xk``, ``xv`` in the
model's dtype, as the reference does.

The encoder's self-attention and the cross-attention are called without
``cfg`` and stay on the plain path; the decoder's self-attention takes the
flash kernel when its length is a multiple of 128.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.attention import decode_attention, flash_attention
from repro_torch.models.layers import (Params, _device_of, chunked_softmax_xent, dense_init,
                                       embed_init, init_mlp, rms_norm, torch_dtype)
from repro_torch.parallel.sharding import lookup
from repro_torch.utils.tree import tree_map


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(_mm(x, params["wg"])) * _mm(x, params["wi"])
    return _mm(h, params["wo"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_xattn(gen, cfg: ModelConfig, n_layers: int, device) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dtype = torch_dtype(cfg.dtype)
    return {
        "wq": dense_init(gen, (n_layers, D, H * hd), dtype, device=device),
        "wk": dense_init(gen, (n_layers, D, KV * hd), dtype, device=device),
        "wv": dense_init(gen, (n_layers, D, KV * hd), dtype, device=device),
        "wo": dense_init(gen, (n_layers, H * hd, D), dtype, device=device),
    }


def init_model(gen, cfg: ModelConfig, device=None) -> Params:
    """Random parameters drawn from ``gen`` on its device (or only their
    shapes and dtypes with ``device="meta"``)."""
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    Le, Ld, D = cfg.encoder_layers, cfg.num_layers, cfg.d_model

    def ones(*shape):
        return {"w": torch.ones(shape, dtype=dtype, device=dev)}

    return {
        "embed": {"w": embed_init(gen, (cfg.padded_vocab, D), dtype, device=device)},
        "enc_blocks": {
            "attn": attn_lib.init_gqa(gen, cfg, Le, device=device),
            "mlp": init_mlp(gen, D, cfg.d_ff, dtype, Le, device=device),
            "ln1": ones(Le, D),
            "ln2": ones(Le, D),
        },
        "enc_norm": ones(D),
        "dec_blocks": {
            "attn": attn_lib.init_gqa(gen, cfg, Ld, device=device),
            "xattn": _init_xattn(gen, cfg, Ld, device),
            "mlp": init_mlp(gen, D, cfg.d_ff, dtype, Ld, device=device),
            "ln1": ones(Ld, D),
            "lnx": ones(Ld, D),
            "ln2": ones(Ld, D),
        },
        "final_norm": ones(D),
        "lm_head": {"w": dense_init(gen, (D, cfg.padded_vocab), dtype, scale=0.02,
                                    device=device)},
    }


def _layers(stack: Params, n: int):
    return (tree_map(lambda p: p[i], stack) for i in range(n))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(params: Params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, enc_seq, D) stub embeddings -> encoder hidden states, in
    the promoted dtype of the frames and the weights."""
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def body(x, bp):
        h = rms_norm(x, bp["ln1"]["w"], cfg.norm_eps)
        B, S, _ = h.shape
        q = _mm(h, bp["attn"]["wq"]).reshape(B, S, H, hd).transpose(1, 2)
        k = _mm(h, bp["attn"]["wk"]).reshape(B, S, KV, hd).transpose(1, 2)
        v = _mm(h, bp["attn"]["wv"]).reshape(B, S, KV, hd).transpose(1, 2)
        a = flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
        x = x + _mm(a.transpose(1, 2).reshape(B, S, H * hd), bp["attn"]["wo"])
        return x + _mlp(bp["mlp"], rms_norm(x, bp["ln2"]["w"], cfg.norm_eps))

    x = frames
    for bp in _layers(params["enc_blocks"], cfg.encoder_layers):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(body, x, bp, use_reentrant=False, preserve_rng_state=False)
        else:
            x = body(x, bp)
    return rms_norm(x, params["enc_norm"]["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cross_kv(bp: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    B, Se, _ = enc_out.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    xk = _mm(enc_out, bp["wk"]).reshape(B, Se, KV, hd)
    xv = _mm(enc_out, bp["wv"]).reshape(B, Se, KV, hd)
    return xk, xv


def _cross_attend(bp: Params, h, xk, xv, cfg: ModelConfig):
    """h: (B, Sq, D); xk/xv: (B, Se, KV, hd): bidirectional, no rope."""
    B, Sq, _ = h.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = _mm(h, bp["wq"]).reshape(B, Sq, H, hd).transpose(1, 2)
    a = flash_attention(q, xk.transpose(1, 2), xv.transpose(1, 2), causal=False,
                        chunk=cfg.attn_chunk)
    return _mm(a.transpose(1, 2).reshape(B, Sq, H * hd), bp["wo"])


def _dec_block(bp: Params, x, enc_out, cfg: ModelConfig):
    a, cache = attn_lib.gqa_forward(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps), cfg)
    x = x + a
    xk, xv = _cross_kv(bp["xattn"], enc_out, cfg)
    x = x + _cross_attend(bp["xattn"], rms_norm(x, bp["lnx"]["w"], cfg.norm_eps), xk, xv, cfg)
    x = x + _mlp(bp["mlp"], rms_norm(x, bp["ln2"]["w"], cfg.norm_eps))
    return x, {**cache, "xk": xk, "xv": xv}


def decode_stack(params: Params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, want_cache: bool = False):
    """The decoder over whole sequences: (hidden, caches).  With
    ``want_cache`` the caches are ``{k, v}`` (L, B, S, KV, hd) and ``{xk,
    xv}`` (L, B, Se, KV, hd), and the layers run without checkpointing."""
    x = lookup(params["embed"]["w"], tokens)
    caches = []
    for bp in _layers(params["dec_blocks"], cfg.num_layers):
        if want_cache:
            x, cache = _dec_block(bp, x, enc_out, cfg)
            caches.append(cache)
        elif cfg.remat and torch.is_grad_enabled():
            x = checkpoint(lambda h, e, p: _dec_block(p, h, e, cfg)[0], x, enc_out, bp,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_block(bp, x, enc_out, cfg)[0]
    stacked = ({key: torch.stack([c[key] for c in caches]) for key in caches[0]}
               if want_cache else None)
    return rms_norm(x, params["final_norm"]["w"], cfg.norm_eps), stacked


# ---------------------------------------------------------------------------
# model API
# ---------------------------------------------------------------------------

def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    enc_out = encode(params, batch["frames"], cfg)
    x, _ = decode_stack(params, batch["tokens"], enc_out, cfg)
    xent = chunked_softmax_xent(x, params["lm_head"]["w"], batch["labels"],
                                cfg.logit_chunk, valid_vocab=cfg.vocab_size)
    return xent, {"xent": xent}


def prefill(params: Params, tokens: torch.Tensor, frames: torch.Tensor, cfg: ModelConfig):
    """Next-token logits of the last position and the flat cache: self-attention
    (L, B, S, KV, hd), cross-attention (L, B, Se, KV, hd)."""
    enc_out = encode(params, frames, cfg)
    x, caches = decode_stack(params, tokens, enc_out, cfg, want_cache=True)
    return x[:, -1:] @ params["lm_head"]["w"], caches


def cache_spec(cfg: ModelConfig, batch: int, cache_len: int) -> Dict[str, Any]:
    L = cfg.num_layers
    dtype = torch_dtype(cfg.dtype)
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    kv = (L, batch, W, cfg.num_kv_heads, cfg.head_dim)
    xkv = (L, batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    return {"k": (kv, dtype), "v": (kv, dtype), "xk": (xkv, dtype), "xv": (xkv, dtype)}


def decode_step(params: Params, token: torch.Tensor, cache, cache_index, cfg: ModelConfig):
    """token: (B, 1); cache: the stacked ``{k, v, xk, xv}`` of ``prefill`` (or
    ``cache_spec``).  Each layer's ``k``, ``v`` slot is written in place; the
    returned cache is the one passed in."""
    cache_index = int(cache_index)
    x = lookup(params["embed"]["w"], token)
    H, hd = cfg.num_heads, cfg.head_dim
    for i, bp in enumerate(_layers(params["dec_blocks"], cfg.num_layers)):
        a, _ = attn_lib.gqa_decode(bp["attn"], rms_norm(x, bp["ln1"]["w"], cfg.norm_eps),
                                   {"k": cache["k"][i], "v": cache["v"][i]}, cache_index, cfg)
        x = x + a
        hq = rms_norm(x, bp["lnx"]["w"], cfg.norm_eps)
        B = hq.shape[0]
        xk, xv = cache["xk"][i], cache["xv"][i]
        q = _mm(hq, bp["xattn"]["wq"]).reshape(B, 1, H, hd).transpose(1, 2)
        valid = torch.ones((B, xk.shape[1]), dtype=torch.bool, device=x.device)
        a = decode_attention(q, xk.transpose(1, 2), xv.transpose(1, 2), valid)
        x = x + _mm(a.transpose(1, 2).reshape(B, 1, H * hd), bp["xattn"]["wo"])
        x = x + _mlp(bp["mlp"], rms_norm(x, bp["ln2"]["w"], cfg.norm_eps))
    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    return x @ params["lm_head"]["w"], cache
