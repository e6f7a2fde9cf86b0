"""Uniform model API over the architecture families.

``get_model(cfg)`` returns a ``ModelApi`` whose members close over ``cfg``:

    init(generator, device=None) -> params
    loss_fn(params, batch) -> (loss, metrics)          # batch: tokens/labels(+frontend)
    prefill(params, batch) -> (logits, caches)
    decode_step(params, batch, cache, cache_index) -> (logits, new_cache)
    cache_spec(batch_size, cache_len) -> tree of (shape, dtype) tuples

Every family of the reference: the decoder (``dense``, ``moe``, ``vlm``;
GQA or MLA attention), RWKV-6 (``ssm``), Jamba (``hybrid``) and Whisper
(``encdec``).  The frontend stubs travel in the batch: ``prefix_embeds``
for a VLM, ``frames`` for Whisper.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    cache_spec: Callable


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    from repro_torch.models import transformer as t

    def loss_fn(params, batch):
        return t.loss_fn(params, batch, cfg)

    def prefill(params, batch):
        return t.prefill(params, batch["tokens"], cfg,
                         prefix_embeds=batch.get("prefix_embeds"))

    def decode_step(params, batch, cache, cache_index):
        return t.decode_step(params, batch["tokens"], cache, cache_index, cfg)

    return ModelApi(cfg, lambda gen, device=None: t.init_decoder(gen, cfg, device=device),
                    loss_fn, prefill, decode_step, lambda b, w: t.cache_spec(cfg, b, w))


def _ssm_api(cfg: ModelConfig) -> ModelApi:
    from repro_torch.models import rwkv as r

    def loss_fn(params, batch):
        return r.loss_fn(params, batch, cfg)

    def prefill(params, batch):
        return r.prefill(params, batch["tokens"], cfg)

    def decode_step(params, batch, cache, cache_index):
        return r.decode_step(params, batch["tokens"], cache, cache_index, cfg)

    return ModelApi(cfg, lambda gen, device=None: r.init_model(gen, cfg, device=device),
                    loss_fn, prefill, decode_step, lambda b, w: r.cache_spec(cfg, b))


def _hybrid_api(cfg: ModelConfig) -> ModelApi:
    from repro_torch.models import jamba as j

    def loss_fn(params, batch):
        return j.loss_fn(params, batch, cfg)

    def prefill(params, batch):
        return j.prefill(params, batch["tokens"], cfg)

    def decode_step(params, batch, cache, cache_index):
        return j.decode_step(params, batch["tokens"], cache, cache_index, cfg)

    return ModelApi(cfg, lambda gen, device=None: j.init_model(gen, cfg, device=device),
                    loss_fn, prefill, decode_step, lambda b, w: j.cache_spec(cfg, b, w))


def _encdec_api(cfg: ModelConfig) -> ModelApi:
    from repro_torch.models import whisper as w

    def loss_fn(params, batch):
        return w.loss_fn(params, batch, cfg)

    def prefill(params, batch):
        return w.prefill(params, batch["tokens"], batch["frames"], cfg)

    def decode_step(params, batch, cache, cache_index):
        return w.decode_step(params, batch["tokens"], cache, cache_index, cfg)

    return ModelApi(cfg, lambda gen, device=None: w.init_model(gen, cfg, device=device),
                    loss_fn, prefill, decode_step, lambda b, wl: w.cache_spec(cfg, b, wl))


# cache leaves whose dim-2 is the ring-buffer/sequence axis
_SEQ_CACHE_LEAVES = {"k", "v", "c_kv", "k_rope"}


def pad_cache(cache: Any, new_len: int) -> Any:
    """Grow the ring-buffer (W) axis of a prefill cache to ``new_len`` so
    decode can append tokens.  Recurrent-state leaves (RWKV ``state``,
    ``tm_x``, ``cm_x``; Mamba ``conv``, ``ssm``) are untouched (they have no
    growing axis), and so are Whisper's cross-attention ``xk``, ``xv``."""

    def walk(node, name=None):
        if isinstance(node, dict):
            return {key: walk(val, key) for key, val in node.items()}
        if name in _SEQ_CACHE_LEAVES and node.dim() >= 3:
            axis = 2 if node.dim() >= 4 else 1
            cur = node.shape[axis]
            if cur < new_len:
                shape = list(node.shape)
                shape[axis] = new_len - cur
                return torch.cat([node, node.new_zeros(shape)], dim=axis)
        return node

    return walk(cache)


def get_model(cfg: ModelConfig) -> ModelApi:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _transformer_api(cfg)
    if fam == "ssm":
        if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
            raise ValueError(f"{cfg.name}: family 'ssm' is RWKV-6 (ssm.kind 'rwkv6')")
        return _ssm_api(cfg)
    if fam == "hybrid":
        if cfg.ssm is None or cfg.ssm.kind != "mamba" or cfg.hybrid_block_layers <= 0:
            raise ValueError(f"{cfg.name}: family 'hybrid' is Jamba (Mamba layers in "
                             f"super-blocks of hybrid_block_layers)")
        return _hybrid_api(cfg)
    if fam == "encdec":
        return _encdec_api(cfg)
    raise ValueError(f"unknown family: {fam}")
