"""Uniform model API over the architecture families.

``get_model(cfg)`` returns a ``ModelApi`` whose members close over ``cfg``:

    init(generator, device=None) -> params
    loss_fn(params, batch) -> (loss, metrics)          # batch: tokens/labels
    prefill(params, batch) -> (logits, caches)
    decode_step(params, batch, cache, cache_index) -> (logits, new_cache)
    cache_spec(batch_size, cache_len) -> tree of (shape, dtype) tuples

Ported families: the dense GQA decoder, RWKV-6 (``family="ssm"``,
``ssm.kind="rwkv6"``) and Jamba (``family="hybrid"``, Mamba layers).
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
        return t.prefill(params, batch["tokens"], cfg)

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


# cache leaves whose dim-2 is the ring-buffer/sequence axis
_SEQ_CACHE_LEAVES = {"k", "v", "c_kv", "k_rope"}


def pad_cache(cache: Any, new_len: int) -> Any:
    """Grow the ring-buffer (W) axis of a prefill cache to ``new_len`` so
    decode can append tokens.  Recurrent-state leaves (RWKV ``state``,
    ``tm_x``, ``cm_x``; Mamba ``conv``, ``ssm``) are untouched (they have no
    growing axis)."""

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
    if cfg.family == "dense":
        return _transformer_api(cfg)
    if cfg.family == "ssm" and cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return _ssm_api(cfg)
    if (cfg.family == "hybrid" and cfg.ssm is not None and cfg.ssm.kind == "mamba"
            and cfg.hybrid_block_layers > 0):
        return _hybrid_api(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (only the dense decoder, RWKV-6 and "
        f"Jamba are)")
