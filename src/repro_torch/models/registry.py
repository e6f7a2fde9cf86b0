"""Uniform model API over the architecture families.

``get_model(cfg)`` returns a ``ModelApi`` whose members close over ``cfg``:

    init(generator, device=None) -> params
    loss_fn(params, batch) -> (loss, metrics)          # batch: tokens/labels
    prefill / decode_step / cache_spec                 # the serving slice, not ported yet
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable
    cache_spec: Callable


def _serving_slice(name: str) -> Callable:
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{name} belongs to the serving slice of the port (prefill / "
            f"decode_step / cache_spec / launch.serve), which is not ported yet")
    return missing


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    from repro_torch.models import transformer as t

    def loss_fn(params, batch):
        return t.loss_fn(params, batch, cfg)

    return ModelApi(cfg, lambda gen, device=None: t.init_decoder(gen, cfg, device=device),
                    loss_fn, _serving_slice("prefill"), _serving_slice("decode_step"),
                    _serving_slice("cache_spec"))


def get_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family == "dense":
        return _transformer_api(cfg)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (only the dense decoder is)")
