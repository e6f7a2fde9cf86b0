"""Config registry: ``get_config("<arch-id>")`` for every ported arch."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.configs.base import (CommConfig, InputShape, INPUT_SHAPES,
                                ModelConfig, MoEConfig, SSMConfig)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # late imports register the configs
        import repro_torch.configs.archs  # noqa: F401
    return _REGISTRY[name]()


def list_configs() -> List[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_REGISTRY)


__all__ = ["CommConfig", "InputShape", "INPUT_SHAPES", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config", "list_configs", "register"]
