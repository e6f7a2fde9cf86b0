"""The benchmark's weights, made on the device from ``--seed``.

Both sides get the same values: the program as the leaves of the tree its
``init(None, device="meta")`` declares, the reference as float32 copies of
the same leaves.  One generator on the device draws every leaf in the
tree's flatten order (dotted paths sorted as tuples of keys), each in one
call and in the dtype the model is served in: norm scales are ones, the
embedding, the head and the router normal with std 0.02, every other
matrix normal with std 1/sqrt(fan-in), the fan-in being its next-to-last
dim (the layers and experts are stacked in front).  The same seed gives
the same weights; nothing is read from the program.

A configuration's reference may give ``init(path)``: a constant that
every element of that leaf takes (1.0 for a norm's scale that the rule
above does not know, 0.0 for a correction bias), or None for the rule
above.  A constant leaf draws nothing from the generator.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_SMALL = ("embed", "lm_head", "router")


def sort_key(path: str) -> Tuple[str, ...]:
    return tuple(path.split("."))


def std_of(path: str) -> float:
    """0.0 for a norm's scale (ones)."""
    keys = path.split(".")
    if any(k in ("ln1", "ln2", "final_norm") or k.endswith("norm") for k in keys):
        return 0.0
    if any(k in _SMALL for k in keys):
        return 0.02
    return -1.0                                    # 1/sqrt(fan-in)


def make(leaves: Sequence[Tuple[str, Sequence[int]]], seed: int, device,
         dtype: torch.dtype,
         init: Optional[Callable[[str], Optional[float]]] = None) -> Dict[str, torch.Tensor]:
    """{path: tensor} for ``leaves`` [(path, shape)], drawn in path order;
    ``init``: the reference's rule for its own leaves."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    for path, shape in sorted(leaves, key=lambda ps: sort_key(ps[0])):
        shape = tuple(int(s) for s in shape)
        const = init(path) if init is not None else None
        if const is not None:
            out[path] = torch.full(shape, float(const), dtype=dtype, device=device)
            continue
        std = std_of(path)
        if std == 0.0:
            out[path] = torch.ones(shape, dtype=dtype, device=device)
            continue
        if std < 0:
            std = 1.0 / math.sqrt(shape[-2])
        out[path] = torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)
    return out

