"""The products of the reference, in float32 or, for the control, one
precision below the configuration's.

``exact`` is ``a @ b`` in float32 (the caller turns TF32 off).  The
control rounds both operands before the float32 product, its gradient
passing the rounding straight through: ``tf32`` to TF32's 10-bit mantissa
(round to nearest, ties away, as the tensor cores' conversion does) below
a float32 configuration, ``fp8`` to float8 e4m3 with one scale a tensor
(its largest magnitude maps to 448) below a bfloat16 one.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = amax / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _RoundFP8.apply(a) @ _RoundFP8.apply(b)


def tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _RoundTF32.apply(a) @ _RoundTF32.apply(b)


PRODUCTS = {"float32": exact, "tf32": tf32, "fp8": fp8}
# the control's precision, by the configuration's dtype
CONTROL = {"float32": "tf32", "bfloat16": "fp8", "float16": "fp8"}
