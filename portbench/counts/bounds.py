"""The card's published peaks and the least time a kernel could take.

NVIDIA H100 SXM (80 GB HBM3), dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 and fp16, 495 TFLOP/s in TF32,
3.35 TB/s of HBM bandwidth.  A float32 product is held to 495 / 3 TFLOP/s,
the rate of float32-accurate products on the tensor cores (3xTF32, as the
flash kernel's float32 route computes them), which is above the CUDA
cores' 67: no float32 route can pass it.  A bound is the larger of
operations over peak FLOP/s and bytes over peak bytes/s; each input byte
is counted read once and each output byte written once, and a causal
attention counts only the blocks its inputs need.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12 / 3}
PEAK_HBM_BYTES = 3.35e12
BLOCK = 256                     # the int8 codec's quantization block (one row)


def flash_bound_s(batch: int, q_heads: int, kv_heads: int, seq: int, head_dim: int,
                  dtype: str = "bfloat16", causal: bool = True) -> float:
    """One flash-attention forward: q and o of ``q_heads``, k and v of
    ``kv_heads``, each (batch, heads, seq, head_dim) in ``dtype``."""
    itemsize = 4 if dtype == "float32" else 2
    flops = 4.0 * batch * q_heads * seq * seq * head_dim * (0.5 if causal else 1.0)
    nbytes = 2.0 * batch * (q_heads + kv_heads) * seq * head_dim * itemsize
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_HBM_BYTES)


def quantize_bound_s(rows: int) -> float:
    """int8 encode of (rows, 256) f32: read 4 bytes, write 1, and a scale a row."""
    n = rows * BLOCK
    return (4.0 * n + n + 4.0 * rows) / PEAK_HBM_BYTES


def dequantize_bound_s(rows: int) -> float:
    """int8 decode of (rows, 256) codes and their scales to f32."""
    n = rows * BLOCK
    return (n + 4.0 * rows + 4.0 * n) / PEAK_HBM_BYTES


def fused_add_bound_s(k: int, n: int) -> float:
    """Sum of a (k, n) f32 buffer into (n,) f32."""
    return (4.0 * k * n + 4.0 * n) / PEAK_HBM_BYTES
