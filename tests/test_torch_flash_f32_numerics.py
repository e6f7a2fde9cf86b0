"""The float32 flash kernel's arithmetic, emulated tile by tile on the CPU,
against the JAX package's ``flash_attention_pallas`` (interpret mode, f32)
and the port's plain version, at the tolerance ``chip_smoke.py`` holds the
kernel to on the card (f32: rtol = atol = 1e-5).

The card runs ``csrc/flash_attn.cu``, which no CPU can; this shows, where the
tests run, that its order of operations fits that tolerance: Q scaled in f32
before the products, key tiles of 64 (32 at head_dim above 80) whose halves
two warps take with running statistics of their own, merged at the end, both
products in 3xTF32 (the residual products summed apart from the high ones),
the keys of each 8-key slice taken in the order (0, 2, 4, 6, 1, 3, 5, 7) by
the second product, and the online softmax with f32 running statistics.
The tensor cores sum inside a product in an order of their own; the
emulation sums as ``torch.matmul`` does.

Each case is also held to the float64 answer at the same tolerance.  With
q x 8 the scores reach |s| = 33, where one f32 ulp is 3.8e-6: JAX's kernel
is itself 9.2e-6 from the float64 answer there, and two f32 orders of
summation differ by up to 1.1e-5, so at q x 8 the emulation, JAX's kernel
and the plain version are each held to the float64 answer rather than to
one another."""
import math
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _torch_port import mm3, np32, tf32, to_jax, to_torch

from repro.kernels.flash_attn import flash_attention_pallas
from repro_torch.kernels.flash_attn import flash_attention_plain

TOL = dict(rtol=1e-5, atol=1e-5)    # chip_smoke.py [2c], f32
NEG_INF = -1e30
# the key order of the P V product within an 8-key slice
SLICE_ORDER = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def kernel_emulation(q, k, v, *, causal, n_heads, n_kv_heads):
    """What csrc/flash_attn.cu computes, in its order.  q: (B*Hq, Sq, hd),
    k, v: (B*Hkv, Skv, hd), f32."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    kw = (64 if hd <= 80 else 32) // 2          # keys a warp takes of each tile
    g = n_heads // n_kv_heads
    b = torch.arange(BH)
    kv_row = (b // n_heads) * n_kv_heads + (b % n_heads) // g
    qs = q * torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    kf, vf = k[kv_row], v[kv_row]
    rows = torch.arange(Sq)[:, None]
    order = (torch.arange(0, kw, 8)[:, None] + SLICE_ORDER[None, :]).reshape(-1)
    halves = []
    for first in (0, kw):                       # the two warps of a row group
        m = torch.full((BH, Sq, 1), NEG_INF)
        l = torch.zeros(BH, Sq, 1)
        acc = torch.zeros(BH, Sq, hd)
        for k0 in range(first, Skv, 2 * kw):
            s = mm3(qs, kf[:, k0:k0 + kw].transpose(1, 2))
            seen = torch.ones(Sq, 1, dtype=torch.bool)
            if causal:
                s = torch.where(k0 + torch.arange(kw)[None, :] > rows, torch.full_like(s, NEG_INF), s)
                seen = rows >= k0                # a warp skips a half above all its rows
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = torch.where(seen, l * corr + p.sum(-1, keepdim=True), l)
            acc = torch.where(seen, acc * corr + mm3(p[:, :, order], vf[:, k0:k0 + kw][:, order]), acc)
            m = torch.where(seen, m_new, m)
        halves.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = halves
    m = torch.maximum(m0, m1)
    c0, c1 = torch.exp(m0 - m), torch.exp(m1 - m)
    return (a0 * c0 + a1 * c1) / torch.clamp(l0 * c0 + l1 * c1, min=1e-30)


def _inputs(BH, S, hd, H, KV, q_scale, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((BH, S, hd)) * q_scale).astype(np.float32)
    k = rng.standard_normal((BH // H * KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((BH // H * KV, S, hd)).astype(np.float32)
    return q, k, v


def _pallas(q, k, v, causal, H, KV):
    return np32(flash_attention_pallas(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                                       block_q=64, block_k=64, n_heads=H, n_kv_heads=KV,
                                       interpret=True))


def _exact(q, k, v, causal, H, KV):
    """The same attention in float64, dense softmax."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    BH, S, hd = q.shape
    b = torch.arange(BH)
    kv_row = (b // H) * KV + (b % H) // (H // KV)
    s = q @ k[kv_row].transpose(1, 2) / math.sqrt(hd)
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), -math.inf)
    return (torch.softmax(s, -1) @ v[kv_row]).numpy()


CASES = [   # BH, S, hd, Hq, Hkv, causal, q scale
    (12, 256, 64, 12, 4, True, 1.0),     # repro-100m: 12 heads of 64, 4 kv heads, S 256
    (12, 128, 64, 12, 4, False, 1.0),
    (12, 256, 64, 12, 4, True, 8.0),     # scores of a large range: the running max at work
    (4, 128, 72, 2, 1, True, 1.0),
    (4, 192, 80, 4, 2, True, 1.0),       # stablelm-3b's head_dim, three 64-key tiles
    (2, 128, 96, 2, 1, True, 1.0),       # 32-key tiles above head_dim 80
    (2, 128, 80, 2, 2, False, 8.0),
    (4, 128, 128, 4, 1, True, 1.0),      # jamba-v0.1-52b's head_dim: 32-key tiles
    (2, 128, 128, 2, 2, False, 1.0),
]


@pytest.mark.parametrize("BH,S,hd,H,KV,causal,q_scale", CASES)
def test_kernel_arithmetic_fits_the_chip_tolerance(BH, S, hd, H, KV, causal, q_scale):
    q, k, v = _inputs(BH, S, hd, H, KV, q_scale, seed=BH * 100 + S + hd)
    emu = kernel_emulation(*map(to_torch, (q, k, v)), causal=causal, n_heads=H, n_kv_heads=KV)
    assert emu.dtype == torch.float32 and bool(torch.isfinite(emu).all())
    exact = _exact(q, k, v, causal, H, KV)
    np.testing.assert_allclose(np32(emu), exact, **TOL)
    # JAX's kernel, and the port's plain version the card holds the kernel to
    plain = flash_attention_plain(*map(to_torch, (q, k, v)), causal=causal, n_heads=H,
                                  n_kv_heads=KV)
    for other in (_pallas(q, k, v, causal, H, KV), np32(plain)):
        np.testing.assert_allclose(np32(emu) if q_scale == 1.0 else other,
                                   other if q_scale == 1.0 else exact, **TOL)


def test_one_tf32_product_misses_the_tolerance(monkeypatch):
    """The tolerance sees the precision: with one TF32 product in place of
    three, the emulation strays beyond 1e-5 of ``flash_attention_pallas``,
    which is why the kernel pays for 3xTF32."""
    q, k, v = _inputs(12, 256, 64, 12, 4, 1.0, seed=1256)
    monkeypatch.setattr(sys.modules[__name__], "mm3", lambda a, b: tf32(a) @ tf32(b))
    emu = kernel_emulation(*map(to_torch, (q, k, v)), causal=True, n_heads=12, n_kv_heads=4)
    assert float(np.abs(np32(emu) - _pallas(q, k, v, True, 12, 4)).max()) > 1e-4


def test_key_order_is_a_permutation_within_each_slice():
    """The second product's key order moves keys only inside their 8-key
    slice, so every key of a tile meets its own row of V exactly once."""
    for kw in (16, 32):
        order = (torch.arange(0, kw, 8)[:, None] + SLICE_ORDER[None, :]).reshape(-1)
        assert sorted(order.tolist()) == list(range(kw))
        assert bool((order // 8 == torch.arange(kw) // 8).all())
