"""The bf16 tensor-core flash kernel's arithmetic, emulated tile by tile on
the CPU, against the JAX package's ``flash_attention_pallas`` (interpret
mode) and the port's plain version, at the tolerance ``chip_smoke.py``
holds the kernel to on the card (bf16: rtol = atol = 1e-2).

The card runs ``csrc/flash_attn_sm90.cu``, which no CPU can; this shows,
where the tests run, that its rounding (P to bf16 before the second
product, the scale applied to S in f32) fits that tolerance."""
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from _torch_port import np32, to_jax, to_torch

from repro.kernels.flash_attn import flash_attention_pallas
from repro_torch.kernels.flash_attn import flash_attention_plain

TOL = 1e-2          # chip_smoke.py [2c], bf16
BN = 128            # key rows per tile of the kernel


def kernel_emulation(q, k, v, *, causal, n_heads, n_kv_heads):
    """What csrc/flash_attn_sm90.cu computes, in the same order: bf16
    inputs, S = Q K^T in f32, the scale folded with log2(e) into the
    exponent, f32 running max and row sums, P rounded to bf16 per key tile
    before O += P V, output rounded to bf16."""
    BH, Sq, hd = q.shape
    Skv = k.shape[1]
    g = n_heads // n_kv_heads
    b = torch.arange(BH)
    kv_row = (b // n_heads) * n_kv_heads + (b % n_heads) // g
    qf, kf, vf = q.float(), k.float()[kv_row], v.float()[kv_row]
    sl2 = torch.tensor((1.0 / math.sqrt(hd)) * math.log2(math.e), dtype=torch.float32)
    m = torch.full((BH, Sq, 1), -math.inf)
    l = torch.zeros(BH, Sq, 1)
    acc = torch.zeros(BH, Sq, hd)
    rows = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, BN):
        s = qf @ kf[:, k0:k0 + BN].transpose(1, 2)
        if causal:
            cols = k0 + torch.arange(s.shape[-1])[None, :]
            s = torch.where(cols > rows, torch.full_like(s, -math.inf), s)
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m * sl2 - mx * sl2)
        p = torch.exp2(s * sl2 - mx * sl2)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, k0:k0 + BN]
        m = mx
    return (acc / l).to(torch.bfloat16)


CASES = [   # BH, S, hd, Hq, Hkv, q scale
    (2, 512, 80, 2, 2, 1.0),       # stablelm-3b's head_dim, Hq = Hkv
    (4, 512, 128, 4, 1, 1.0),      # jamba-v0.1-52b's head_dim, GQA group 4
    (2, 512, 80, 2, 2, 8.0),       # scores of a large range: the running max at work
]


@pytest.mark.parametrize("BH,S,hd,H,KV,q_scale", CASES)
def test_kernel_rounding_fits_the_chip_tolerance(BH, S, hd, H, KV, q_scale):
    rng = np.random.default_rng(BH * 7 + hd)
    q = (rng.standard_normal((BH, S, hd)) * q_scale).astype(np.float32)
    k = rng.standard_normal((BH // H * KV, S, hd)).astype(np.float32)
    v = rng.standard_normal((BH // H * KV, S, hd)).astype(np.float32)
    qt, kt, vt = (to_torch(x, torch.bfloat16) for x in (q, k, v))
    emu = kernel_emulation(qt, kt, vt, causal=True, n_heads=H, n_kv_heads=KV)
    assert emu.dtype == torch.bfloat16 and bool(torch.isfinite(emu).all())
    plain = flash_attention_plain(qt, kt, vt, causal=True, n_heads=H, n_kv_heads=KV)
    np.testing.assert_allclose(np32(emu), np32(plain), rtol=TOL, atol=TOL)
    out_j = flash_attention_pallas(to_jax(q, jnp.bfloat16), to_jax(k, jnp.bfloat16),
                                   to_jax(v, jnp.bfloat16), causal=True, n_heads=H,
                                   n_kv_heads=KV, interpret=True)
    np.testing.assert_allclose(np32(emu), np32(out_j), rtol=TOL, atol=TOL)
    # the rounding of P is visible: the emulation is not the plain version in disguise
    assert float((emu.float() - plain.float()).abs().max()) > 0.0
