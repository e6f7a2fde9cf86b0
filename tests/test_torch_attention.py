"""``repro_torch.models.attention`` against ``repro.models.attention`` on the
same numpy inputs, f32: the plain chunked path (window, q_offset, GQA) and
the GQA block, value and input gradient, through the plain path and through
the kernel dispatch (``use_pallas="always"``; on the CPU the JAX side runs
its Pallas kernel in interpret mode and the port its kernel's plain
version, both with the recompute backward)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.models import attention as ja
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as ta
from repro_torch.utils import trace

# f32 online softmax in the same block order on both sides; exp and the
# matmul summation order differ between XLA and ATen
TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("Hq,Hkv,Sq,Skv,chunk,causal,window,q_offset", [
    (4, 4, 64, 64, 16, True, 0, 0),
    (4, 2, 64, 64, 32, True, 0, 0),        # GQA
    (4, 2, 48, 48, 16, True, 8, 0),        # sliding window
    (4, 1, 16, 64, 16, True, 0, 48),       # continuation: q_offset
    (2, 2, 40, 40, 16, False, 0, 0),       # odd length falls back to one block
    (4, 2, 128, 128, 64, True, 24, 0),
])
def test_flash_attention_plain_path(Hq, Hkv, Sq, Skv, chunk, causal, window, q_offset):
    q, k, v = _rand((2, Hq, Sq, 16), 0), _rand((2, Hkv, Skv, 16), 1), _rand((2, Hkv, Skv, 16), 2)
    out_j = ja.flash_attention(to_jax(q), to_jax(k), to_jax(v), causal=causal, window=window,
                               chunk=chunk, q_offset=q_offset)
    out_t = ta.flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=causal,
                               window=window, chunk=chunk, q_offset=q_offset)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)


def test_configs_agree():
    cj, ct = jget("stablelm-3b"), tget("stablelm-3b")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert dataclasses.asdict(cj.smoke()) == dataclasses.asdict(ct.smoke())
    assert ct.head_dim == 80 and ct.padded_vocab == 50432


@pytest.mark.parametrize("mode", ["never", "always"])
def test_gqa_forward_value_and_input_grad(mode):
    cj = jget("stablelm-3b").smoke().replace(attn_chunk=128, head_dim=32, use_pallas=mode)
    ct = tget("stablelm-3b").smoke().replace(attn_chunk=128, head_dim=32, use_pallas=mode)
    D, H, KV, hd = ct.d_model, ct.num_heads, ct.num_kv_heads, ct.head_dim
    p = {"wq": _rand((D, H * hd), 0, 0.09), "wk": _rand((D, KV * hd), 1, 0.09),
         "wv": _rand((D, KV * hd), 2, 0.09), "wo": _rand((H * hd, D), 3, 0.09)}
    x = _rand((2, 128, D), 4, 0.3)
    pj = {k: to_jax(v) for k, v in p.items()}
    out_j, cache_j = ja.gqa_forward(pj, to_jax(x), cj)
    g_j = jax.grad(lambda xx: ja.gqa_forward(pj, xx, cj)[0].sum())(to_jax(x))

    pt = {k: to_torch(v) for k, v in p.items()}
    xt = to_torch(x).requires_grad_(True)
    trace.reset_counts()
    out_t, cache_t = ta.gqa_forward(pt, xt, ct)
    (g_t,) = torch.autograd.grad(out_t.sum(), xt)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(np32(g_t), np.asarray(g_j), **TOL)
    np.testing.assert_allclose(np32(cache_t["k"]), np.asarray(cache_j["k"]), **TOL)
    assert tuple(cache_t["v"].shape) == (2, 128, KV, hd)
    assert trace.counts("launch")["flash_attention"] == 0     # CPU tensors: no launch


def test_kernel_dispatch_rule():
    cfg = tget("stablelm-3b").smoke().replace(use_pallas="always")
    calls = []
    orig = ta._flash_pallas_cv
    ta._flash_pallas_cv = lambda *a: calls.append(1) or orig(*a)
    try:
        q = torch.zeros(1, 2, 128, 16)
        ta.flash_attention(q, q, q, cfg=cfg)                       # qualifies
        ta.flash_attention(q, q, q, cfg=cfg, window=8)             # window
        ta.flash_attention(q, q, q, cfg=cfg, q_offset=1)           # offset
        ta.flash_attention(q[:, :, :64], q, q, cfg=cfg)            # Sq % 128
        ta.flash_attention(q, q, q[..., :8], cfg=cfg)              # d_qk != d_v
        ta.flash_attention(q, q, q, cfg=cfg.replace(use_pallas="never"))
        ta.flash_attention(q, q, q, cfg=cfg.replace(use_pallas="auto"))   # CPU tensor
        ta.flash_attention(q, q, q)                                # no cfg
    finally:
        ta._flash_pallas_cv = orig
    assert len(calls) == 1
