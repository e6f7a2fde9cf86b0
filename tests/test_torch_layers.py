"""``repro_torch.models.layers`` against ``repro.models.layers`` on the same
numpy inputs, f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

# f32 elementwise math on both sides; transcendental functions (rsqrt, cos,
# sin, exp) may differ in the last bits between XLA and ATen
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 7, 64), (3, 128)])
def test_rms_norm(shape):
    x, w = _rand(shape, 0), _rand(shape[-1:], 1)
    np.testing.assert_allclose(np32(tl.rms_norm(to_torch(x), to_torch(w), 1e-5)),
                               np.asarray(jl.rms_norm(to_jax(x), to_jax(w), 1e-5)), **TOL)


def test_rms_norm_bf16_keeps_dtype():
    x, w = _rand((2, 5, 32), 0), _rand((32,), 1)
    out = tl.rms_norm(to_torch(x, torch.bfloat16), to_torch(w, torch.bfloat16))
    ref = jl.rms_norm(to_jax(x, jnp.bfloat16), to_jax(w, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16: at most one bf16 step apart
    np.testing.assert_allclose(np32(out), np32(ref), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("offset", [0, 37])
def test_apply_rope_interleaved_pairs(offset):
    x = _rand((2, 4, 16, 32), 2)
    pos = offset + np.arange(16)
    out_t = tl.apply_rope(to_torch(x), to_torch(pos), 10000.0)
    out_j = jl.apply_rope(to_jax(x), to_jax(pos), 10000.0)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(np32(tl.rope_freqs(32, 10000.0)),
                               np.asarray(jl.rope_freqs(32, 10000.0)), rtol=1e-6)


def test_mlp_swiglu():
    p = {"wi": _rand((32, 64), 3, 0.2), "wg": _rand((32, 64), 4, 0.2), "wo": _rand((64, 32), 5, 0.2)}
    x = _rand((2, 9, 32), 6)
    out_t = tl.mlp({k: to_torch(v) for k, v in p.items()}, to_torch(x))
    out_j = jl.mlp({k: to_jax(v) for k, v in p.items()}, to_jax(x))
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)


@pytest.mark.parametrize("S,chunk,vocab,padded", [(64, 16, 500, 512), (10, 16, 512, 512),
                                                  (32, 32, 300, 512)])
def test_chunked_softmax_xent_with_vocab_padding(S, chunk, vocab, padded):
    x, head = _rand((2, S, 24), 7), _rand((24, padded), 8, 0.3)
    labels = np.random.default_rng(9).integers(0, vocab, (2, S)).astype(np.int32)
    out_t = tl.chunked_softmax_xent(to_torch(x), to_torch(head), to_torch(labels), chunk, vocab)
    out_j = jl.chunked_softmax_xent(to_jax(x), to_jax(head), to_jax(labels), chunk, vocab)
    np.testing.assert_allclose(float(out_t), float(out_j), rtol=1e-5)
    # padded columns are masked: changing them changes nothing
    head2 = head.copy()
    head2[:, vocab:] += 100.0
    out_t2 = tl.chunked_softmax_xent(to_torch(x), to_torch(head2), to_torch(labels), chunk, vocab)
    if vocab < padded:
        assert float(out_t2) == pytest.approx(float(out_t), rel=1e-6)


def test_init_statistics_and_meta():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, (256, 512), torch.float32)
    assert abs(float(w.std()) - 0.88 / 16) < 0.01 and float(w.abs().max()) <= 2.0 / 16 + 1e-6
    e = tl.embed_init(gen, (1000, 64), torch.float32)
    assert abs(float(e.std()) - 0.02) < 2e-3
    h = tl.dense_init(gen, (64, 1000), torch.bfloat16, scale=0.02)
    assert h.dtype == torch.bfloat16 and float(h.float().abs().max()) <= 0.04 + 1e-3
    m = tl.dense_init(None, (3, 8, 8), torch.bfloat16, device="meta")
    assert m.device.type == "meta" and tuple(m.shape) == (3, 8, 8)
    p = tl.init_mlp(gen, 8, 16, torch.float32, n_layers=3)
    assert tl.count_params(p) == 3 * 3 * 8 * 16
    assert tuple(p["wo"].shape) == (3, 16, 8)
