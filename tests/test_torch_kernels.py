"""The port's plain kernel versions (what its wrappers run on CPU tensors)
against the JAX package: the same numpy inputs go through
``repro.kernels.ops`` (Pallas, interpret mode) and through
``repro_torch.kernels``.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``."""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attn import flash_attention_pallas
from repro.kernels.topk_mask import topk_mask_2d as jtopk_mask_2d
from repro_torch.kernels import ops as tops
from repro_torch.kernels.flash_attn import (check_kernel_shape, flash_attention_cuda,
                                            flash_attention_plain)
from repro_torch.kernels.probe import probe_copy_2d, probe_copy_2d_plain
from repro_torch.kernels.quantize import BLOCK, dequantize_int8_2d, dequantize_int8_2d_plain
from repro_torch.kernels.topk_mask import topk_mask_2d, topk_mask_2d_plain
from repro_torch.utils import trace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))    # benchmarks/

PAD = BLOCK * 64
SHAPES = [(PAD,), (PAD * 3,), (999,), (1, 1), (123, 45), (BLOCK,), (2 * BLOCK + 17,)]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_matches_jax(shape, dtype):
    x = _rand(shape, 0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    q_j, s_j, n_j = jops.quantize_int8(to_jax(x, jd))
    q_t, s_t, n_t = tops.quantize_int8(to_torch(x, td))
    assert n_t == n_j == x.size
    assert tuple(q_t.shape) == q_j.shape and tuple(s_t.shape) == s_j.shape
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    # f32: same IEEE division and round-half-even, so the codes are equal.
    # bf16 inputs sit on exact .5 ties after the upcast, where the two
    # frameworks' division may differ in the last bit: one step allowed,
    # as tests/test_kernels.py allows it.
    atol_q = 1 if dtype == "bfloat16" else 0
    diff = np.abs(np32(q_t).astype(np.int32) - np.asarray(q_j, np.int32))
    assert diff.max() <= atol_q
    np.testing.assert_allclose(np32(s_t), np.asarray(s_j), rtol=1e-6)


def test_quantize_int8_rounds_half_to_even():
    # amax = 127 makes the scale exactly 1, so half-integers are exact ties
    x = np.arange(BLOCK, dtype=np.float32) * 0.5 - 60.0
    x[0] = 127.0
    q_j, s_j, _ = jops.quantize_int8(to_jax(x))
    q_t, s_t, _ = tops.quantize_int8(to_torch(x))
    assert float(s_t[0, 0]) == float(s_j[0, 0]) == 1.0
    np.testing.assert_array_equal(np32(q_t), np.asarray(q_j))
    assert np32(q_t)[0, 1:6].tolist() == [-60, -59, -58, -58, -58]     # -59.5 -> -60, -58.5 -> -58


@pytest.mark.parametrize("shape", SHAPES)
def test_ternarize_matches_jax(shape):
    x = _rand(shape, 1)
    t_j, s_j, n_j = jops.ternarize(to_jax(x))
    t_t, s_t, n_t = tops.ternarize(to_torch(x))
    assert n_t == n_j
    # exact: an element could only flip if |x| sat within an ulp of the row
    # mean, which these seeds do not produce
    np.testing.assert_array_equal(np32(t_t), np.asarray(t_j))
    np.testing.assert_allclose(np32(s_t), np.asarray(s_j), rtol=1e-6)
    assert set(np.unique(np32(t_t))) <= {-1, 0, 1}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("codec", ["int8", "ternary"])
def test_decode_matches_jax_bit_for_bit(shape, codec):
    """The same codes and scales (the JAX encoder's) through both decoders:
    ``float32(q) * scale`` is one rounded product, so the bits agree."""
    x = _rand(shape, 7)
    enc, dec = ((jops.quantize_int8, jops.dequantize_int8) if codec == "int8"
                else (jops.ternarize, jops.deternarize))
    q_j, s_j, n = enc(to_jax(x))
    out_j = np.asarray(dec(q_j, s_j, n))
    tdec = tops.dequantize_int8 if codec == "int8" else tops.deternarize
    out_t = tdec(to_torch(np.asarray(q_j)), to_torch(np.asarray(s_j)), n)
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == out_j.shape == (x.size,)
    np.testing.assert_array_equal(np32(out_t).view(np.int32), out_j.view(np.int32))
    plain = tdec(to_torch(np.asarray(q_j)), to_torch(np.asarray(s_j)), n, use_kernel=False)
    assert torch.equal(plain, out_t)


def test_dequantize_takes_any_int8_code():
    rng = np.random.default_rng(8)
    q = rng.integers(-128, 128, (64, BLOCK)).astype(np.int8)
    s = rng.standard_normal((64, 1)).astype(np.float32)
    s[:4, 0] = [0.0, 1e-30, 1e30, -2.5]
    from repro.kernels.quantize import dequantize_int8_2d as jdeq
    out_j = np.asarray(jdeq(to_jax(q), to_jax(s), interpret=True))
    out_t = dequantize_int8_2d(to_torch(q), to_torch(s))
    np.testing.assert_array_equal(np32(out_t).view(np.int32), out_j.view(np.int32))
    assert torch.equal(out_t, dequantize_int8_2d_plain(to_torch(q), to_torch(s)))


@pytest.mark.parametrize("rows", [64, 128])
def test_probe_copy_plain_matches_the_pallas_probe(rows):
    from benchmarks.kernel_bench import probe_copy_2d as jprobe
    x = _rand((rows, BLOCK), rows)
    x[0, :3] = [np.nan, -0.0, np.inf]
    out_j = np.asarray(jprobe(to_jax(x), interpret=True))
    out_t = probe_copy_2d(to_torch(x))
    np.testing.assert_array_equal(np32(out_t).view(np.int32), out_j.view(np.int32))
    assert torch.equal(probe_copy_2d_plain(to_torch(x)).view(torch.int32), out_t.view(torch.int32))


def test_decode_and_probe_validate_inputs():
    q, s = torch.zeros(4, BLOCK, dtype=torch.int8), torch.ones(4, 1)
    with pytest.raises(ValueError):
        dequantize_int8_2d(q.float(), s)                  # codes must be int8
    with pytest.raises(ValueError):
        dequantize_int8_2d(q[:, :128], s)                 # rows of 256
    with pytest.raises(ValueError):
        dequantize_int8_2d(q, torch.ones(3, 1))           # one scale per row
    with pytest.raises(ValueError):
        dequantize_int8_2d(q, s.double())
    with pytest.raises(ValueError):
        dequantize_int8_2d(torch.zeros(BLOCK, 4, dtype=torch.int8).t(), s)   # not contiguous
    with pytest.raises(ValueError):
        probe_copy_2d(torch.zeros(4, 128))
    with pytest.raises(ValueError):
        probe_copy_2d(torch.zeros(4, BLOCK, dtype=torch.float64))
    with pytest.raises(ValueError):
        probe_copy_2d(torch.zeros(BLOCK, 4).t())


@pytest.mark.parametrize("k", [1, 2, 8, 16])
@pytest.mark.parametrize("n", [2048, 5000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_add_matches_jax(k, n, dtype):
    x = _rand((k, n), 3)
    out_j = jops.fused_add(to_jax(x, getattr(jnp, dtype)))
    out_t = tops.fused_add(to_torch(x, getattr(torch, dtype)))
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == (n,)
    # f32 accumulation on both sides; only the order of the K additions differs
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("n", [4096, 100_000])
@pytest.mark.parametrize("sample", [0, 1 << 10])
def test_topk_sparsify_matches_jax_bit_for_bit(ratio, n, sample):
    """The ratios and sizes of tests/test_kernels.py::test_topk_sparsify; the
    same threshold (k-th largest |x| of the same strided sample) and the
    same mask, so the outputs are equal."""
    x = _rand((n,), 2)
    out_j = jops.topk_sparsify(to_jax(x), ratio, sample=sample)
    out_t = tops.topk_sparsify(to_torch(x), ratio, sample=sample)
    np.testing.assert_array_equal(np32(out_t), np.asarray(out_j))
    kept = int((out_t != 0).sum())
    if not sample:
        assert kept == max(int(ratio * n), 1)            # no ties among these floats


@pytest.mark.parametrize("shape", [(123, 45), (3, 5, 7), (BLOCK,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_sparsify_keeps_shape_and_dtype(shape, dtype):
    x = _rand(shape, 4)
    out_j = jops.topk_sparsify(to_jax(x, getattr(jnp, dtype)), 0.1)
    out_t = tops.topk_sparsify(to_torch(x, getattr(torch, dtype)), 0.1)
    assert tuple(out_t.shape) == shape and out_t.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(np32(out_t), np32(out_j))


def test_topk_threshold_and_mask_match_the_reference():
    x = _rand((5000,), 5)
    for ratio in (0.001, 0.02, 1.0):
        thr_t = tops.topk_threshold(to_torch(x), ratio)
        assert thr_t.dim() == 0 and thr_t.dtype == torch.float32
        assert float(thr_t) == float(jref.topk_threshold(to_jax(x), ratio))
    rows = _rand((128, BLOCK), 6)
    rows[0, :4] = [np.nan, 0.0, -0.0, 1e30]
    for thr in (0.0, 0.7, np.inf):
        want = jtopk_mask_2d(to_jax(rows), jnp.float32(thr), interpret=True)
        got = topk_mask_2d(to_torch(rows), torch.tensor(thr, dtype=torch.float32))   # CPU: plain
        np.testing.assert_array_equal(np32(got), np.asarray(want))
        assert not np.isnan(np32(got)).any()              # |NaN| >= thr is false
    # a Python number works as the threshold, and the dtype is kept
    bf = to_torch(rows, torch.bfloat16)
    assert topk_mask_2d_plain(bf, 0.5).dtype == torch.bfloat16


def test_ops_pad_unit_and_shapes():
    q, s, n = tops.quantize_int8(torch.ones(999))
    assert tuple(q.shape) == (64, BLOCK) and tuple(s.shape) == (64, 1) and n == 999
    assert float(q.reshape(-1)[999:].abs().sum()) == 0.0     # zero padding
    rows, n = tops._to_rows(torch.arange(PAD + 1, dtype=torch.float32))
    assert tuple(rows.shape) == (128, BLOCK) and n == PAD + 1


def test_all_zero_rows():
    q, s, _ = tops.quantize_int8(torch.zeros(BLOCK))
    assert float(s[0]) == 1.0 and int(q.abs().sum()) == 0
    t, s, _ = tops.ternarize(torch.zeros(BLOCK))
    assert float(s[0]) == 0.0 and int(t.abs().sum()) == 0


FLASH_CASES = [
    # BH, Sq, hd, causal, Hq, Hkv     (first four: tests/test_model_kernels.py)
    (4, 256, 64, True, 1, 1), (2, 128, 64, False, 1, 1), (1, 512, 32, True, 1, 1),
    (3, 128, 128, True, 1, 1), (2, 128, 80, True, 1, 1), (8, 128, 32, True, 4, 2),
    (8, 128, 32, False, 4, 2),
]


@pytest.mark.parametrize("BH,Sq,hd,causal,H,KV", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(BH, Sq, hd, causal, H, KV):
    rng = np.random.default_rng(BH * 31 + Sq + hd)
    q = rng.standard_normal((BH, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((BH // H * KV, Sq, hd)).astype(np.float32)
    v = rng.standard_normal((BH // H * KV, Sq, hd)).astype(np.float32)
    out_j = flash_attention_pallas(to_jax(q), to_jax(k), to_jax(v), causal=causal,
                                   n_heads=H, n_kv_heads=KV, interpret=True)
    # on CPU tensors the wrapper takes the plain version
    out_t = flash_attention_cuda(to_torch(q), to_torch(k), to_torch(v), causal=causal,
                                 n_heads=H, n_kv_heads=KV)
    # 2e-3 as in tests/test_model_kernels.py: online softmax in blocks vs one
    # dense softmax, f32
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), rtol=2e-3, atol=2e-3)
    # and against a dense softmax written out here
    g = H // KV
    rows = [(b // H) * KV + (b % H) // g for b in range(BH)]
    s = np.einsum("bqd,bkd->bqk", q, k[rows]) / math.sqrt(hd)
    if causal:
        s = np.where(np.tril(np.ones((Sq, Sq), bool)), s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v[rows])
    np.testing.assert_allclose(np32(out_t), ref, rtol=2e-3, atol=2e-3)


def test_flash_plain_bf16_keeps_dtype():
    rng = np.random.default_rng(5)
    q, k, v = (to_torch(rng.standard_normal((2, 128, 64)).astype(np.float32), torch.bfloat16)
               for _ in range(3))
    out = flash_attention_plain(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
    # the only difference is the final rounding to bf16 (2^-8 relative)
    np.testing.assert_allclose(np32(out), np32(ref), rtol=1e-2, atol=1e-2)


# (Sq, Skv, hd, causal) of every call chip_smoke.py makes of the CUDA kernels
FLASH_KERNEL_SHAPES = [
    (256, 256, 64, True), (128, 128, 64, False), (512, 512, 32, True), (128, 128, 128, True),
    (256, 256, 80, True), (1024, 1024, 128, True), (512, 512, 80, False), (192, 192, 72, True),
    (4096, 4096, 80, True), (64, 64, 80, True), (192, 192, 96, True),
    (256, 256, 128, True), (256, 256, 32, True), (128, 320, 80, False), (192, 64, 128, False),
    (4096, 4096, 128, True),
]


@pytest.mark.parametrize("Sq,Skv,hd,causal", FLASH_KERNEL_SHAPES)
def test_flash_kernel_takes_chip_smoke_shapes(Sq, Skv, hd, causal):
    check_kernel_shape(Sq, Skv, hd, causal)


@pytest.mark.parametrize("Sq,Skv,hd,causal", [
    (64, 64, 136, True),      # hd above 128
    (64, 64, 84, True),       # hd not a multiple of 8
    (96, 96, 64, True),       # S not a multiple of 64
    (64, 128, 64, True),      # causal with Sq != Skv
    (128, 0, 64, False),
])
def test_flash_kernel_refuses_shapes(Sq, Skv, hd, causal):
    with pytest.raises(ValueError):
        check_kernel_shape(Sq, Skv, hd, causal)


def test_flash_cpu_branch_takes_any_shape():
    """On CPU tensors the wrapper runs the plain version, whatever the shape."""
    rng = np.random.default_rng(3)
    q, k, v = (to_torch(rng.standard_normal((2, 96, 84)).astype(np.float32)) for _ in range(3))
    trace.reset_counts()
    out = flash_attention_cuda(q, k, v, causal=True)
    assert trace.counts("launch")["flash_attention"] == 0
    torch.testing.assert_close(out, flash_attention_plain(q, k, v, causal=True))


def test_wrappers_validate_inputs():
    with pytest.raises(ValueError):
        tops._q.quantize_int8_2d(torch.zeros(4, 128))
    with pytest.raises(ValueError):
        tops._q.ternarize_2d(torch.zeros(4, BLOCK, dtype=torch.float64))
    with pytest.raises(ValueError):
        tops._fa.fused_add_2d(torch.zeros(65, 8))
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros(4, 64, 32), torch.zeros(3, 64, 32),
                             torch.zeros(3, 64, 32), n_heads=4, n_kv_heads=2)
    with pytest.raises(ValueError):
        topk_mask_2d(torch.zeros(10), 0.0)
    with pytest.raises(ValueError):
        topk_mask_2d(torch.zeros(4, 4, dtype=torch.float64), 0.0)


def test_cpu_path_launches_no_kernel():
    trace.reset_counts()
    tops.quantize_int8(torch.ones(10))
    tops.ternarize(torch.ones(10))
    tops.fused_add(torch.ones(2, 10))
    tops.topk_sparsify(torch.ones(10), 0.5)
    from repro_torch.kernels.wkv import wkv
    wkv(*(torch.zeros(1, 2, 3, 8) for _ in range(4)), torch.zeros(2, 8), torch.zeros(1, 2, 8, 8))
    from repro_torch.kernels.ssm_scan import ssm_scan
    ssm_scan(torch.ones(1, 3, 4, 8), torch.ones(1, 3, 4, 8), torch.ones(1, 3, 4), torch.zeros(1, 4, 8))
    q, s, n = tops.quantize_int8(torch.ones(10))
    tops.dequantize_int8(q, s, n)
    tops.deternarize(q, s, n)
    probe_copy_2d(torch.ones(64, BLOCK))
    assert trace.counts("launch") == {} and trace.counts("route") == {}
