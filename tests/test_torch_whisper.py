"""Whisper (the encoder-decoder family) in the port against the JAX package:
whisper-base's smoke config (2 encoder and 2 decoder layers, 32 frames,
d_model 128, f32) on parameters carried over by ``params_from_jax``, the
same seeded numpy frames and tokens:

- the loss and every gradient leaf, with and without remat;
- the prefill logits, one decode step, decode equal to prefill over S + 1
  tokens, and the flat cache ``{k, v, xk, xv}`` with ``cache_spec`` and
  ``pad_cache`` (only the self-attention ring buffer grows);
- bfloat16 weights with float32 frames: JAX promotes, so the encoder's
  output and the cross-attention K/V are float32 and the self-attention
  cache bf16; the port returns the same dtypes and values;
- ``serve.run``'s greedy tokens against JAX's launcher;
- which attention may take the flash kernel: the decoder's self-attention
  only."""
import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import whisper as jwh
from repro.models.registry import get_model as jmodel, pad_cache as jpad
from repro_torch.configs import INPUT_SHAPES, get_config as tget
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import whisper as twh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel, pad_cache as tpad
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

ARCH = "whisper-base"
# f32; the tolerances of tests/test_torch_transformer.py (training) and
# tests/test_decode_consistency.py (serving)
TOL = dict(rtol=2e-4, atol=2e-4)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
# bf16 weights: a bf16 ulp is 2^-8 of a value, and two layers of bf16
# products round in XLA's and ATen's orders
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
B, S = 2, 32


def _jpaths(tree):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _models(**kw):
    cj, ct = jget(ARCH).smoke().replace(**kw), tget(ARCH).smoke().replace(**kw)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    return api_j, api_t, params_j, params_from_jax(jax_tree_to_numpy(params_j), ct)


def _frames(cfg, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_leaf(remat):
    api_j, api_t, params_j, params_t = _models(remat=remat)
    batch = SyntheticLM(api_t.cfg, INPUT_SHAPES["train_4k"].smoke(), seed=1).batch(0)
    assert batch["frames"].shape == (2, 32, 128)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, {k: to_jax(v) for k, v in batch.items()})
    (loss_t, met_t), grads_t = value_and_grad(api_t.loss_fn, params_t,
                                              {k: to_torch(v) for k, v in batch.items()})
    assert sorted(met_t) == sorted(met_j) == ["xent"]
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    paths = tree_paths(grads_t)
    assert paths == _jpaths(grads_j)
    assert "dec_blocks.xattn.wk" in paths and "enc_norm.w" in paths
    for path, gj, gt in zip(paths, jax.tree_util.tree_leaves(grads_j), tree_leaves(grads_t)):
        assert tuple(gt.shape) == gj.shape, path
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path, **TOL)


def test_prefill_decode_match_jax_and_equal_prefill():
    api_j, api_t, params_j, params_t = _models()
    cfg = api_t.cfg
    toks, frames = _tokens(cfg, S + 1, 1), _frames(cfg)
    fj, ft = to_jax(frames), to_torch(frames)
    prefill_j = jax.jit(api_j.prefill)
    logits_full_j, _ = prefill_j(params_j, {"tokens": to_jax(toks), "frames": fj})
    logits_j, cache_j = prefill_j(params_j, {"tokens": to_jax(toks[:, :S]), "frames": fj})
    step_j, _ = jax.jit(api_j.decode_step)(params_j, {"tokens": to_jax(toks[:, S:])},
                                           jpad(cache_j, S + 1), jnp.asarray(S, jnp.int32))
    with torch.inference_mode():
        logits_full_t, _ = api_t.prefill(params_t, {"tokens": to_torch(toks), "frames": ft})
        logits_t, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S]), "frames": ft})
        padded = tpad(cache_t, S + 1)
        step_t, cache2 = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S:])}, padded, S)
    assert cache2 is padded
    assert tree_paths(cache_t) == _jpaths(cache_j) == ["k", "v", "xk", "xv"]
    for path, a, b in zip(tree_paths(cache_t), tree_leaves(cache_t),
                          jax.tree_util.tree_leaves(cache_j)):
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **SERVE_TOL)
    np.testing.assert_allclose(np32(logits_t), np.asarray(logits_j), **SERVE_TOL)
    np.testing.assert_allclose(np32(logits_full_t), np.asarray(logits_full_j), **SERVE_TOL)
    np.testing.assert_allclose(np32(step_t), np.asarray(step_j), **SERVE_TOL)
    a, b = np32(logits_full_t)[:, -1], np32(step_t)[:, -1]
    np.testing.assert_allclose(a, b, **SERVE_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_bf16_dtypes_follow_jax_promotion():
    """bf16 weights, f32 frames.  JAX: encoder output f32, ``k``/``v`` bf16,
    ``xk``/``xv`` f32, logits bf16; ``cache_spec`` says bf16 for all four
    (a state of the reference).  The port: the same dtypes and values."""
    api_j, api_t, params_j, params_t = _models(dtype="bfloat16")
    cfg = api_t.cfg
    toks, frames = _tokens(cfg, S, 2), _frames(cfg)
    enc_j = jax.jit(lambda p, f: jwh.encode(p, f, api_j.cfg))(params_j, to_jax(frames))
    enc_t = twh.encode(params_t, to_torch(frames), cfg)
    assert str(enc_j.dtype) == "float32" and enc_t.dtype == torch.float32
    # the encoder is f32 arithmetic on bf16 weights: f32 tolerances hold
    np.testing.assert_allclose(np32(enc_t.detach()), np.asarray(enc_j), **TOL)
    logits_j, cache_j = jax.jit(api_j.prefill)(params_j, {"tokens": to_jax(toks),
                                                          "frames": to_jax(frames)})
    with torch.inference_mode():
        logits_t, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks),
                                                     "frames": to_torch(frames)})
    want = {"k": "bfloat16", "v": "bfloat16", "xk": "float32", "xv": "float32"}
    assert {k: str(v.dtype) for k, v in cache_j.items()} == want
    assert {k: str(v.dtype).split(".")[-1] for k, v in cache_t.items()} == want
    for key in want:
        tol = BF16_TOL if want[key] == "bfloat16" else TOL
        np.testing.assert_allclose(np32(cache_t[key]), np32(cache_j[key]), err_msg=key, **tol)
    assert logits_t.dtype == torch.bfloat16 and str(logits_j.dtype) == "bfloat16"
    np.testing.assert_allclose(np32(logits_t), np32(logits_j), **BF16_TOL)
    spec = api_t.cache_spec(B, S + 4)
    assert {k: str(d).split(".")[-1] for k, (_, d) in spec.items()} == {k: "bfloat16" for k in want}
    # the decode step takes the prefill's f32 cross cache as it is
    with torch.inference_mode():
        step, _ = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, :1])},
                                    tpad(cache_t, S + 1), S)
    step_j, _ = jax.jit(api_j.decode_step)(params_j, {"tokens": to_jax(toks[:, :1])},
                                           jpad(cache_j, S + 1), jnp.asarray(S, jnp.int32))
    np.testing.assert_allclose(np32(step), np32(step_j), **BF16_TOL)


def test_bf16_gradients_flow_to_bf16_leaves():
    _, api_t, _, params_t = _models(dtype="bfloat16")
    batch = {k: to_torch(v) for k, v in
             SyntheticLM(api_t.cfg, INPUT_SHAPES["train_4k"].smoke(), seed=3).batch(0).items()}
    (loss, _), grads = value_and_grad(api_t.loss_fn, params_t, batch)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads))


def test_pad_cache_grows_only_the_self_attention_ring_and_spec_matches_jax():
    api_j, api_t, params_j, params_t = _models()
    cfg = api_t.cfg
    toks, frames = _tokens(cfg, S, 3), _frames(cfg)
    with torch.inference_mode():
        _, cache = api_t.prefill(params_t, {"tokens": to_torch(toks), "frames": to_torch(frames)})
    grown = tpad(cache, S + 6)
    assert tuple(grown["k"].shape) == (2, B, S + 6, 2, 32) == tuple(grown["v"].shape)
    assert tuple(grown["xk"].shape) == (2, B, 32, 2, 32) and grown["xv"] is cache["xv"]
    assert not bool(grown["k"][:, :, S:].any())
    spec_j, spec_t = api_j.cache_spec(B, S + 6), api_t.cache_spec(B, S + 6)
    assert sorted(spec_t) == sorted(spec_j)
    for key, (shape, dtype) in spec_j.items():
        assert spec_t[key][0] == shape
        assert str(spec_t[key][1]).split(".")[-1] == str(jnp.dtype(dtype))


class _RecordConcat:
    """Stands in for ``jnp`` inside ``repro.launch.serve`` and keeps the
    token matrix that its ``run`` concatenates (it does not return it)."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def concatenate(self, xs, axis=0):
        out = jnp.concatenate(xs, axis=axis)
        self.seen.append(np.asarray(out))
        return out


def test_serve_run_gives_the_greedy_tokens_of_jax(monkeypatch):
    """Same seed, same parameters (JAX's, carried over), same prompts and
    frames (drawn after the tokens from one stream): the same tokens."""
    flags = dict(arch=ARCH, smoke=True, batch=2, prompt_len=32, gen=4, seed=0)
    rec = _RecordConcat()
    monkeypatch.setattr(jserve, "jnp", rec)
    out_j = jserve.run(argparse.Namespace(**flags))
    monkeypatch.undo()
    _, _, _, params_t = _models()
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "32", "--gen", "4",
            "--device", "cpu"]
    out_t = tserve.run(tserve.build_parser().parse_args(argv), params=params_t)
    assert out_t["arch"] == out_j["arch"] and out_t["tokens"].shape == (2, 5)
    np.testing.assert_array_equal(out_t["tokens"], rec.seen[-1])


def test_only_the_decoder_self_attention_may_take_the_flash_kernel(monkeypatch):
    """With ``use_pallas="always"`` and S = 128: the decoder's self-attention
    (one call a layer) reaches the kernel entry; the encoder's
    self-attention and the cross-attention (no ``cfg``) stay plain."""
    calls = []

    def record(q, k, v, causal):
        calls.append((tuple(q.shape), causal))
        return tattn._flash_reference(q, k, v, causal)

    monkeypatch.setattr(tattn, "_flash_pallas_cv", record)
    ct = tget(ARCH).smoke().replace(use_pallas="always", attn_chunk=128)
    api = tmodel(ct)
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, ct.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    frames = torch.randn(1, ct.encoder_seq, ct.d_model, generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        logits, _ = api.prefill(params, {"tokens": toks, "frames": frames})
    assert calls == [((1, 4, 128, 32), True)] * ct.num_layers
    assert bool(torch.isfinite(logits).all())
