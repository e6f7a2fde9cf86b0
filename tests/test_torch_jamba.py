"""Jamba in the port against the JAX package on parameters carried over by
``params_from_jax`` (jamba-v0.1-52b smoke: one super-block of 8 layers,
f32): config and tree, the float32 leaves of a bf16 tree, ``loss_fn`` and
every gradient leaf, prefill logits and caches, one and three decode steps,
decode-equals-prefill, ``pad_cache`` on the hybrid cache, the ``--layers``
check, and the greedy tokens of ``launch.serve``."""
import argparse
import dataclasses
import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models.registry import get_model as jmodel, pad_cache as jpad
from repro_torch.configs import get_config as tget
from repro_torch.kernels import build
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import jamba as tj
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel, pad_cache as tpad
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

ARCH = "jamba-v0.1-52b"
B, S = 2, 32
# the whole model, f32: matmuls, norms, scans and MoE einsums whose
# summation order differs between XLA and ATen
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
# tests/test_decode_consistency.py's tolerance: the same function through a
# cache instead of one pass
TOL = dict(rtol=2e-3, atol=2e-3)


def _jpaths(tree):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _no_drop(cfg):
    """Capacity >= top_k * S, as tests/test_decode_consistency.py sets it:
    prefill drops over-capacity tokens where one decode token always fits."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


@functools.lru_cache(maxsize=None)
def _models(no_drop=False):
    cj, ct = jget(ARCH).smoke(), tget(ARCH).smoke()
    if no_drop:
        cj, ct = _no_drop(cj), _no_drop(ct)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    return api_j, api_t, params_j, params_t


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_config_and_tree_match_jax():
    cj, ct = jget(ARCH), tget(ARCH)
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert dataclasses.asdict(cj.smoke()) == dataclasses.asdict(ct.smoke())
    smoke = ct.smoke()
    assert (smoke.num_layers, smoke.moe.num_experts, smoke.ssm.d_state, smoke.ssm.chunk_size) == (8, 4, 8, 16)
    assert tj.block_layout(ct) == [("mamba", False), ("mamba", True), ("mamba", False), ("mamba", True),
                                   ("attn", False), ("mamba", True), ("mamba", False), ("mamba", True)]
    for cfg_j, cfg_t in [(cj.smoke(), ct.smoke()), (cj, ct)]:
        shapes_j = jax.eval_shape(jmodel(cfg_j).init, jax.random.key(0))
        tree_t = tmodel(cfg_t).init(None, device="meta")
        assert tree_paths(tree_t) == _jpaths(shapes_j)
        for path, a, b in zip(tree_paths(tree_t), tree_leaves(tree_t), jax.tree_util.tree_leaves(shapes_j)):
            assert tuple(a.shape) == b.shape, path
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path
    # one super-block at full width: the depth cut the card runs
    block = tmodel(ct.replace(num_layers=8)).init(None, device="meta")
    n = sum(int(p.numel()) for p in tree_leaves(block))
    assert 13.2e9 < n < 13.4e9


def test_bf16_tree_keeps_the_f32_leaves_through_conversion():
    """dt_bias, a_log and d_skip are float32 in a bf16 Jamba, in both
    packages, and params_from_jax carries them over bit for bit."""
    cj = jget(ARCH).smoke().replace(dtype="bfloat16")
    ct = tget(ARCH).smoke().replace(dtype="bfloat16")
    params_j = jmodel(cj).init(jax.random.key(3))
    ssm = params_j["blocks"]["l0"]["ssm"]
    ssm["dt_bias"] = ssm["dt_bias"] + jnp.float32(1.0 / 3.0)   # off the bf16 grid
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    f32 = ("ssm.dt_bias", "ssm.a_log", "ssm.d_skip")
    n_f32 = 0
    for path, a, b in zip(tree_paths(params_t), tree_leaves(params_t), jax.tree_util.tree_leaves(params_j)):
        want = torch.float32 if path.endswith(f32) else torch.bfloat16
        n_f32 += want == torch.float32
        assert a.dtype == want, path
        assert str(b.dtype) == str(want).split(".")[-1], path
        np.testing.assert_array_equal(np32(a), np32(b), err_msg=path)
    assert n_f32 == 3 * 7                                  # seven Mamba layers


@pytest.mark.parametrize("Sl,mode,remat", [(64, "never", False), (64, "always", True),
                                           (40, "always", False)])
def test_loss_and_every_gradient_leaf(Sl, mode, remat):
    """use_pallas='always': JAX runs its Pallas scan (and flash where the
    shape qualifies) in interpret mode; the port runs its kernels' autograd
    Functions, whose CPU forward is the plain version."""
    kw = dict(use_pallas=mode, remat=remat)
    cj, ct = jget(ARCH).smoke().replace(**kw), tget(ARCH).smoke().replace(**kw)
    api_j, api_t = jmodel(cj), tmodel(ct)
    _, _, params_j, _ = _models()
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    toks = _tokens(ct, Sl + 1, Sl)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, {k: to_jax(v) for k, v in batch.items()})
    build.reset_launch_counts()
    (loss_t, met_t), grads_t = value_and_grad(
        api_t.loss_fn, params_t, {k: to_torch(v) for k, v in batch.items()})
    assert all(c == 0 for c in build.launch_counts.values())    # CPU tensors: no launch
    for key in ("xent", "aux"):
        np.testing.assert_allclose(float(met_t[key]), float(met_j[key]), **MODEL_TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **MODEL_TOL)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tree_leaves(grads_t)
    assert len(flat_j) == len(flat_t) == 114
    for path, gj, gt in zip(tree_paths(grads_t), flat_j, flat_t):
        assert tuple(gt.shape) == gj.shape, path
        scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path,
                                   rtol=MODEL_TOL["rtol"], atol=MODEL_TOL["atol"] * scale)


def test_prefill_logits_caches_and_one_decode_step_match_jax():
    api_j, api_t, params_j, params_t = _models()
    toks = _tokens(api_t.cfg, S + 1, 1)

    @jax.jit
    def run_j(params, toks):
        logits, cache = api_j.prefill(params, {"tokens": toks[:, :S]})
        step, _ = api_j.decode_step(params, {"tokens": toks[:, S:]}, jpad(cache, S + 1),
                                    jnp.asarray(S, jnp.int32))
        return logits, cache, step

    logits_j, cache_j, step_j = run_j(params_j, to_jax(toks))
    with torch.inference_mode():
        logits_t, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        cache_copy = {name: {k: v.clone() for k, v in layer.items()} for name, layer in cache_t.items()}
        step_t, _ = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S:])},
                                      tpad(cache_copy, S + 1), S)
    assert tuple(logits_t.shape) == logits_j.shape == (B, 1, api_t.cfg.padded_vocab)
    np.testing.assert_allclose(np32(logits_t), np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(np32(step_t), np.asarray(step_j), **TOL)
    assert tree_paths(cache_t) == _jpaths(cache_j)
    for path, a, b in zip(tree_paths(cache_t), tree_leaves(cache_t), jax.tree_util.tree_leaves(cache_j)):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **TOL)


def test_decode_equals_prefill_and_three_steps():
    """With capacity >= top_k * S no token drops, so decoding token S against
    the cache equals a prefill over S + 1 tokens; three steps equal a
    prefill over S + 3.  decode_step writes the cache in place."""
    _, api_t, _, params_t = _models(no_drop=True)
    toks = _tokens(api_t.cfg, S + 3, 2)
    with torch.inference_mode():
        full1, _ = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S + 1])})
        full3, _ = api_t.prefill(params_t, {"tokens": to_torch(toks)})
        _, cache = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        cache = tpad(cache, S + 3)
        steps = []
        for i in range(3):
            logits, new = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S + i:S + i + 1])},
                                            cache, S + i)
            assert new is cache
            steps.append(logits)
    a, b = np32(full1)[:, -1], np32(steps[0])[:, -1]
    np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np32(full3)[:, -1], np32(steps[-1])[:, -1], **TOL)
    assert bool(cache["l4"]["k"][:, :, S + 2].any())      # the ring buffer got the new tokens


def test_three_decode_steps_match_jax():
    api_j, api_t, params_j, params_t = _models()
    toks = _tokens(api_t.cfg, S + 3, 5)

    @jax.jit
    def run_j(params, toks):
        _, cache = api_j.prefill(params, {"tokens": toks[:, :S]})
        cache = jpad(cache, S + 3)
        out = []
        for i in range(3):
            logits, cache = api_j.decode_step(params, {"tokens": toks[:, S + i:S + i + 1]}, cache,
                                              jnp.asarray(S + i, jnp.int32))
            out.append(logits)
        return jnp.concatenate(out, axis=1), cache

    logits_j, cache_j = run_j(params_j, to_jax(toks))
    with torch.inference_mode():
        _, cache = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        cache = tpad(cache, S + 3)
        out = []
        for i in range(3):
            logits, cache = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S + i:S + i + 1])},
                                              cache, S + i)
            out.append(logits)
    np.testing.assert_allclose(np32(torch.cat(out, dim=1)), np.asarray(logits_j), **TOL)
    for path, a, b in zip(tree_paths(cache), tree_leaves(cache), jax.tree_util.tree_leaves(cache_j)):
        np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **TOL)


def test_pad_cache_and_cache_spec_on_the_hybrid_tree():
    """pad_cache grows the stacked (nb, B, S, KV, hd) K/V on axis 2 and leaves
    the Mamba conv/ssm states alone, as JAX's does."""
    api_j, api_t, params_j, params_t = _models()
    toks = _tokens(api_t.cfg, S, 3)
    _, cache_j = jax.jit(api_j.prefill)(params_j, {"tokens": to_jax(toks)})
    with torch.inference_mode():
        _, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks)})
    for new_len in (S, S + 5):
        pj, pt = jpad(cache_j, new_len), tpad(cache_t, new_len)
        assert tree_paths(pt) == _jpaths(pj)
        for path, a, b in zip(tree_paths(pt), tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            assert tuple(a.shape) == b.shape, path
            np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **TOL)
    grown = tpad(cache_t, S + 5)
    for path, a, b in zip(tree_paths(grown), tree_leaves(grown), tree_leaves(cache_t)):
        if path.split(".")[-1] in ("k", "v"):
            assert a.shape[2] == S + 5 and a.shape[:2] == b.shape[:2], path
        else:
            assert a is b, path
    spec_j = api_j.cache_spec(B, S + 5)
    spec_t = api_t.cache_spec(B, S + 5)
    assert sorted(spec_t) == sorted(spec_j)
    for name in spec_t:
        for key, (shape, dtype) in spec_t[name].items():
            assert tuple(shape) == tuple(spec_j[name][key][0]), (name, key)
            assert str(dtype).split(".")[-1] == str(jnp.dtype(spec_j[name][key][1])), (name, key)
    cache0 = tj.init_cache(api_t.cfg, B, S + 5)
    assert tuple(cache0["l4"]["k"].shape) == (1, B, S + 5, 2, 32) and not bool(cache0["l0"]["ssm"].any())


@pytest.mark.parametrize("layers,ok", [(0, True), (8, True), (16, True), (4, False), (12, False),
                                       (-8, False)])
def test_layers_must_be_whole_super_blocks(layers, ok):
    """JAX floors num_layers // 8 and silently drops layers (--layers 4 would
    build no super-block at all); the port refuses."""
    args = ttrain.build_parser().parse_args(["--arch", ARCH, "--smoke", "--layers", str(layers)])
    if ok:
        cfg = ttrain.config_from_args(args)
        assert tj.n_super_blocks(cfg) == max(layers, 8) // 8
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            ttrain.config_from_args(args)
        with pytest.raises(ValueError):
            tj.n_super_blocks(tget(ARCH).replace(num_layers=layers))
        with pytest.raises(ValueError, match="multiple of 8"):
            tserve.main(["--arch", ARCH, "--smoke", "--layers", str(layers), "--device", "cpu"])


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


def test_serve_gives_the_greedy_tokens_of_jax(monkeypatch):
    """Same seed, same parameters (JAX's, carried over), same 32-token
    prompts: ``serve.run`` generates the tokens JAX's launcher generates,
    and ``serve.main`` draws its own parameters and runs on the CPU."""
    flags = dict(arch=ARCH, smoke=True, batch=2, prompt_len=32, gen=4, seed=0)
    rec = _RecordConcat()
    monkeypatch.setattr(jserve, "jnp", rec)
    out_j = jserve.run(argparse.Namespace(**flags))
    monkeypatch.undo()
    _, _, _, params_t = _models()
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "32", "--gen", "4",
            "--device", "cpu"]
    out_t = tserve.run(tserve.build_parser().parse_args(argv), params=params_t)
    for key in ("arch", "batch", "prompt_len", "generated"):
        assert out_t[key] == out_j[key]
    assert out_t["tokens"].shape == (2, 5) and out_t["prefill_logits"].shape == (2, 512)
    np.testing.assert_array_equal(out_t["tokens"], rec.seen[-1])
    out = tserve.main(argv)
    assert out["num_layers"] == 8 and out["tokens"].shape == (2, 5)
    assert np.isfinite(out["prefill_logits"]).all()


def test_serve_frees_its_parameters_on_return(monkeypatch):
    """No reference cycle holds the served model once ``serve.run`` returns:
    on the card its weights (26.6 GB for one Jamba super-block) must be free
    for the next run without waiting for the cycle collector."""
    refs = []
    real_get_model = tserve.get_model

    def get_model(cfg):
        api = real_get_model(cfg)

        def init(gen, device=None):
            params = api.init(gen, device=device)
            refs.extend(weakref.ref(leaf) for leaf in tree_leaves(params))
            return params

        return api._replace(init=init)

    monkeypatch.setattr(tserve, "get_model", get_model)
    gc.collect()
    gc.disable()
    try:
        tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "16", "--gen", "2",
                     "--device", "cpu"])
        alive = sum(r() is not None for r in refs)
    finally:
        gc.enable()
    assert len(refs) == 114 and alive == 0
