"""The decoder families of the port against the JAX package: the dense
configs command-r-35b and deepseek-coder-33b, the MoE configs arctic-480b
(128 experts, a shared one) and moonshot-v1-16b-a3b (a leading dense layer,
``first_blocks``), and the VLM internvl2-2b (prefix embeddings).  Smoke
configs (2 layers, widths of at most 128, f32) with JAX-initialised
parameters carried over by ``params_from_jax``, the same seeded numpy
inputs on both sides:

- ``loss_fn`` and every gradient leaf; the MoE auxiliary losses and the
  router's gradients under remat;
- the prefill logits, one decode step, and decode equal to prefill over
  S + 1 tokens (capacity made drop-free, as tests/test_decode_consistency.py
  does);
- two int8 train steps through ``make_train_step`` against the JAX trainer;
- ``serve.run``'s greedy tokens for the VLM (the prefix counts in the cache
  position), the VLM in bfloat16, ``cache_spec`` / ``pad_cache`` with a
  ``first_blocks`` stack, the ``--layers`` refusal for MoE;
- every architecture of the reference's registry: the port builds it with
  JAX's key paths, shapes and dtypes at full size."""
import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import CommConfig as JComm, INPUT_SHAPES as JSHAPES, get_config as jget
from repro.configs.archs import ALL_ARCHS as JALL_ARCHS
from repro.data.pipeline import SyntheticLM as JData
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models.registry import get_model as jmodel, pad_cache as jpad
from repro.optim.optimizers import get_optimizer as jopt
from repro.optim.schedule import get_schedule as jsched
from repro_torch.configs import CommConfig, INPUT_SHAPES, get_config as tget
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.data.pipeline import SyntheticLM, device_put_batch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel, pad_cache as tpad
from repro_torch.optim.optimizers import get_optimizer as topt
from repro_torch.optim.schedule import get_schedule as tsched
from repro_torch.parallel.collectives import InProcessWorld
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

ARCHS = ["command-r-35b", "deepseek-coder-33b", "arctic-480b", "moonshot-v1-16b-a3b",
         "internvl2-2b"]
MOE = ["arctic-480b", "moonshot-v1-16b-a3b"]
# f32 end to end, two layers of matmuls, softmaxes and the MoE einsums whose
# summation order differs between XLA and ATen (tests/test_torch_transformer.py)
TOL = dict(rtol=2e-4, atol=2e-4)
# serving: tests/test_decode_consistency.py's tolerance (the same function
# through a cache instead of one pass)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 32


def _jpaths(tree):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _no_drop(cfg):
    """Capacity of every token: prefill drops over-capacity tokens while a
    single decode token always fits (tests/test_decode_consistency.py)."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=float(cfg.moe.num_experts)))


@functools.lru_cache(maxsize=None)
def _models(arch, no_drop=False, **kw):
    cj, ct = jget(arch).smoke().replace(**kw), tget(arch).smoke().replace(**kw)
    if no_drop:
        cj, ct = _no_drop(cj), _no_drop(ct)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    return api_j, api_t, params_j, params_t


def _serve_batch(cfg, toks, seed=5):
    """Tokens plus the VLM's prefix embeddings (seeded normal floats)."""
    batch = {"tokens": toks}
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed)
        batch["prefix_embeds"] = rng.standard_normal(
            (toks.shape[0], cfg.prefix_embeds, cfg.d_model)).astype(np.float32)
    return batch


def _both(batch):
    return ({k: to_jax(v) for k, v in batch.items()}, {k: to_torch(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf(arch):
    api_j, api_t, params_j, params_t = _models(arch)
    batch = SyntheticLM(api_t.cfg, INPUT_SHAPES["train_4k"].smoke(), seed=1).batch(0)
    assert ("prefix_embeds" in batch) == (arch == "internvl2-2b")
    bj, bt = _both(batch)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, bj)
    (loss_t, met_t), grads_t = value_and_grad(api_t.loss_fn, params_t, bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(met_t["xent"]), float(met_j["xent"]), rtol=2e-4)
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]), **TOL)
    assert (float(met_t["aux"]) > 0) == (arch in MOE)
    assert tree_paths(grads_t) == _jpaths(grads_j)
    for path, gj, gt in zip(tree_paths(grads_t), jax.tree_util.tree_leaves(grads_j),
                            tree_leaves(grads_t)):
        assert tuple(gt.shape) == gj.shape, path
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path, **TOL)


@pytest.mark.parametrize("arch", MOE + ["deepseek-v2-236b"])
def test_moe_aux_losses_and_router_gradients_under_remat(arch):
    """Under remat the checkpointed layers carry the auxiliary losses out with
    the residual stream: the loss, ``aux`` and the router's gradients equal
    JAX's remat run, and the port's own run without remat (deepseek-v2: with
    MLA and a ``first_blocks`` stack)."""
    api_j, api_t, params_j, params_t = _models(arch, remat=True)
    plain_t = tmodel(api_t.cfg.replace(remat=False))
    bj, bt = _both(SyntheticLM(api_t.cfg, INPUT_SHAPES["train_4k"].smoke(), seed=2).batch(0))
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, bj)
    (loss_t, met_t), grads_t = value_and_grad(api_t.loss_fn, params_t, bt)
    (loss_p, met_p), grads_p = value_and_grad(plain_t.loss_fn, params_t, bt)
    assert float(met_t["aux"]) > 1e-3
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]), **TOL)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    assert float(met_t["aux"]) == float(met_p["aux"]) and float(loss_t) == float(loss_p)
    router_j = np.asarray(grads_j["blocks"]["moe"]["router"])
    router_t = grads_t["blocks"]["moe"]["router"]
    assert float(router_t.abs().max()) > 0
    np.testing.assert_allclose(np32(router_t), router_j, **TOL)
    assert torch.equal(router_t, grads_p["blocks"]["moe"]["router"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_one_decode_step_match_jax_and_equal_prefill(arch):
    api_j, api_t, params_j, params_t = _models(arch, no_drop=True)
    cfg = api_t.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    n_cached = S + (cfg.prefix_embeds if cfg.family == "vlm" else 0)
    full_j, full_t = _both(_serve_batch(cfg, toks))
    part_j, part_t = _both(_serve_batch(cfg, toks[:, :S]))
    prefill_j = jax.jit(api_j.prefill)
    logits_full_j, _ = prefill_j(params_j, full_j)
    logits_j, cache_j = prefill_j(params_j, part_j)
    step_j, _ = jax.jit(api_j.decode_step)(params_j, {"tokens": to_jax(toks[:, S:])},
                                           jpad(cache_j, n_cached + 1),
                                           jnp.asarray(n_cached, jnp.int32))
    with torch.inference_mode():
        logits_full_t, _ = api_t.prefill(params_t, full_t)
        logits_t, cache_t = api_t.prefill(params_t, part_t)
        step_t, cache2 = api_t.decode_step(params_t, {"tokens": to_torch(toks[:, S:])},
                                           tpad(cache_t, n_cached + 1), n_cached)
    assert tuple(logits_t.shape) == logits_j.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(np32(logits_t), np.asarray(logits_j), **SERVE_TOL)
    np.testing.assert_allclose(np32(logits_full_t), np.asarray(logits_full_j), **SERVE_TOL)
    np.testing.assert_allclose(np32(step_t), np.asarray(step_j), **SERVE_TOL)
    # decoding token S against the cache equals prefill over S + 1 tokens
    a, b = np32(logits_full_t)[:, -1], np32(step_t)[:, -1]
    np.testing.assert_allclose(a, b, **SERVE_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    # the new token went into slot n_cached of every stack, in place
    for name, layer in cache2.items():
        leaf = layer["k"]
        assert bool(leaf[:, :, n_cached].any()), name


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "internvl2-2b"])
def test_three_decode_steps_equal_prefill(arch):
    _, api_t, _, params_t = _models(arch, no_drop=True)
    cfg = api_t.cfg
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    n_cached = S + (cfg.prefix_embeds if cfg.family == "vlm" else 0)
    with torch.inference_mode():
        logits_full, _ = api_t.prefill(params_t, _both(_serve_batch(cfg, toks))[1])
        _, cache = api_t.prefill(params_t, _both(_serve_batch(cfg, toks[:, :S]))[1])
        cache = tpad(cache, n_cached + 3)
        for i in range(3):
            logits, cache = api_t.decode_step(
                params_t, {"tokens": to_torch(toks[:, S + i:S + i + 1])}, cache, n_cached + i)
    np.testing.assert_allclose(np32(logits_full)[:, -1], np32(logits)[:, -1], **SERVE_TOL)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "internvl2-2b"])
def test_two_int8_train_steps_match_jax(arch):
    """Two explicit-comm int8 AdamW steps of ``make_train_step`` against the
    JAX trainer on the same smoke parameters and batches (the VLM's carry
    its prefix embeddings)."""
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")
    data = SyntheticLM(ct, INPUT_SHAPES["train_4k"].smoke(), seed=0)
    comm_kw = dict(mode="explicit", compression="int8")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    opt_j, opt_t = jopt("adamw"), topt("adamw")
    step_j = jax.jit(jtrain.make_train_step(api_j, opt_j, mesh, JComm(**comm_kw),
                                            jsched("cosine", 3e-4, 5, 20), clip_norm=1.0))
    step_t = ttrain.make_train_step(api_t, opt_t, InProcessWorld(1), CommConfig(**comm_kw),
                                    tsched("cosine", 3e-4, 5, 20), clip_norm=1.0)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    for step in range(2):
        batch = data.batch(step)
        with mesh:
            params_j, state_j, met_j = step_j(params_j, state_j,
                                              {k: to_jax(v) for k, v in batch.items()})
        params_t, state_t, met_t = step_t(params_t, state_t, device_put_batch(batch, "cpu"))
        # rtol 1e-3 as tests/test_torch_train.py (Adam turns last-bit gradient
        # differences into parameter differences of about 1e-4)
        np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]), rtol=1e-3, atol=1e-6)


def test_synthetic_vlm_batches_identical():
    cj, ct = jget("internvl2-2b").smoke(), tget("internvl2-2b").smoke()
    bj = JData(cj, JSHAPES["train_4k"].smoke(), seed=3).batch(4)
    bt = SyntheticLM(ct, INPUT_SHAPES["train_4k"].smoke(), seed=3).batch(4)
    assert set(bj) == set(bt) == {"tokens", "labels", "prefix_embeds"}
    assert bt["prefix_embeds"].shape == (2, 8, 128) and bt["prefix_embeds"].dtype == np.float32
    for k in bj:
        np.testing.assert_array_equal(bj[k], bt[k])


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


def test_serve_run_gives_the_greedy_tokens_of_jax_for_the_vlm(monkeypatch):
    """Same seed, same parameters (JAX's, carried over), same prompts and
    prefix embeddings: the decode steps count the 8 prefix positions in the
    cache, so the port generates JAX's tokens."""
    flags = dict(arch="internvl2-2b", smoke=True, batch=2, prompt_len=32, gen=4, seed=0)
    rec = _RecordConcat()
    monkeypatch.setattr(jserve, "jnp", rec)
    out_j = jserve.run(argparse.Namespace(**flags))
    monkeypatch.undo()
    _, _, _, params_t = _models("internvl2-2b")
    argv = ["--arch", "internvl2-2b", "--smoke", "--batch", "2", "--prompt-len", "32",
            "--gen", "4", "--device", "cpu"]
    out_t = tserve.run(tserve.build_parser().parse_args(argv), params=params_t)
    assert out_t["tokens"].shape == (2, 5)
    np.testing.assert_array_equal(out_t["tokens"], rec.seen[-1])


def test_bf16_vlm_logits_and_cache_dtypes_match_jax():
    """bfloat16 weights with float32 prefix embeddings: both cast the prefix
    to the stream's dtype before the concatenation, so every cache leaf is
    bf16; the logits agree within bf16 rounding (tolerance 3e-2: a bf16 ulp
    is 2^-8 of a value, and two layers of bf16 products round in XLA's and
    ATen's orders)."""
    _, api_t, params_j, params_t = _models("internvl2-2b", dtype="bfloat16")
    api_j = jmodel(jget("internvl2-2b").smoke().replace(dtype="bfloat16"))
    cfg = api_t.cfg
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bj, bt = _both(_serve_batch(cfg, toks))
    logits_j, cache_j = jax.jit(api_j.prefill)(params_j, bj)
    with torch.inference_mode():
        logits_t, cache_t = api_t.prefill(params_t, bt)
    assert logits_t.dtype == torch.bfloat16 and str(logits_j.dtype) == "bfloat16"
    assert tree_paths(cache_t) == _jpaths(cache_j) == ["blocks.k", "blocks.v"]
    for a, b in zip(tree_leaves(cache_t), jax.tree_util.tree_leaves(cache_j)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype) == "bfloat16"
        assert tuple(a.shape) == b.shape == (2, B, S + cfg.prefix_embeds, 2, 32)
        np.testing.assert_allclose(np32(a), np32(b), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(np32(logits_t), np32(logits_j), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "internvl2-2b"])
def test_pad_cache_and_cache_spec_match_jax(arch):
    api_j, api_t, params_j, params_t = _models(arch)
    cfg = api_t.cfg
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    bj, bt = _both(_serve_batch(cfg, toks))
    _, cache_j = jax.jit(api_j.prefill)(params_j, bj)
    with torch.inference_mode():
        _, cache_t = api_t.prefill(params_t, bt)
    n = S + (cfg.prefix_embeds if cfg.family == "vlm" else 0)
    for new_len in (n, n + 5):
        pj, pt = jpad(cache_j, new_len), tpad(cache_t, new_len)
        assert tree_paths(pt) == _jpaths(pj)
        for path, a, b in zip(tree_paths(pt), tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            assert tuple(a.shape) == b.shape and a.shape[2] == new_len, path
            np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **SERVE_TOL)
    spec_j = api_j.cache_spec(B, n + 5)
    spec_t = api_t.cache_spec(B, n + 5)
    assert sorted(spec_t) == sorted(spec_j)
    for name in spec_j:
        for key, (shape, dtype) in spec_j[name].items():
            assert spec_t[name][key][0] == shape
            assert str(spec_t[name][key][1]).split(".")[-1] == str(jnp.dtype(dtype))
    zeros = ttr.init_cache(cfg, B, n + 5)
    assert {k: {kk: tuple(v.shape) for kk, v in d.items()} for k, d in zeros.items()} == \
        {k: {kk: s for kk, (s, _) in d.items()} for k, d in spec_t.items()}
    if arch == "moonshot-v1-16b-a3b":
        assert sorted(cache_t) == ["blocks", "first_blocks"]
        assert cache_t["first_blocks"]["k"].shape[0] == 1 and cache_t["blocks"]["k"].shape[0] == 1


@pytest.mark.parametrize("layers,ok", [(0, True), (1, False), (2, True), (48, True)])
def test_moe_layers_must_exceed_the_leading_dense_layers(layers, ok):
    """moonshot-v1-16b-a3b has one leading dense layer: a depth of 1 would
    leave JAX an MoE stack of no layers, built but never run.  The launchers
    and the model refuse it."""
    args = ttrain.build_parser().parse_args(["--arch", "moonshot-v1-16b-a3b", "--smoke",
                                             "--layers", str(layers)])
    if ok:
        cfg = ttrain.config_from_args(args)
        assert cfg.num_layers == (layers or 2)
        params = tmodel(cfg).init(None, device="meta")
        assert params["blocks"]["moe"]["router"].shape[0] == cfg.num_layers - 1
    else:
        with pytest.raises(ValueError, match="moe.first_dense"):
            ttrain.config_from_args(args)
        with pytest.raises(ValueError, match="moe.first_dense"):
            tserve.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--layers", "1",
                         "--device", "cpu", "--gen", "1"])
        with pytest.raises(ValueError, match="first_dense"):
            tmodel(tget("moonshot-v1-16b-a3b").smoke().replace(num_layers=1)).init(
                None, device="meta")


def test_train_main_runs_the_moe_trainer_on_the_cpu():
    out = ttrain.main(["--arch", "moonshot-v1-16b-a3b", "--smoke", "--steps", "2",
                       "--comm-mode", "explicit", "--compression", "int8", "--device", "cpu"])
    assert out["arch"] == "moonshot-v1-16b-a3b-smoke" and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


def test_the_registry_lists_the_reference_architectures():
    assert ALL_ARCHS == JALL_ARCHS


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_architecture_builds_with_the_key_paths_shapes_and_dtypes_of_jax(arch):
    """Full size, no values: ``jax.eval_shape`` of the reference's ``init``
    against the port's ``init`` on the meta device."""
    cfg_j, cfg_t = jget(arch), tget(arch)
    shapes_j = jax.eval_shape(jmodel(cfg_j).init, jax.random.key(0))
    params_t = tmodel(cfg_t).init(None, device="meta")
    assert tree_paths(params_t) == _jpaths(shapes_j)
    for path, a, b in zip(tree_paths(params_t), tree_leaves(params_t),
                          jax.tree_util.tree_leaves(shapes_j)):
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
