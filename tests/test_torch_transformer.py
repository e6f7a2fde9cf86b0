"""The dense decoder as a whole: ``stablelm-3b``.smoke() (2 layers, d 128,
f32) with JAX-initialised parameters converted by ``params_from_jax``;
``loss_fn`` and the gradient of every leaf must match the JAX package."""
import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.models.registry import get_model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.models.convert import params_from_jax, tree_to_numpy
from repro_torch.models.registry import get_model as tmodel
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

# f32 end to end; two layers of matmuls and softmaxes whose summation
# order differs between XLA and ATen
TOL = dict(rtol=2e-4, atol=2e-4)


def _batch(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab_size, (2, S + 1))
    return {"tokens": stream[:, :-1].astype(np.int32), "labels": stream[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("S,mode", [(64, "never"), (128, "always")])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_leaf(S, mode, remat):
    kw = dict(use_pallas=mode, remat=remat)
    if mode == "always":
        kw["attn_chunk"] = 128
    cj = jget("stablelm-3b").smoke().replace(**kw)
    ct = tget("stablelm-3b").smoke().replace(**kw)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    batch = _batch(ct, S)

    (loss_j, met_j), grads_j = jax.value_and_grad(api_j.loss_fn, has_aux=True)(
        params_j, {k: to_jax(v) for k, v in batch.items()})

    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")
    (loss_t, met_t), grads_t = value_and_grad(
        api_t.loss_fn, params_t, {k: to_torch(v) for k, v in batch.items()})

    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(met_t["xent"]), float(met_j["xent"]), rtol=2e-4)
    assert float(met_t["aux"]) == 0.0
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tree_leaves(grads_t)
    paths = tree_paths(grads_t)
    assert len(flat_j) == len(flat_t) == 12
    for path, gj, gt in zip(paths, flat_j, flat_t):
        assert tuple(gt.shape) == gj.shape, path
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path, **TOL)
    # no leaf of the port's tree still asks for a gradient afterwards
    assert not any(p.requires_grad for p in tree_leaves(params_t))


def test_tree_order_paths_shapes_dtypes_match_jax():
    cj, ct = jget("stablelm-3b").smoke(), tget("stablelm-3b").smoke()
    params_j = jmodel(cj).init(jax.random.key(0))
    params_t = tmodel(ct).init(torch.Generator().manual_seed(0))
    jpaths = [".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(params_j)[0]]
    assert tree_paths(params_t) == jpaths
    for pj, pt in zip(jax.tree_util.tree_leaves(params_j), tree_leaves(params_t)):
        assert tuple(pt.shape) == pj.shape
        assert str(pt.dtype).split(".")[-1] == str(pj.dtype)
    # the stacked leading layer dim
    assert tuple(params_t["blocks"]["attn"]["wq"].shape) == (2, 128, 128)


def test_own_init_trains_and_bf16_runs():
    ct = tget("stablelm-3b").smoke().replace(dtype="bfloat16")
    api = tmodel(ct)
    params = api.init(torch.Generator().manual_seed(1))
    assert params["lm_head"]["w"].dtype == torch.bfloat16
    batch = {k: to_torch(v) for k, v in _batch(ct, 32).items()}
    (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
    assert loss.dtype == torch.float32 and np.isfinite(float(loss))
    assert abs(float(loss) - np.log(ct.vocab_size)) < 0.5          # near-uniform at init
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
               for g in tree_leaves(grads))


def test_convert_round_trip_and_bf16_cast():
    ct = tget("stablelm-3b").smoke().replace(dtype="bfloat16")
    cj = jget("stablelm-3b").smoke().replace(dtype="bfloat16")
    params_j = jmodel(cj).init(jax.random.key(2))
    as_np = jax_tree_to_numpy(params_j)                 # bf16 leaves travel as float32
    params_t = params_from_jax(as_np, ct, "cpu")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(params_t))
    back = tree_to_numpy(params_t)
    for a, b in zip(tree_leaves(as_np), tree_leaves(back)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)             # the cast is exact both ways


def test_serving_members_raise_and_other_families_wait():
    """The serving members run (their values are held to JAX by
    tests/test_torch_serve.py); a family the reference does not know raises
    its ``ValueError``, as do an ``ssm`` config without RWKV-6 and a
    ``hybrid`` one without Mamba layers; the ``moe`` family builds the
    decoder and the hybrid family Jamba's API."""
    ct = tget("stablelm-3b").smoke()
    api = tmodel(ct)
    params = api.init(torch.Generator().manual_seed(0))
    tokens = to_torch(_batch(ct, 16)["tokens"])
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": tokens})
        assert tuple(logits.shape) == (2, 1, ct.padded_vocab)
        assert tuple(cache["blocks"]["k"].shape) == (2, 2, 16, 2, 32)
        spec = api.cache_spec(2, 20)
        assert spec["blocks"]["v"] == ((2, 2, 20, 2, 32), torch.float32)
        cache = {"blocks": {k: torch.cat([v, v.new_zeros(2, 2, 4, 2, 32)], dim=2)
                            for k, v in cache["blocks"].items()}}
        step, cache2 = api.decode_step(params, {"tokens": tokens[:, :1]}, cache, 16)
    assert tuple(step.shape) == (2, 1, ct.padded_vocab) and cache2 is cache
    assert bool(cache["blocks"]["k"][:, :, 16].any()) and not bool(cache["blocks"]["k"][:, :, 17].any())
    with pytest.raises(ValueError, match="unknown family"):
        tmodel(ct.replace(family="cnn"))
    moe = tmodel(tget("moonshot-v1-16b-a3b").smoke())                # the decoder's MoE branch
    assert sorted(moe.init(None, device="meta")) == ["blocks", "embed", "final_norm",
                                                     "first_blocks", "lm_head"]
    # the hybrid family is Jamba now (its values: tests/test_torch_jamba.py)
    jamba = tmodel(tget("jamba-v0.1-52b").smoke())
    assert jamba.cfg.family == "hybrid"
    assert sorted(jamba.cache_spec(2, 20)) == [f"l{i}" for i in range(8)]
    assert "ssm" in jamba.init(None, device="meta")["blocks"]["l0"]
    with pytest.raises(ValueError, match="Jamba"):
        tmodel(ct.replace(family="hybrid"))                          # no Mamba config
    with pytest.raises(ValueError, match="RWKV-6"):
        tmodel(tget("rwkv6-1.6b").smoke().replace(ssm=ct.ssm))    # an ssm family without rwkv6
