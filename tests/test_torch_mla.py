"""MLA (DeepSeek-V2 multi-head latent attention) in the port against the JAX
package: deepseek-v2-236b's smoke config (one dense MLA layer in
``first_blocks``, one MoE layer; kv_lora 32, rope dim 16, 4 heads of 32,
f32) on parameters carried over by ``params_from_jax``:

- ``mla_forward`` and ``mla_decode`` alone, output and latent cache;
- the model's loss and every gradient leaf, the prefill logits, one decode
  step, decode equal to prefill over S + 1 and S + 3 tokens (capacity made
  drop-free);
- the latent cache's ``cache_spec`` / ``pad_cache`` / ``init_cache``;
- MLA never takes the flash kernel: its attention is called without
  ``cfg`` and its q/k dim (hd + R) is not its v dim (hd);
- the decode's latent scores divided by sqrt(hd + R) at deepseek-v2's
  hd + R = 192, bit for bit as JAX divides them op by op."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models.registry import get_model as jmodel, pad_cache as jpad
from repro_torch.configs import INPUT_SHAPES, get_config as tget
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel, pad_cache as tpad
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

ARCH = "deepseek-v2-236b"
# f32; the same tolerances as tests/test_torch_transformer.py (training) and
# tests/test_decode_consistency.py (serving)
TOL = dict(rtol=2e-4, atol=2e-4)
SERVE_TOL = dict(rtol=2e-3, atol=2e-3)
B, S = 2, 32


def _jpaths(tree):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@functools.lru_cache(maxsize=None)
def _models(no_drop=False, **kw):
    cj, ct = jget(ARCH).smoke().replace(**kw), tget(ARCH).smoke().replace(**kw)
    if no_drop:
        cj, ct = (c.replace(moe=dataclasses.replace(c.moe, capacity_factor=float(c.moe.num_experts)))
                  for c in (cj, ct))
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    return api_j, api_t, params_j, params_from_jax(jax_tree_to_numpy(params_j), ct)


def _layer_params(seed=0):
    cj = jget(ARCH).smoke()
    p_j = jattn.init_mla(jax.random.key(seed), cj)
    return cj, tget(ARCH).smoke(), p_j, jax.tree_util.tree_map(lambda a: to_torch(np32(a)), p_j)


def test_mla_forward_matches_jax():
    cj, ct, p_j, p_t = _layer_params()
    x = np.random.default_rng(0).standard_normal((B, S, cj.d_model)).astype(np.float32)
    out_j, cache_j = jax.jit(lambda p, xx: jattn.mla_forward(p, xx, cj))(p_j, to_jax(x))
    out_t, cache_t = tattn.mla_forward(p_t, to_torch(x), ct)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    assert sorted(cache_t) == ["c_kv", "k_rope"]
    assert tuple(cache_t["c_kv"].shape) == (B, S, 32) and tuple(cache_t["k_rope"].shape) == (B, S, 16)
    for key in cache_t:
        np.testing.assert_allclose(np32(cache_t[key]), np.asarray(cache_j[key]), **TOL)


@pytest.mark.parametrize("cache_index", [5, 19])
def test_mla_decode_matches_jax_and_writes_its_slot_in_place(cache_index):
    """The absorbed latent-space scores against JAX on the same cache; the new
    token's latent and rope key land in slot ``cache_index % W`` of the
    tensors passed in (a ring of W = 16 slots wraps at 19)."""
    cj, ct, p_j, p_t = _layer_params(1)
    rng = np.random.default_rng(cache_index)
    W = 16
    x = rng.standard_normal((B, 1, cj.d_model)).astype(np.float32)
    c_kv = rng.standard_normal((B, W, 32)).astype(np.float32)
    k_rope = rng.standard_normal((B, W, 16)).astype(np.float32)
    out_j, new_j = jax.jit(lambda p, xx, c, k, i: jattn.mla_decode(p, xx, {"c_kv": c, "k_rope": k},
                                                                   i, cj))(
        p_j, to_jax(x), to_jax(c_kv), to_jax(k_rope), jnp.asarray(cache_index, jnp.int32))
    cache_t = {"c_kv": to_torch(c_kv), "k_rope": to_torch(k_rope)}
    held = dict(cache_t)
    out_t, new_t = tattn.mla_decode(p_t, to_torch(x), cache_t, cache_index, ct)
    assert new_t is cache_t and all(new_t[k] is held[k] for k in held)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(np32(new_t[key]), np.asarray(new_j[key]), **TOL)
    slot = cache_index % W
    assert not np.array_equal(np32(new_t["c_kv"])[:, slot], c_kv[:, slot])
    untouched = [i for i in range(W) if i != slot]
    np.testing.assert_array_equal(np32(new_t["c_kv"])[:, untouched], c_kv[:, untouched])


def _mla_decode_divisor(monkeypatch) -> float:
    """What ``mla_decode`` hands ``_latent_on_shards`` to scale the scores
    by, at deepseek-v2's hd + R = 128 + 64 (its smoke widths otherwise)."""
    ct = tget(ARCH).smoke().replace(head_dim=128, mla_rope_dim=64)
    seen, real = [], tattn._latent_on_shards

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tattn, "_latent_on_shards", spy)
    params = tattn.init_mla(torch.Generator().manual_seed(0), ct)
    cache = {"c_kv": torch.zeros(1, 4, ct.mla_kv_lora), "k_rope": torch.zeros(1, 4, ct.mla_rope_dim)}
    tattn.mla_decode(params, torch.ones(1, 1, ct.d_model), cache, 0, ct)
    assert len(seen) == 1
    return seen[0]


def _scaled_latent_scores(s: np.ndarray, divisor: float, monkeypatch) -> np.ndarray:
    """The scores ``_latent_on_shards`` hands to the softmax when the summed
    scores are ``s``: one latent dim whose query is 1 and whose cache holds
    s, and rope keys of 0, so that the sum is s exactly."""
    seen, real = [], tattn._softmax_weigh

    def spy(scores, weigh, groups=()):
        seen.append(scores.clone())
        return real(scores, weigh, groups)

    monkeypatch.setattr(tattn, "_softmax_weigh", spy)
    W, R = s.size, 64
    tattn._latent_on_shards(torch.ones(1, 1, 1), torch.zeros(1, 1, R), to_torch(s).reshape(1, W, 1),
                            torch.zeros(1, W, R), W, divisor)
    return seen[0].reshape(-1).numpy()


def _latent_score_draws() -> np.ndarray:
    """65,536 N(0, 10^2) float32 scores and -4.338788032531738, whose
    quotient by sqrt(192) and product with its float32 reciprocal differ."""
    s = np.random.default_rng(0).normal(0.0, 10.0, 65536).astype(np.float32)
    return np.append(s, np.float32(-4.338788032531738))


def test_mla_decode_divides_its_latent_scores_as_jax(monkeypatch):
    """JAX's ``s / math.sqrt(hd + R)`` (``repro.models.attention.mla_decode``)
    taken op by op, against the port's scores through the divisor
    ``mla_decode`` passes and ``_latent_on_shards``' divide: equal bit for
    bit.  A multiply by the reciprocal differs by one ulp in 28,458 of the
    65,536 draws."""
    s = _latent_score_draws()
    ours = _scaled_latent_scores(s, _mla_decode_divisor(monkeypatch), monkeypatch)
    ref = np.asarray(jnp.divide(jnp.asarray(s), math.sqrt(192)))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    assert float(ours[-1]) == -0.3131250739097595


def test_mla_decode_scores_are_within_an_ulp_of_the_compiled_reference(monkeypatch):
    """Under ``jax.jit`` XLA folds a divide by a constant into a multiply by
    its float32 reciprocal (the compiled ``mla_decode`` holds the constant
    1/sqrt(hd + R)), so the compiled reference's scores are the
    reciprocal's: within one ulp of the port's divide."""
    s = _latent_score_draws()
    ours = _scaled_latent_scores(s, _mla_decode_divisor(monkeypatch), monkeypatch)
    compiled = np.asarray(jax.jit(lambda a: a / math.sqrt(192))(jnp.asarray(s)))
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - compiled.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_loss_and_every_gradient_leaf():
    api_j, api_t, params_j, params_t = _models()
    batch = SyntheticLM(api_t.cfg, INPUT_SHAPES["train_4k"].smoke(), seed=1).batch(0)
    (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(api_j.loss_fn, has_aux=True))(
        params_j, {k: to_jax(v) for k, v in batch.items()})
    (loss_t, met_t), grads_t = value_and_grad(api_t.loss_fn, params_t,
                                              {k: to_torch(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-4)
    np.testing.assert_allclose(float(met_t["aux"]), float(met_j["aux"]), **TOL)
    paths = tree_paths(grads_t)
    assert paths == _jpaths(grads_j)
    assert "first_blocks.attn.w_uk" in paths and "blocks.attn.ln_kv" in paths
    for path, gj, gt in zip(paths, jax.tree_util.tree_leaves(grads_j), tree_leaves(grads_t)):
        assert tuple(gt.shape) == gj.shape, path
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path, **TOL)


def test_prefill_decode_match_jax_and_equal_prefill():
    api_j, api_t, params_j, params_t = _models(no_drop=True)
    cfg = api_t.cfg
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
    prefill_j = jax.jit(api_j.prefill)
    logits_full_j, _ = prefill_j(params_j, {"tokens": to_jax(toks[:, :S + 1])})
    _, cache_j = prefill_j(params_j, {"tokens": to_jax(toks[:, :S])})
    step_j, _ = jax.jit(api_j.decode_step)(params_j, {"tokens": to_jax(toks[:, S:S + 1])},
                                           jpad(cache_j, S + 1), jnp.asarray(S, jnp.int32))
    with torch.inference_mode():
        logits_full_t, _ = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S + 1])})
        logits_3, _ = api_t.prefill(params_t, {"tokens": to_torch(toks)})
        _, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks[:, :S])})
        cache_t = tpad(cache_t, S + 3)
        steps = []
        for i in range(3):
            logits, cache_t = api_t.decode_step(
                params_t, {"tokens": to_torch(toks[:, S + i:S + i + 1])}, cache_t, S + i)
            steps.append(logits)
    np.testing.assert_allclose(np32(logits_full_t), np.asarray(logits_full_j), **SERVE_TOL)
    np.testing.assert_allclose(np32(steps[0]), np.asarray(step_j), **SERVE_TOL)
    a, b = np32(logits_full_t)[:, -1], np32(steps[0])[:, -1]
    np.testing.assert_allclose(a, b, **SERVE_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
    np.testing.assert_allclose(np32(logits_3)[:, -1], np32(steps[-1])[:, -1], **SERVE_TOL)


def test_latent_cache_spec_pad_and_init_match_jax():
    api_j, api_t, params_j, params_t = _models()
    toks = np.random.default_rng(2).integers(0, api_t.cfg.vocab_size, (B, S)).astype(np.int32)
    _, cache_j = jax.jit(api_j.prefill)(params_j, {"tokens": to_jax(toks)})
    with torch.inference_mode():
        _, cache_t = api_t.prefill(params_t, {"tokens": to_torch(toks)})
    assert tree_paths(cache_t) == _jpaths(cache_j) == [
        "blocks.c_kv", "blocks.k_rope", "first_blocks.c_kv", "first_blocks.k_rope"]
    for new_len in (S, S + 7):
        pj, pt = jpad(cache_j, new_len), tpad(cache_t, new_len)
        for path, a, b in zip(tree_paths(pt), tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
            assert tuple(a.shape) == b.shape and a.shape[2] == new_len, path
            np.testing.assert_allclose(np32(a), np32(b), err_msg=path, **SERVE_TOL)
    spec_j, spec_t = api_j.cache_spec(B, S + 7), api_t.cache_spec(B, S + 7)
    assert spec_t == {name: {key: (shape, torch.float32) for key, (shape, _) in layer.items()}
                      for name, layer in spec_j.items()}
    assert spec_t["blocks"]["c_kv"][0] == (1, B, S + 7, 32)
    assert spec_t["first_blocks"]["k_rope"][0] == (1, B, S + 7, 16)
    cache = ttr.init_cache(api_t.cfg, B, S + 7)
    assert tuple(cache["first_blocks"]["c_kv"].shape) == (1, B, S + 7, 32)
    assert not any(bool(t.any()) for t in tree_leaves(cache))
    windowed = ttr.cache_spec(api_t.cfg.replace(sliding_window=8), B, S + 7)
    assert windowed["blocks"]["k_rope"][0] == (1, B, 8, 16)


def test_mla_never_takes_the_flash_kernel(monkeypatch):
    """With ``use_pallas="always"`` the GQA path would take the kernel at
    S = 128; MLA's attention passes no ``cfg`` and has d_qk = 48 != d_v =
    32, so the kernel entry is never reached, as in JAX."""
    def refuse(*a, **k):
        raise AssertionError("MLA reached the flash kernel")

    monkeypatch.setattr(tattn, "_flash_pallas_cv", refuse)
    ct = tget(ARCH).smoke().replace(use_pallas="always", attn_chunk=128)
    api = tmodel(ct)
    params = api.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, ct.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": toks})
    assert bool(torch.isfinite(logits).all()) and tuple(cache["blocks"]["c_kv"].shape) == (1, 1, 128, 32)
    gqa = tmodel(tget("moonshot-v1-16b-a3b").smoke().replace(use_pallas="always", attn_chunk=128))
    with pytest.raises(AssertionError, match="flash kernel"), torch.inference_mode():
        gqa.prefill(gqa.init(torch.Generator().manual_seed(0)), {"tokens": toks})
