"""The GShard MoE block in the port against ``repro.models.moe`` on the same
numpy inputs (jamba-v0.1-52b smoke: 4 experts, top-2, f32): output, both
auxiliary losses and the gradients, with tokens dropped over capacity, with
exact router ties, with a shared expert and with bf16 dispatch tensors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.models import moe as jmoe
from repro_torch.configs import get_config as tget
from repro_torch.models import moe as tmoe

# f32 throughout; the dispatch is exact (one-hots), the rest is a few
# einsums whose summation order differs between XLA and ATen
TOL = dict(rtol=1e-5, atol=1e-5)
LEAVES = ["router", "wg", "wi", "wo"]


def _cfgs(**moe_kw):
    cj, ct = jget("jamba-v0.1-52b").smoke(), tget("jamba-v0.1-52b").smoke()
    extra = {k: moe_kw.pop(k) for k in ("bf16_stream",) if k in moe_kw}
    cj = cj.replace(moe=dataclasses.replace(cj.moe, **moe_kw), **extra)
    ct = ct.replace(moe=dataclasses.replace(ct.moe, **moe_kw), **extra)
    return cj, ct


def _params(cj, seed=0, tie=False):
    p_j = jmoe.init_moe(jax.random.key(seed), cj)
    if tie:
        # two identical router columns: experts 1 and 2 tie exactly on every token
        r = p_j["router"]
        p_j["router"] = r.at[:, 2].set(r[:, 1])
    p_t = jax.tree_util.tree_map(lambda a: to_torch(np32(a)), p_j)
    return p_j, p_t


def _x(cj, S, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, S, cj.d_model)) * 0.5).astype(np.float32)
    w = rng.standard_normal((2, S, cj.d_model)).astype(np.float32)      # cotangent
    return x, w


def _run_both(cj, ct, p_j, p_t, x, w):
    def f_j(p, xx):
        out, aux = jmoe.moe_block(p, xx, cj)
        loss = jnp.sum(out * to_jax(w)) + aux["load_balance"] + aux["router_z"]
        return loss, (out, aux)

    (_, (out_j, aux_j)), grads_j = jax.jit(jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True))(
        p_j, to_jax(x))
    xt = to_torch(x).requires_grad_(True)
    leaves = [p_t[k].requires_grad_(True) for k in LEAVES]
    out_t, aux_t = tmoe.moe_block(p_t, xt, ct)
    loss_t = torch.sum(out_t * to_torch(w)) + aux_t["load_balance"] + aux_t["router_z"]
    grads_t = torch.autograd.grad(loss_t, [xt] + leaves)
    return (out_j, aux_j, grads_j), (out_t, aux_t, grads_t)


def _dropped(cj, p_j, x):
    """Tokens the reference drops over capacity (as its moe_block ranks them)."""
    moe = cj.moe
    S = x.shape[1]
    C = min(jmoe.expert_capacity(moe, S), S)
    probs = jax.nn.softmax((to_jax(x) @ p_j["router"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, moe.top_k)
    sel = jax.nn.one_hot(idx, moe.num_experts).reshape(2, S * moe.top_k, moe.num_experts)
    pos = jnp.cumsum(sel, axis=1) - sel
    return int(jnp.sum((pos >= C) * sel))


@pytest.mark.parametrize("case", ["default", "drops", "no_drop", "shared", "bf16_stream"])
def test_moe_block_output_aux_and_gradients_match_jax(case):
    kw = {"default": {}, "drops": dict(capacity_factor=0.5), "no_drop": dict(capacity_factor=4.0),
          "shared": dict(num_shared_experts=1), "bf16_stream": dict(bf16_stream=True)}[case]
    cj, ct = _cfgs(**kw)
    p_j, p_t = _params(cj)
    x, w = _x(cj, 24, seed=1)
    if case == "drops":
        assert _dropped(cj, p_j, x) > 0
    if case == "no_drop":
        assert _dropped(cj, p_j, x) == 0
    (out_j, aux_j, (gp_j, gx_j)), (out_t, aux_t, grads_t) = _run_both(cj, ct, p_j, p_t, x, w)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    assert set(aux_t) == set(aux_j) == {"load_balance", "router_z"}
    for key in aux_j:
        np.testing.assert_allclose(float(aux_t[key].detach()), float(aux_j[key]), **TOL)
    np.testing.assert_allclose(np32(grads_t[0]), np.asarray(gx_j), **TOL)
    for name, g in zip(LEAVES, grads_t[1:]):
        gj = np.asarray(gp_j[name])
        scale = max(1.0, float(np.abs(gj).max()))
        np.testing.assert_allclose(np32(g), gj, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                                   err_msg=name)
    if case == "shared":
        assert "shared" in p_t


def test_exact_router_ties_keep_the_order_of_jax_top_k():
    """Experts 1 and 2 have identical router columns, so their probabilities
    tie on every token; the capacity ranking and the load-balance top-1 see
    the lower index first in both packages."""
    cj, ct = _cfgs(capacity_factor=0.75)
    p_j, p_t = _params(cj, seed=2, tie=True)
    x, w = _x(cj, 32, seed=3)
    probs = jax.nn.softmax((to_jax(x) @ p_j["router"]).astype(jnp.float32), axis=-1)
    assert bool(jnp.all(probs[..., 1] == probs[..., 2]))
    vals_j, idx_j = jax.lax.top_k(probs, 3)
    vals_t, idx_t = tmoe.top_k(to_torch(np.asarray(probs)), 3)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    # ties reach the top 2 on some tokens, and their order decides which drop
    tied_in_top2 = np.isin(np.asarray(idx_j[..., :2]), [1, 2]).all(-1)
    assert tied_in_top2.any() and _dropped(cj, p_j, x) > 0
    (out_j, aux_j, (_, gx_j)), (out_t, aux_t, grads_t) = _run_both(cj, ct, p_j, p_t, x, w)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(float(aux_t["load_balance"].detach()), float(aux_j["load_balance"]), **TOL)
    np.testing.assert_allclose(np32(grads_t[0]), np.asarray(gx_j), **TOL)


def test_top_k_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4], [0.3, 0.3, 0.4, 0.0]])
    vals, idx = tmoe.top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3], [2, 0]]
    _, idx_j = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(idx_j).tolist() == idx.tolist()


@pytest.mark.parametrize("S", [1, 7, 16, 4096])
def test_expert_capacity_and_init_match_jax(S):
    cj, ct = jget("jamba-v0.1-52b"), tget("jamba-v0.1-52b")
    assert tmoe.expert_capacity(ct.moe, S) == jmoe.expert_capacity(cj.moe, S)
    if S == 4096:
        assert tmoe.expert_capacity(ct.moe, S) == 640      # C at the serving shape
    shapes_j = jax.eval_shape(lambda k: jmoe.init_moe(k, cj, 2), jax.random.key(0))
    tree_t = tmoe.init_moe(None, ct, 2, device="meta")
    assert sorted(tree_t) == sorted(shapes_j)
    for key in tree_t:
        assert tuple(tree_t[key].shape) == shapes_j[key].shape
        assert str(tree_t[key].dtype).split(".")[-1] == str(shapes_j[key].dtype)
