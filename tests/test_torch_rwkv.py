"""RWKV-6 in the port against the JAX package on the same numpy inputs:
the WKV recurrence (``kernels.wkv``: the plain chunked form that CPU
tensors run, against ``rwkv.wkv_chunked`` and against the Pallas kernel in
interpret mode), and ``rwkv6-1.6b``.smoke() as a whole (loss and every
gradient leaf, f32, on parameters carried over by ``params_from_jax``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.kernels.wkv import wkv_pallas
from repro.models import rwkv as jr
from repro.models.registry import get_model as jmodel
from repro_torch.configs import get_config as tget
from repro_torch.kernels import wkv as twkv
from repro_torch.models import rwkv as tr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

# tests/test_model_kernels.py's tolerance for the WKV kernels: f32 sums in
# another order
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
# the whole model, f32: two layers of matmuls, norms and WKV whose summation
# order differs between XLA and ATen
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)


def _wkv_inputs(B, H, S, hd, seed):
    """(B, S, H, hd) numpy inputs, scaled as in tests/test_model_kernels.py."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, S, H, hd)) * 0.5).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.standard_normal((B, S, H, hd)) * 0.5 - 2.0)).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, logw, u, s0


def _bhsd(a):
    return to_torch(a).transpose(1, 2)


@pytest.mark.parametrize("B,H,S,hd,chunk", [
    (2, 3, 128, 64, 64), (1, 1, 64, 64, 64), (2, 2, 256, 32, 32), (1, 4, 192, 64, 64),
])
def test_wkv_plain_matches_chunked_and_pallas(B, H, S, hd, chunk):
    r, k, v, logw, u, s0 = _wkv_inputs(B, H, S, hd, B * 1000 + S)
    y_ref, s_ref = jr.wkv_chunked(*map(to_jax, (r, k, v, logw, u, s0)), chunk)
    tj = lambda a: to_jax(a).transpose(0, 2, 1, 3)
    y_pal, s_pal = wkv_pallas(tj(r), tj(k), tj(v), tj(logw), to_jax(u), to_jax(s0),
                              chunk=chunk, interpret=True)
    # the wrapper on CPU tensors runs the plain version
    y_t, s_t = twkv.wkv(_bhsd(r), _bhsd(k), _bhsd(v), _bhsd(logw), to_torch(u), to_torch(s0), chunk)
    assert tuple(y_t.shape) == (B, H, S, hd)
    np.testing.assert_allclose(np32(y_t.transpose(1, 2)), np.asarray(y_ref), **WKV_TOL)
    np.testing.assert_allclose(np32(s_t), np.asarray(s_ref), **WKV_TOL)
    np.testing.assert_allclose(np32(y_t), np.asarray(y_pal), **WKV_TOL)
    np.testing.assert_allclose(np32(s_t), np.asarray(s_pal), **WKV_TOL)


@pytest.mark.parametrize("S,chunk", [(37, 16), (1, 16), (48, 16)])
def test_wkv_ragged_and_single_step_match_chunked(S, chunk):
    """S % chunk != 0 runs as one chunk, as in the reference; S = 1 is a
    decode step."""
    r, k, v, logw, u, s0 = _wkv_inputs(2, 4, S, 16, S)
    y_ref, s_ref = jr.wkv_chunked(*map(to_jax, (r, k, v, logw, u, s0)), chunk)
    y_t, s_t = tr.wkv_chunked(*map(to_torch, (r, k, v, logw, u, s0)), chunk)
    np.testing.assert_allclose(np32(y_t), np.asarray(y_ref), **WKV_TOL)
    np.testing.assert_allclose(np32(s_t), np.asarray(s_ref), **WKV_TOL)


def test_wkv_state_chain():
    """Two half-sequence calls, the state carried, equal one call over the
    whole (tests/test_model_kernels.py::test_wkv_pallas_state_chain)."""
    rn, kn, vn, wn, un, sn = _wkv_inputs(1, 2, 128, 64, 7)
    r, k, v, logw = map(_bhsd, (rn, kn, vn, wn))
    u, s0 = to_torch(un), to_torch(sn)
    y_full, s_full = twkv.wkv(r, k, v, logw, u, s0, 64)
    h = 64
    y1, s1 = twkv.wkv(r[:, :, :h], k[:, :, :h], v[:, :, :h], logw[:, :, :h], u, s0, 64)
    y2, s2 = twkv.wkv(r[:, :, h:], k[:, :, h:], v[:, :, h:], logw[:, :, h:], u, s1, 64)
    np.testing.assert_allclose(np32(y_full[:, :, :h]), np32(y1), **WKV_TOL)
    np.testing.assert_allclose(np32(y_full[:, :, h:]), np32(y2), **WKV_TOL)
    np.testing.assert_allclose(np32(s_full), np32(s2), **WKV_TOL)


def test_wkv_wrapper_checks_its_inputs():
    z = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError):
        twkv.wkv(z, z, z, z[:, :, :4], torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError):
        twkv.wkv(z, z, z, z, torch.zeros(3, 16), torch.zeros(1, 2, 16, 16))
    with pytest.raises(ValueError):
        twkv.wkv(z.double(), z, z, z, torch.zeros(2, 16), torch.zeros(1, 2, 16, 16))


def test_config_and_tree_match_jax():
    cj, ct = jget("rwkv6-1.6b"), tget("rwkv6-1.6b")
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
    assert dataclasses.asdict(cj.smoke()) == dataclasses.asdict(ct.smoke())
    for cfg_j, cfg_t in [(cj.smoke(), ct.smoke()), (cj, ct)]:
        shapes_j = jax.eval_shape(jmodel(cfg_j).init, jax.random.key(0))
        tree_t = tmodel(cfg_t).init(None, device="meta")
        jpaths = [".".join(str(k.key) for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(shapes_j)[0]]
        assert tree_paths(tree_t) == jpaths
        for a, b in zip(tree_leaves(tree_t), jax.tree_util.tree_leaves(shapes_j)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
    full = tmodel(ct).init(None, device="meta")
    assert sum(int(p.numel()) for p in tree_leaves(full)) > 1.5e9     # 1.6 B parameters


def test_bf16_tree_keeps_the_f32_leaves_through_conversion():
    """params_from_jax takes each leaf's dtype from the port's own tree: a
    bf16 rwkv6 tree keeps w_decay, u_bonus, mix and mix_ch in float32, bit
    for bit."""
    cj = jget("rwkv6-1.6b").smoke().replace(dtype="bfloat16")
    ct = tget("rwkv6-1.6b").smoke().replace(dtype="bfloat16")
    params_j = jmodel(cj).init(jax.random.key(3))
    # move the f32 leaves off the bf16 grid, so a bf16 round trip would show
    for name in ("w_decay", "u_bonus", "mix"):
        leaf = params_j["blocks"]["rwkv"][name]
        params_j["blocks"]["rwkv"][name] = leaf + jnp.float32(1.0 / 3.0)
    params_j["blocks"]["cmix"]["mix_ch"] = params_j["blocks"]["cmix"]["mix_ch"] + jnp.float32(1e-3)
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    f32 = {"blocks.rwkv.w_decay", "blocks.rwkv.u_bonus", "blocks.rwkv.mix", "blocks.cmix.mix_ch"}
    for path, a, b in zip(tree_paths(params_t), tree_leaves(params_t),
                          jax.tree_util.tree_leaves(params_j)):
        want = torch.float32 if path in f32 else torch.bfloat16
        assert a.dtype == want, path
        assert str(b.dtype) == str(want).split(".")[-1], path
        np.testing.assert_array_equal(np32(a), np32(b), err_msg=path)


def _batch(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    stream = rng.integers(0, cfg.vocab_size, (2, S + 1))
    return {"tokens": stream[:, :-1].astype(np.int32), "labels": stream[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("S,mode,remat", [(64, "never", False), (64, "always", True),
                                          (40, "always", False)])
def test_loss_and_every_gradient_leaf(S, mode, remat):
    """use_pallas='always': JAX runs its Pallas kernel in interpret mode
    where S % chunk == 0 (and the chunked form elsewhere); the port runs
    its kernel's autograd Function, whose CPU forward is the plain version
    and whose backward is the chunked recompute."""
    kw = dict(use_pallas=mode, remat=remat)
    cj, ct = jget("rwkv6-1.6b").smoke().replace(**kw), tget("rwkv6-1.6b").smoke().replace(**kw)
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    batch = _batch(ct, S)
    (loss_j, met_j), grads_j = jax.value_and_grad(api_j.loss_fn, has_aux=True)(
        params_j, {k: to_jax(v) for k, v in batch.items()})
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct)
    trace.reset_counts()
    (loss_t, met_t), grads_t = value_and_grad(
        api_t.loss_fn, params_t, {k: to_torch(v) for k, v in batch.items()})
    assert trace.counts("launch")["wkv"] == 0                  # CPU tensors: no launch
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-5)
    np.testing.assert_allclose(float(met_t["xent"]), float(met_j["xent"]), rtol=2e-5)
    flat_j = jax.tree_util.tree_leaves(grads_j)
    flat_t = tree_leaves(grads_t)
    assert len(flat_j) == len(flat_t) == 20
    for path, gj, gt in zip(tree_paths(grads_t), flat_j, flat_t):
        assert tuple(gt.shape) == gj.shape, path
        # a leaf's gradient sums over batch, sequence and (for u_bonus, w_decay)
        # every WKV step: its summation noise scales with the leaf's magnitude
        scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
        np.testing.assert_allclose(np32(gt), np.asarray(gj), err_msg=path,
                                   rtol=MODEL_TOL["rtol"], atol=MODEL_TOL["atol"] * scale)


def test_time_mix_state_and_kernel_dispatch(monkeypatch):
    """time_mix returns the state JAX returns; on a CPU tensor the kernel
    path ('always') runs through the autograd Function, 'never' and 'auto'
    through the chunked form."""
    cj = jget("rwkv6-1.6b").smoke()
    ct = tget("rwkv6-1.6b").smoke()
    params_j = jmodel(cj).init(jax.random.key(1))
    lp_j = jax.tree_util.tree_map(lambda p: p[0], params_j["blocks"]["rwkv"])
    lp_t = {k: to_torch(np32(v)) for k, v in lp_j.items()}
    x = (np.random.default_rng(2).standard_normal((2, 16, ct.d_model)) * 0.5).astype(np.float32)
    out_j, st_j = jr.time_mix(lp_j, to_jax(x), cj)
    calls = []
    orig = tr._WkvKernelFn.apply
    monkeypatch.setattr(tr._WkvKernelFn, "apply", lambda *a: calls.append(1) or orig(*a))
    for mode in ("always", "never", "auto"):
        out_t, st_t = tr.time_mix(lp_t, to_torch(x), ct.replace(use_pallas=mode))
        np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **MODEL_TOL)
        np.testing.assert_allclose(np32(st_t["state"]), np.asarray(st_j["state"]), **MODEL_TOL)
        np.testing.assert_array_equal(np32(st_t["tm_x"]), np.asarray(st_j["tm_x"]))
    assert len(calls) == 1                                # only 'always' took the kernel path
