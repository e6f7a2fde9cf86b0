"""The Mamba mixer in the port against the JAX package on the same numpy
inputs: the selective scan (``kernels.ssm_scan``: the plain recurrence
that CPU tensors run, against ``ssm_scan_pallas`` in interpret mode and
against ``mamba._ssm_scan_chunked``), the three plain scan variants against
their JAX twins, and ``mamba_mixer`` / ``mamba_decode`` with their
gradients (jamba-v0.1-52b smoke, f32)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.kernels.ssm_scan import ssm_scan_pallas
from repro.models import mamba as jm
from repro_torch.configs import get_config as tget
from repro_torch.kernels import build
from repro_torch.kernels import ssm_scan as tss
from repro_torch.models import mamba as tm

# tests/test_model_kernels.py's tolerance for the scan kernel and the mixer:
# f32 sums in another order
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# the plain variants against their JAX twins: the same f32 recurrence, a
# scan tree of another shape
TWIN_TOL = dict(rtol=1e-5, atol=1e-5)
MIXER_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_NAMES = ["a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "w_bcdt", "w_dt", "w_in", "w_out"]


def _scan_inputs(B, S, di, n, seed):
    """Model layout (B, S, di, n), scaled as in tests/test_model_kernels.py."""
    rng = np.random.default_rng(seed)
    decay = (1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, di, n))))).astype(np.float32)
    bx = (rng.standard_normal((B, S, di, n)) * 0.3).astype(np.float32)
    c_t = (rng.standard_normal((B, S, n)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((B, di, n)) * 0.1).astype(np.float32)
    return decay, bx, c_t, h0


def _kernel_layout(a):
    """(B, S, di, n) numpy -> a contiguous (B, S, n, di) tensor."""
    return to_torch(np.ascontiguousarray(np.swapaxes(a, -1, -2)))


@pytest.mark.parametrize("B,S,di,n,chunk,di_block", [
    (2, 256, 256, 16, 64, 128), (1, 128, 128, 8, 128, 128), (2, 192, 512, 16, 64, 256),
])
def test_ssm_scan_matches_pallas_and_chunked(B, S, di, n, chunk, di_block):
    decay, bx, c_t, h0 = _scan_inputs(B, S, di, n, S + di)
    states, h_ref = jm._ssm_scan_chunked(to_jax(decay), to_jax(bx), to_jax(h0), chunk)
    y_ref = jnp.einsum("bsdn,bsn->bsd", states, to_jax(c_t))
    tr = lambda a: to_jax(a).transpose(0, 1, 3, 2)
    y_pal, h_pal = ssm_scan_pallas(tr(decay), tr(bx), to_jax(c_t), to_jax(h0).transpose(0, 2, 1),
                                   chunk=chunk, di_block=di_block, interpret=True)
    args = (_kernel_layout(decay), _kernel_layout(bx), to_torch(c_t), _kernel_layout(h0[:, None])[:, 0])
    views = (to_torch(decay).transpose(2, 3), to_torch(bx).transpose(2, 3), to_torch(c_t),
             to_torch(h0).transpose(1, 2))                # the model's layout, read through strides
    for y_t, h_t in (tss.ssm_scan_plain(*args, chunk=chunk), tss.ssm_scan(*args, chunk=chunk),
                     tss.ssm_scan(*views, chunk=chunk)):
        assert tuple(y_t.shape) == (B, S, di) and tuple(h_t.shape) == (B, n, di)
        assert y_t.dtype == h_t.dtype == torch.float32
        np.testing.assert_allclose(np32(y_t), np.asarray(y_ref), **SCAN_TOL)
        np.testing.assert_allclose(np32(h_t.transpose(1, 2)), np.asarray(h_ref), **SCAN_TOL)
        np.testing.assert_allclose(np32(y_t), np.asarray(y_pal), **SCAN_TOL)
        np.testing.assert_allclose(np32(h_t), np.asarray(h_pal), **SCAN_TOL)


@pytest.mark.parametrize("S", [1, 37])
def test_ssm_scan_single_step_and_ragged_match_chunked(S):
    """S = 1 is a decode step; S % chunk != 0 runs as one chunk in JAX."""
    decay, bx, c_t, h0 = _scan_inputs(2, S, 64, 16, S)
    states, h_ref = jm._ssm_scan_chunked(to_jax(decay), to_jax(bx), to_jax(h0), 16)
    y_ref = jnp.einsum("bsdn,bsn->bsd", states, to_jax(c_t))
    y_t, h_t = tss.ssm_scan(to_torch(decay).transpose(2, 3), to_torch(bx).transpose(2, 3),
                            to_torch(c_t), to_torch(h0).transpose(1, 2))
    np.testing.assert_allclose(np32(y_t), np.asarray(y_ref), **SCAN_TOL)
    np.testing.assert_allclose(np32(h_t.transpose(1, 2)), np.asarray(h_ref), **SCAN_TOL)


def test_ssm_scan_state_chain():
    """Two calls that carry h equal one call over both halves."""
    decay, bx, c_t, h0 = (_kernel_layout(a) if a.ndim == 4 else to_torch(a)
                          for a in _scan_inputs(1, 128, 64, 16, 7))
    h0 = h0.transpose(1, 2).contiguous()
    y, h = tss.ssm_scan(decay, bx, c_t, h0)
    y1, h1 = tss.ssm_scan(decay[:, :64], bx[:, :64], c_t[:, :64], h0)
    y2, h2 = tss.ssm_scan(decay[:, 64:], bx[:, 64:], c_t[:, 64:], h1)
    np.testing.assert_allclose(np32(torch.cat([y1, y2], dim=1)), np32(y), **SCAN_TOL)
    np.testing.assert_allclose(np32(h2), np32(h), **SCAN_TOL)
    empty_y, same_h = tss.ssm_scan(decay[:, :0], bx[:, :0], c_t[:, :0], h0)
    assert tuple(empty_y.shape) == (1, 0, 64) and torch.equal(same_h, h0)


def test_ssm_scan_wrapper_checks_its_inputs():
    z = torch.zeros(1, 4, 8, 16)
    c, h = torch.zeros(1, 4, 8), torch.zeros(1, 8, 16)
    with pytest.raises(ValueError):
        tss.ssm_scan(z, z[:, :2], c, h)
    with pytest.raises(ValueError):
        tss.ssm_scan(z, z, c[:, :, :4], h)
    with pytest.raises(ValueError):
        tss.ssm_scan(z, z, c, h.transpose(1, 2))
    with pytest.raises(ValueError):
        tss.ssm_scan(z.double(), z, c, h)
    with pytest.raises(ValueError):
        tss.ssm_scan(z, z.bfloat16(), c, h)
    build.reset_launch_counts()
    y, _ = tss.ssm_scan(z.bfloat16(), z.bfloat16(), c.bfloat16(), h)    # bf16 streams, f32 out
    assert y.dtype == torch.float32 and build.launch_counts["ssm_scan"] == 0


@pytest.mark.parametrize("variant,S,chunk", [
    ("chunked", 64, 16), ("chunked", 40, 16), ("fused_y", 64, 16), ("fused_y", 40, 16),
    ("seq", 48, 16),
])
def test_plain_scan_variants_match_their_jax_twins(variant, S, chunk):
    decay, bx, c_t, h0 = _scan_inputs(2, S, 32, 8, S + 1)
    jd, jb, jc, jh = map(to_jax, (decay, bx, c_t, h0))
    td, tb, tc, th = map(to_torch, (decay, bx, c_t, h0))
    if variant == "chunked":
        want = jm._ssm_scan_chunked(jd, jb, jh, chunk)
        got = tm._ssm_scan_chunked(td, tb, th, chunk)
    elif variant == "fused_y":
        want = jm._ssm_scan_chunked_fused_y(jd, jb, jc, jh, chunk)
        got = tm._ssm_scan_chunked_fused_y(td, tb, tc, th, chunk)
    else:
        want = jm._ssm_scan_seq_fused_y(jd, jb, jc, jh)
        got = tm._ssm_scan_seq_fused_y(td, tb, tc, th)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(np32(a), np.asarray(b), **TWIN_TOL)


def _mixer_cfgs(mode):
    cj, ct = jget("jamba-v0.1-52b").smoke(), tget("jamba-v0.1-52b").smoke()
    kw = {"assoc": {}, "fused_y": dict(mamba_fused_y=True), "seq": dict(mamba_scan_impl="seq"),
          "always": dict(use_pallas="always")}[mode]
    return cj.replace(**kw), ct.replace(**kw)


def _mixer_setup(seed=0, S=64):
    cj, _ = _mixer_cfgs("assoc")
    p_j = jm.init_mamba(jax.random.key(seed), cj)
    p_t = {k: to_torch(np32(v)) for k, v in p_j.items()}
    rng = np.random.default_rng(seed + 1)
    x = (rng.standard_normal((2, S, cj.d_model)) * 0.4).astype(np.float32)
    w = rng.standard_normal((2, S, cj.d_model)).astype(np.float32)      # cotangent
    return p_j, p_t, x, w


@pytest.mark.parametrize("mode", ["assoc", "fused_y", "seq", "always"])
def test_mamba_mixer_output_and_gradients_match_jax(mode):
    """'always': JAX runs its Pallas kernel in interpret mode (S = 64 is a
    multiple of the chunk, d_inner = 256 of 128); the port runs its
    kernel's autograd Function, whose CPU forward is the plain recurrence
    and whose backward is the fused-y recompute."""
    cj, ct = _mixer_cfgs(mode)
    p_j, p_t, x, w = _mixer_setup()

    def f_j(p, xx):
        out, st = jm.mamba_mixer(p, xx, cj)
        return jnp.sum(out * to_jax(w)), (out, st)

    (_, (out_j, st_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(f_j, argnums=(0, 1), has_aux=True))(
        p_j, to_jax(x))
    xt = to_torch(x).requires_grad_(True)
    leaves = [p_t[k].requires_grad_(True) for k in PARAM_NAMES]
    out_t, st_t = tm.mamba_mixer(p_t, xt, ct)
    grads = torch.autograd.grad(torch.sum(out_t * to_torch(w)), [xt] + leaves)
    np.testing.assert_allclose(np32(out_t), np.asarray(out_j), **MIXER_TOL)
    np.testing.assert_allclose(np32(st_t["ssm"]), np.asarray(st_j["ssm"]), **MIXER_TOL)
    np.testing.assert_array_equal(np32(st_t["conv"]), np.asarray(st_j["conv"]))
    np.testing.assert_allclose(np32(grads[0]), np.asarray(gx_j), **MIXER_TOL)
    for name, g in zip(PARAM_NAMES, grads[1:]):
        gj = np.asarray(gp_j[name])
        assert tuple(g.shape) == gj.shape, name
        # a leaf's gradient sums over batch and sequence: its summation noise
        # scales with the leaf's magnitude
        scale = max(1.0, float(np.abs(gj).max()))
        np.testing.assert_allclose(np32(g), gj, rtol=MIXER_TOL["rtol"],
                                   atol=MIXER_TOL["atol"] * scale, err_msg=name)


def test_mamba_decode_with_a_state_matches_jax():
    """Prefill 16 tokens, then three one-token steps that carry (conv, ssm):
    each step's output and state equal JAX's, and the last output equals the
    mixer over all 19 tokens."""
    cj, ct = _mixer_cfgs("assoc")
    p_j, p_t, x, _ = _mixer_setup(seed=3, S=19)

    @jax.jit
    def run_j(p, xx):
        full, _ = jm.mamba_mixer(p, xx, cj)
        out, st = jm.mamba_mixer(p, xx[:, :16], cj)
        outs = []
        for i in range(3):
            o, st = jm.mamba_decode(p, xx[:, 16 + i:17 + i], st, cj)
            outs.append(o)
        return full, jnp.concatenate(outs, axis=1), st

    full_j, steps_j, st_j = run_j(p_j, to_jax(x))
    xt = to_torch(x)
    with torch.inference_mode():
        full_t, _ = tm.mamba_mixer(p_t, xt, ct)
        _, st = tm.mamba_mixer(p_t, xt[:, :16], ct)
        outs = []
        for i in range(3):
            o, st = tm.mamba_decode(p_t, xt[:, 16 + i:17 + i], st, ct)
            outs.append(o)
    steps_t = torch.cat(outs, dim=1)
    np.testing.assert_allclose(np32(full_t), np.asarray(full_j), **MIXER_TOL)
    np.testing.assert_allclose(np32(steps_t), np.asarray(steps_j), **MIXER_TOL)
    np.testing.assert_allclose(np32(st["ssm"]), np.asarray(st_j["ssm"]), **MIXER_TOL)
    np.testing.assert_allclose(np32(st["conv"]), np.asarray(st_j["conv"]), **MIXER_TOL)
    np.testing.assert_allclose(np32(steps_t[:, -1]), np32(full_t[:, -1]), **MIXER_TOL)


def test_kernel_dispatch_and_bf16_stream(monkeypatch):
    """On a CPU tensor only 'always' takes the kernel's autograd Function;
    under bf16_stream the three streams are bf16 and the state stays f32."""
    _, ct = _mixer_cfgs("assoc")
    _, p_t, x, _ = _mixer_setup(seed=5, S=32)
    calls = []
    orig = tm._SSMKernelFn.apply
    monkeypatch.setattr(tm._SSMKernelFn, "apply", lambda *a: calls.append(a) or orig(*a))
    outs = {}
    for mode in ("always", "never", "auto"):
        outs[mode], _ = tm.mamba_mixer(p_t, to_torch(x), ct.replace(use_pallas=mode))
    assert len(calls) == 1
    for mode in ("never", "auto"):
        np.testing.assert_allclose(np32(outs[mode]), np32(outs["always"]), **MIXER_TOL)
    calls.clear()
    out, st = tm.mamba_mixer(p_t, to_torch(x), ct.replace(use_pallas="always", bf16_stream=True))
    assert [t.dtype for t in calls[0][:4]] == [torch.bfloat16] * 4
    assert st["ssm"].dtype == torch.float32 and bool(torch.isfinite(out).all())
    np.testing.assert_allclose(np32(out), np32(outs["always"]), rtol=5e-2, atol=5e-2)


def test_state_spec_and_dims_match_jax():
    cj, ct = jget("jamba-v0.1-52b"), tget("jamba-v0.1-52b")
    assert tm.dims(ct) == jm.dims(cj) == (8192, 256, 16, 4)
    spec_j, spec_t = jm.state_spec(cj, 3), tm.state_spec(ct, 3)
    for key in ("conv", "ssm"):
        assert spec_t[key][0] == spec_j[key][0]
        assert str(spec_t[key][1]).split(".")[-1] == str(spec_j[key][1])
    smoke = dataclasses.replace(ct.smoke().ssm)
    assert (smoke.d_state, smoke.chunk_size) == (8, 16)
