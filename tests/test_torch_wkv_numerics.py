"""The chunked WKV kernel's arithmetic, emulated step for step on the CPU,
against the JAX package's ``wkv_pallas`` (interpret mode) and
``repro.models.rwkv.wkv_chunked``, at the tolerance ``chip_smoke.py``
holds the kernel to on the card (rtol = atol = 1e-4).

The card runs ``csrc/wkv_sm90.cu``, which no CPU can; this shows, where the
tests run, that its order of operations fits that tolerance: 64-step
chunks cut into 16-step sub-chunks, decay cumsums in log2 units local to a
sub-chunk, the pairwise decay of an off-diagonal sub-block factored through
the sub-chunk boundary, the diagonal sub-blocks in 4 x 4 tiles with an
explicit decay per channel on the diagonal tiles, and every product in
3xTF32 (three TF32 products of high and low parts, summed in f32).  The
tensor cores sum inside a product in an order of their own; the emulation
sums as ``torch.matmul`` does."""
import sys

import numpy as np
import pytest
import torch
from _torch_port import mm3, np32, tf32, to_jax, to_torch

from repro.kernels.wkv import wkv_pallas
from repro.models import rwkv as jr
from repro_torch.kernels import wkv as twkv

TOL = dict(rtol=1e-4, atol=1e-4)    # chip_smoke.py [2e]
C, SUB = 64, 16                     # the kernel's chunk and sub-chunk
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def kernel_emulation(r, k, v, logw, u, s0):
    """What csrc/wkv_sm90.cu computes, in its order.  r, k, v, logw:
    (B, H, S, hd) f32; u: (H, hd); s0: (B, H, hd, hd)."""
    B, H, S, hd = r.shape
    pad = (-S) % C                  # rows past S read as zeros (decay 1, no key)
    r, k, v, logw = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (r, k, v, logw))
    uu = u[None, :, None, :]
    s = s0.clone()
    ys = []
    nsub = C // SUB
    for c0 in range(0, S + pad, C):
        rr, kk, vv, ww = (t[:, :, c0:c0 + C] for t in (r, k, v, logw))
        # local inclusive cumsums in log2 units, one f32 add per step, and
        # the exclusive ones; every exp below is an exp2
        lw = (ww * LOG2E).reshape(B, H, nsub, SUB, hd)
        l = torch.empty_like(lw)
        acc = torch.zeros_like(lw[:, :, :, 0])
        for i in range(SUB):
            acc = acc + lw[:, :, :, i]
            l[:, :, :, i] = acc
        lx = torch.cat([torch.zeros_like(l[:, :, :, :1]), l[:, :, :, :-1]], dim=3)
        T = l[:, :, :, -1]                                  # (B, H, nsub, hd) sub-chunk totals
        l, lx = l.reshape(B, H, C, hd), lx.reshape(B, H, C, hd)
        eT = torch.exp2(T)
        # prefix products of 2^T: decay from a chunk's start to sub-chunk b
        ep = [torch.ones_like(eT[:, :, 0])]
        for b in range(1, nsub + 1):
            ep.append(ep[-1] * eT[:, :, b - 1])
        r_t = rr * torch.exp2(lx)                            # r~: decay to its sub-chunk's start
        q = r_t * torch.cat([ep[b][:, :, None].expand(B, H, SUB, hd) for b in range(nsub)], dim=2)
        tail = torch.clamp(T.repeat_interleave(SUB, dim=2) - l, max=0.0)
        k_e = kk * torch.exp2(tail)                          # decay to its sub-chunk's end
        # k~ of sub-chunk a as key of query sub-chunk b > a (b = nsub: the
        # state update): one more factor 2^T_c for each sub-chunk between
        k_ver = {}
        for a in range(nsub):
            f = k_e[:, :, a * SUB:(a + 1) * SUB]
            k_ver[a] = {}
            for b in range(a + 1, nsub + 1):
                k_ver[a][b] = f
                if b < nsub:
                    f = f * eT[:, :, b, None]
        A = torch.zeros(B, H, C, C)
        for b in range(nsub):
            tb = slice(b * SUB, (b + 1) * SUB)
            # diagonal sub-block in 4x4 tiles: an explicit decay on the
            # diagonal tiles, one factored through the tile edge elsewhere
            for ti in range(4):
                for tj in range(ti + 1):
                    ts = slice(b * SUB + 4 * ti, b * SUB + 4 * ti + 4)
                    js = slice(b * SUB + 4 * tj, b * SUB + 4 * tj + 4)
                    if ti > tj:
                        ref = l[:, :, js.stop - 1:js.stop]
                        rx = rr[:, :, ts] * torch.exp2(torch.clamp(lx[:, :, ts] - ref, max=0.0))
                        ky = kk[:, :, js] * torch.exp2(torch.clamp(ref - l[:, :, js], max=0.0))
                        blk = torch.einsum("bhtd,bhjd->bhtj", rx, ky)
                    else:
                        dec = torch.exp2(torch.clamp(lx[:, :, ts, None] - l[:, :, None, js], max=0.0))
                        blk = torch.einsum("bhtd,bhjd,bhtjd->bhtj", rr[:, :, ts], kk[:, :, js], dec)
                        blk = blk * torch.ones(4, 4).tril(-1)
                        blk = blk + torch.diag_embed((rr[:, :, ts] * uu * kk[:, :, js]).sum(-1))
                    A[:, :, ts, js] = blk
            # off-diagonal sub-blocks a < b, on the tensor cores (mma.sync)
            for a in range(b):
                ja = slice(a * SUB, (a + 1) * SUB)
                A[:, :, tb, ja] = mm3(r_t[:, :, tb], k_ver[a][b].transpose(-1, -2))
        # y and the state update (wgmma)
        y = torch.zeros(B, H, C, v.shape[-1])
        for b in range(nsub):
            tb, upto = slice(b * SUB, (b + 1) * SUB), (b + 1) * SUB
            y[:, :, tb] = mm3(A[:, :, tb, :upto], vv[:, :, :upto]) + mm3(q[:, :, tb], s)
        k4 = torch.cat([k_ver[a][nsub] for a in range(nsub)], dim=2)
        s = s * ep[nsub][..., None] + mm3(k4.transpose(-1, -2), vv)
        ys.append(y)
    return torch.cat(ys, dim=2)[:, :, :S], s



def _inputs(B, H, S, hd, seed, decay):
    """(B, H, S, hd) numpy inputs, scaled as chip_smoke.wkv_inputs scales them."""
    rng = np.random.default_rng(seed)
    r, k, v = ((rng.standard_normal((B, H, S, hd)) * 0.5).astype(np.float32) for _ in range(3))
    if decay == "model":        # the model's init: w0 from -6 (slow) to -1 (fast), a small data term
        ratio = np.arange(H * hd, dtype=np.float32).reshape(H, hd) / (H * hd - 1)
        w0 = -6.0 + 5.0 * ratio ** 0.7
        logw = -np.exp(w0[None, :, None, :] + 0.1 * rng.standard_normal((B, H, S, hd)))
    elif decay == "harsh":      # per-step log-decay down to -20: chunk cumsums underflow exp
        logw = -np.exp(rng.uniform(-3.0, 3.0, (B, H, S, hd)))
    else:
        logw = -np.exp(rng.standard_normal((B, H, S, hd)) * 0.5 - 2.0)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, logw.astype(np.float32), u, s0


def _references(r, k, v, logw, u, s0):
    """wkv_pallas in interpret mode and wkv_chunked (the model's layout),
    one chunk of S where S is not a multiple of 64, as both require."""
    S = r.shape[2]
    chunk = C if S % C == 0 else S
    y_p, s_p = wkv_pallas(*map(to_jax, (r, k, v, logw, u, s0)), chunk=chunk, interpret=True)
    tr = lambda a: to_jax(np.swapaxes(a, 1, 2))
    y_c, s_c = jr.wkv_chunked(tr(r), tr(k), tr(v), tr(logw), to_jax(u), to_jax(s0), chunk)
    return (np32(y_p), np32(s_p)), (np.swapaxes(np32(y_c), 1, 2), np32(s_c))


CASES = [   # B, H, S, hd, decay
    (1, 2, 128, 64, "model"),       # rwkv6-1.6b's head_dim and decay init, two chunks
    (1, 2, 128, 64, "harsh"),
    (2, 2, 64, 16, "harsh"),        # the smoke config's head_dim, one chunk
    (2, 2, 128, 16, "model"),
    (1, 2, 100, 64, "random"),      # ragged: a chunk and a part of one
    (2, 2, 37, 16, "harsh"),        # ragged: part of one chunk
    (1, 1, 64, 64, "random"),
]


@pytest.mark.parametrize("B,H,S,hd,decay", CASES)
def test_kernel_arithmetic_fits_the_chip_tolerance(B, H, S, hd, decay):
    args = _inputs(B, H, S, hd, seed=B * 1000 + S + hd, decay=decay)
    y, s = kernel_emulation(*map(to_torch, args))
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    for y_ref, s_ref in _references(*args):
        np.testing.assert_allclose(np32(y), y_ref, **TOL)
        np.testing.assert_allclose(np32(s), s_ref, **TOL)
    # and the port's plain version, which the card holds the kernel to
    y_p, s_p = twkv.wkv_plain(*map(to_torch, args), chunk=C if S % C == 0 else S)
    np.testing.assert_allclose(np32(y), np32(y_p), **TOL)
    np.testing.assert_allclose(np32(s), np32(s_p), **TOL)


@pytest.mark.parametrize("decay", ["model", "harsh"])
def test_kernel_arithmetic_state_chain(decay):
    """Two calls, the second from the first's final state, equal one call
    over the whole sequence (what serving's prefill then decode relies on)."""
    r, k, v, logw, u, s0 = map(to_torch, _inputs(1, 2, 192, 64, seed=5, decay=decay))
    y, s = kernel_emulation(r, k, v, logw, u, s0)
    h = 128
    y1, s1 = kernel_emulation(r[:, :, :h], k[:, :, :h], v[:, :, :h], logw[:, :, :h], u, s0)
    y2, s2 = kernel_emulation(r[:, :, h:], k[:, :, h:], v[:, :, h:], logw[:, :, h:], u, s1)
    np.testing.assert_allclose(np32(torch.cat([y1, y2], dim=2)), np32(y), **TOL)
    np.testing.assert_allclose(np32(s2), np32(s), **TOL)
    y_p, s_p = _references(*(np32(t) for t in (r, k, v, logw, u, s0)))[0]
    np.testing.assert_allclose(np32(y), y_p, **TOL)
    np.testing.assert_allclose(np32(s), s_p, **TOL)


def test_one_tf32_product_misses_the_tolerance(monkeypatch):
    """The tolerance sees the precision: with one TF32 product in place of
    three, the emulation strays beyond 1e-4 of ``wkv_pallas``, which is why
    the kernel pays for 3xTF32."""
    args = _inputs(1, 2, 128, 64, seed=1192, decay="model")
    monkeypatch.setattr(sys.modules[__name__], "mm3", lambda a, b: tf32(a) @ tf32(b))
    y, _ = kernel_emulation(*map(to_torch, args))
    y_ref = _references(*args)[0][0]
    assert float(np.abs(np32(y) - y_ref).max()) > 1e-3


def test_tf32_rounding():
    """The emulated TF32 keeps 10 mantissa bits, rounds to nearest with ties
    away from zero, and the 3xTF32 product is f32-accurate where one TF32
    product is not."""
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -11), 1.0 + 2.0 ** -10])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -9), 1.0 + 2.0 ** -10]
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 64, generator=g), torch.randn(64, 64, generator=g)
    exact = (a.double() @ b.double())
    err3 = float((mm3(a, b).double() - exact).abs().max())
    err1 = float((tf32(a) @ tf32(b)).double().sub(exact).abs().max())
    assert err3 < 1e-5 < err1


@pytest.mark.parametrize("S,hd,chunked", [
    (64, 64, True), (4096, 64, True), (65, 16, True),
    (63, 64, False), (1, 64, False), (4096, 32, False), (4096, 128, False),
])
def test_route_by_shape(S, hd, chunked):
    """S >= 64 at hd 16 or 64 takes the chunked kernel; everything else,
    every decode step among it, the step kernel."""
    assert twkv.chunked_route(S, hd) is chunked


@pytest.mark.parametrize("B,H,hd,ev", [
    (4, 32, 64, 64),    # rwkv6-1.6b serving: 128 blocks of 64 columns
    (1, 32, 64, 16),    # its trainer: 32 heads x 4 column blocks
    (2, 32, 64, 32),
    (2, 8, 16, 16), (1, 1, 64, 16),
])
def test_value_columns_keep_about_128_blocks_in_flight(B, H, hd, ev):
    assert twkv.value_columns(B, H, hd) == ev
    assert hd % ev == 0 and 16 <= ev <= hd

