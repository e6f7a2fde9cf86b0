"""Mamba (S6) selective-state-space mixer, the SSM half of Jamba.

Counterpart of ``repro/models/mamba.py``, with its parameter names and its
(B, S, d_inner, d_state) model layout.  Three plain scans, each the twin of
the JAX one of the same name:

- ``_ssm_scan_chunked`` (the default, ``mamba_scan_impl="assoc"``): chunks
  of ``cfg.ssm.chunk_size`` steps with a carried state, and inside a chunk
  a log-step (Hillis-Steele) scan where JAX runs ``lax.associative_scan``;
- ``_ssm_scan_chunked_fused_y`` (``cfg.mamba_fused_y``): the same, with
  d_state contracted against C inside the chunk;
- ``_ssm_scan_seq_fused_y`` (``mamba_scan_impl="seq"``): one step at a
  time, ``kernels.ssm_scan.ssm_scan_plain`` seen in the model's layout.
  It runs in float32 whatever the inputs are (JAX's carries bf16 under
  ``bf16_stream``).

Kernel dispatch differs from the reference on purpose.  JAX sends a scan
to its Pallas kernel only for ``S > 1``, ``S % chunk_size == 0`` and
``d_inner % 128 == 0``, and every decode step to the jnp path.  The port's
kernel (``repro_torch.kernels.ssm_scan``) takes any S and d_inner, so on a
CUDA tensor, with ``use_pallas`` not ``never``, *every* scan goes through
it, decode included.  It reads the model's tensors through transposed
views (JAX pays two transposes of the largest tensors of the mixer there).
Its gradient is ``_ssm_scan_chunked_fused_y``'s, recomputed in backward,
as ``_ssm_cv_bwd`` does.

On the card the mixer's scan also takes the discretisation in (a divergence
of dataflow, not of result): unless ``cfg.bf16_stream`` is on, the kernel
path hands dt, x, B, C and A to ``kernels.ssm_scan.ssm_scan_fused``
(``_SSMFusedFn``), which forms exp(dt·A) and dt·x·B in registers, so the
two (B, S, d_inner, d_state) float32 tensors that JAX forms before its
kernel are never written.  Backward forms them again from the saved inputs
and takes the same recompute's gradient.  Under ``bf16_stream`` the
reference rounds them to bf16 before the scan, so that path keeps
``_SSMKernelFn`` and the TPU-signature kernel.

``dt_bias``, ``a_log`` and ``d_skip`` are float32 whatever ``cfg.dtype``
is.  ``softplus`` is ``torch.nn.functional.softplus``, which returns x for
x > 20 where JAX computes ``logaddexp(x, 0)``: the two differ by less than
e^-20 relative.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import discretise, ssm_scan, ssm_scan_fused, ssm_scan_plain
from repro_torch.models.attention import use_pallas
from repro_torch.models.layers import Params, _device_of, dense_init, project, torch_dtype
from repro_torch.parallel import sharding as shd


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    dt_rank = cfg.ssm.dt_rank or max(cfg.d_model // 16, 1)
    return d_inner, dt_rank, cfg.ssm.d_state, cfg.ssm.d_conv


def init_mamba(gen, cfg: ModelConfig, n_layers: int = 0, device=None) -> Params:
    di, dt_rank, n, d_conv = dims(cfg)
    D = cfg.d_model
    lead = (n_layers,) if n_layers else ()
    dtype = torch_dtype(cfg.dtype)
    dev = _device_of(gen, device)
    f32 = dict(dtype=torch.float32, device=dev)
    # S4D-real initialization for A; dt bias spread over [1e-3, 1e-1]
    a = torch.arange(1, n + 1, **f32).expand(di, n)
    u = torch.rand(lead + (di,), generator=gen, **f32)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))          # inverse softplus
    return {
        "w_in": dense_init(gen, lead + (D, 2 * di), dtype, device=device),
        "conv_w": dense_init(gen, lead + (d_conv, di), dtype, scale=0.5, device=device),
        "conv_b": torch.zeros(lead + (di,), dtype=dtype, device=dev),
        "w_bcdt": dense_init(gen, lead + (di, dt_rank + 2 * n), dtype, device=device),
        "w_dt": dense_init(gen, lead + (dt_rank, di), dtype, device=device),
        "dt_bias": dt_bias * torch.ones(lead + (di,), **f32),
        "a_log": torch.log(a) * torch.ones(lead + (di, n), **f32),
        "d_skip": torch.ones(lead + (di,), **f32),
        "w_out": dense_init(gen, lead + (di, D), dtype, device=device),
    }


# ---------------------------------------------------------------------------
# selective scan: plain forms (model layout) and the kernel behind autograd
# ---------------------------------------------------------------------------

def _chunk_scan(d: torch.Tensor, b: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """States of one chunk: d, b (B, C, di, n), h (B, di, n) the carried
    state.  The combine ``(a0 * b0, a1 * b0 + b1)`` of the reference, as a
    log-step inclusive scan over axis 1."""
    C = d.shape[1]
    k = 1
    while k < C:
        d, b = (torch.cat([d[:, :k], d[:, :-k] * d[:, k:]], dim=1),
                torch.cat([b[:, :k], b[:, :-k] * d[:, k:] + b[:, k:]], dim=1))
        k *= 2
    return b + d * h[:, None]


def _chunks(S: int, chunk: int):
    if S % chunk != 0:
        chunk = S
    return [(c0, c0 + chunk) for c0 in range(0, S, chunk)]


def _ssm_scan_chunked(decay, bx, h0, chunk: int):
    """h_t = decay_t * h_{t-1} + bx_t, a chunk at a time.  decay, bx: (B, S,
    di, n); h0: (B, di, n).  Returns (states (B, S, di, n), h_final)."""
    # empty_like, not new_empty: on a DTensor it keeps decay's sharding, and
    # each chunk's write stays on its shard
    states = torch.empty_like(decay, memory_format=torch.contiguous_format)
    h = h0
    for c0, c1 in _chunks(decay.shape[1], chunk):
        st = _chunk_scan(decay[:, c0:c1], bx[:, c0:c1], h)
        states[:, c0:c1] = st
        h = st[:, -1]
    return states, h


def _ssm_scan_chunked_fused_y(decay, bx, c_t, h0, chunk: int):
    """``cfg.mamba_fused_y``: d_state contracted against C inside the chunk,
    so the scan emits y (B, S, di).  c_t: (B, S, n).  Returns (y, h_final)."""
    ys = []
    h = h0
    for c0, c1 in _chunks(decay.shape[1], chunk):
        st = _chunk_scan(decay[:, c0:c1], bx[:, c0:c1], h)
        ys.append(torch.einsum("bcdn,bcn->bcd", st, c_t[:, c0:c1]))
        h = st[:, -1]
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), h


def _ssm_scan_seq_fused_y(decay, bx, c_t, h0):
    """``mamba_scan_impl="seq"``: one step at a time, in float32.  Returns
    (y (B, S, di), h_final (B, di, n))."""
    y, h = ssm_scan_plain(decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2))
    return y, h.transpose(1, 2)


class _SSMKernelFn(torch.autograd.Function):
    """Kernel forward with ``_ssm_scan_chunked_fused_y``'s gradients
    (recomputed in backward): the counterpart of ``_ssm_pallas_cv``."""

    @staticmethod
    def forward(ctx, decay, bx, c_t, h0, chunk):
        y, h = ssm_scan(decay.transpose(2, 3), bx.transpose(2, 3), c_t, h0.transpose(1, 2), chunk)
        ctx.save_for_backward(decay, bx, c_t, h0)
        ctx.chunk = chunk
        return y, h.transpose(1, 2)

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, h = _ssm_scan_chunked_fused_y(*inputs, ctx.chunk)
        grads = torch.autograd.grad((y, h), inputs, (g_y, g_h), allow_unused=True)
        return (*grads, None)


class _SSMFusedFn(torch.autograd.Function):
    """The fused kernel forward (discretisation inside the scan) with the
    gradients of ``discretise`` followed by ``_ssm_scan_chunked_fused_y``,
    both recomputed in backward.  Saves dt, x, b_t, c_t, a and h0, never
    decay or bx."""

    @staticmethod
    def forward(ctx, dt, x, b_t, c_t, a, h0, chunk):
        y, h = ssm_scan_fused(dt, x, b_t, c_t, a, h0)
        ctx.save_for_backward(dt, x, b_t, c_t, a, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, g_y, g_h):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        dt, x, b_t, c_t, a, h0 = inputs
        with torch.enable_grad():
            decay, bx = discretise(dt, x, b_t, a)
            y, h = _ssm_scan_chunked_fused_y(decay, bx, c_t, h0, ctx.chunk)
        grads = torch.autograd.grad((y, h), inputs, (g_y, g_h), allow_unused=True)
        return (*grads, None)


# ---------------------------------------------------------------------------
# mixer
# ---------------------------------------------------------------------------

def _depthwise_conv(x, w, b, prev=None):
    """Causal depthwise conv.  x: (B, S, di); w: (d_conv, di); prev: (B,
    d_conv - 1, di) left context (zeros for a fresh sequence).  Returns (y,
    new_prev).  The products are summed left to right, as the reference's
    Python ``sum`` does (the order matters in bf16)."""
    d_conv = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], d_conv - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(d_conv)) + b
    return y, xp[:, -(d_conv - 1):]


def _channels(x):
    """On a DTensor whose last dim (d_inner) divides `model`: (mesh, its rows
    with d_inner split over `model`, that split's placements for a weight
    whose dim ``d`` is d_inner: ``weight(d)``); else None, and the plain
    code runs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor) or x.shape[-1] % shd.mesh_axis_size(x.device_mesh, "model"):
        return None
    mesh = x.device_mesh
    rows = shd.row_placements(mesh, x.shape[0])
    return (mesh, shd.with_model(mesh, rows, Shard(x.dim() - 1)),
            lambda d: shd.with_model(mesh, [Replicate()] * mesh.ndim, Shard(d)))


def _in_proj(x, w_in, di: int):
    """(xs, z): ``x @ w_in`` split into its two d_inner halves.

    On DTensors the specs split ``w_in``'s 2·d_inner columns over `model` in
    blocks, so the product comes out with the first half of the ranks
    holding xs's columns and the rest z's, while the conv, the scan and the
    gate want each rank to hold the same channels of both.  One all-to-all
    over `model` sends each half-block to the rank that owns those channels
    (``sharding.on_shards``; the backward is the reverse all-to-all).
    DTensor alone gathers the product whole over `model` to slice it, and
    in backward its gradient, by choices that differ by torch release."""
    from torch.distributed.tensor import DTensor, Shard

    xz = project(x, w_in)                                # (B, S, 2*di)
    m = shd.mesh_axis_size(xz.device_mesh, "model") if isinstance(xz, DTensor) else 1
    if m == 1 or m % 2 or di % m:
        return xz[..., :di], xz[..., di:]
    mesh = xz.device_mesh
    group = mesh.get_group("model")
    r, half = mesh.get_local_rank("model"), di // m

    def local(block):
        block = block.permute(2, 0, 1).contiguous()     # (2*di/m, b, S): channels first
        # this rank's block holds channel blocks 2r and 2r + 1 (of xs, or
        # of z past the middle rank); it receives its own block of xs, then of z
        dest = [2 * (r % (m // 2)), 2 * (r % (m // 2)) + 1]
        send = [half if k in dest else 0 for k in range(m)]
        recv = [half if k in (r // 2, m // 2 + r // 2) else 0 for k in range(m)]
        got = shd.AllToAll.apply(block, recv, send, group)
        return got[:half].permute(1, 2, 0), got[half:].permute(1, 2, 0)

    ch = shd.with_model(mesh, shd.row_placements(mesh, xz.shape[0]), Shard(2))
    return shd.on_shards(local, mesh, (ch,), (ch, ch))(xz)


def _conv_silu(xs, w, b, prev):
    """``silu`` of the causal depthwise conv, and the new left context; on
    DTensors each rank on its rows and d_inner channels."""
    def local(xs, w, b, prev):
        y, state = _depthwise_conv(xs, w, b, prev)
        return F.silu(y), state

    placed = _channels(xs)
    if placed is None:
        return local(xs, w, b, prev)
    mesh, ch, weight = placed
    fn = shd.on_shards(local, mesh, (ch, weight(1), weight(0), None if prev is None else ch),
                       (ch, ch))
    return fn(xs, w, b, prev)


def _gate(y, xs, z, d_skip, dtype):
    """``(y + d_skip * xs) * silu(z)`` in ``dtype``; on DTensors each rank on
    its rows and d_inner channels."""
    def local(y, xs, z, d_skip):
        return (y.float() + d_skip * xs.float()).to(dtype) * F.silu(z)

    placed = _channels(xs)
    if placed is None:
        return local(y, xs, z, d_skip)
    mesh, ch, weight = placed
    return shd.on_shards(local, mesh, (ch, ch, ch, weight(0)), ch)(y, xs, z, d_skip)


def _scan_formed(cfg: ModelConfig, kernel: bool, decay, bx, c_t, h0):
    """The scan over the formed decay and bx (rounded to bf16 under
    ``bf16_stream``): the TPU-signature kernel or one of the three plain
    scans.  Returns (y (B, S, di), h_final)."""
    if cfg.bf16_stream:
        decay, bx, c_t, h0 = (t.to(torch.bfloat16) for t in (decay, bx, c_t, h0))
    if kernel:
        return _SSMKernelFn.apply(decay, bx, c_t, h0, cfg.ssm.chunk_size)
    if cfg.mamba_scan_impl == "seq":
        return _ssm_scan_seq_fused_y(decay, bx, c_t, h0)
    if cfg.mamba_fused_y:
        return _ssm_scan_chunked_fused_y(decay, bx, c_t, h0, cfg.ssm.chunk_size)
    states, h_final = _ssm_scan_chunked(decay, bx, h0, cfg.ssm.chunk_size)
    del decay, bx
    return torch.einsum("bsdn,bsn->bsd", states, c_t), h_final


def _bcdt_proj(xs, w_bcdt):
    """``xs @ w_bcdt``: (B, S, di) -> (B, S, dt_rank + 2n).

    On DTensors each rank multiplies its batch rows' d_inner slice by its
    rows of ``w_bcdt`` (``sharding.on_shards``; the specs split both over
    `model`): the output is a pending sum over `model`, reduced where
    ``_dt_proj`` and the scan take it, and in backward the weight's
    gradient is each rank's local product.  DTensor's own choice for that
    gradient, in some torch releases, gathers ``xs`` whole over `model`."""
    from torch.distributed.tensor import Partial

    placed = _channels(xs)
    if placed is None:
        return xs @ w_bcdt
    mesh, ch, weight = placed
    return shd.on_shards(torch.matmul, mesh, (ch, weight(0)),
                         shd.with_model(mesh, ch, Partial()))(xs, w_bcdt)


def _dt_proj(low, w_dt, dt_bias):
    """dt = softplus(low @ w_dt + dt_bias), f32: (B, S, dt_rank) -> (B, S, di).

    On DTensors the specs split ``w_dt``'s and ``dt_bias``'s d_inner over
    `model`, and ``low`` comes out of a product over the `model`-split
    d_inner as a pending sum; it is reduced (small: dt_rank wide) and each
    rank computes its slice of d_inner (``sharding.on_shards``).  DTensor's
    own choice for the add, a pending sum of the bias too, is one that some
    torch releases cannot carry out."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def proj(low, w_dt, dt_bias):
        return F.softplus((low @ w_dt).float() + dt_bias)

    if not isinstance(low, DTensor):
        return proj(low, w_dt, dt_bias)
    mesh = low.device_mesh
    rows = shd.row_placements(mesh, low.shape[0])
    whole = [Replicate()] * mesh.ndim
    fn = shd.on_shards(proj, mesh, (rows, shd.with_model(mesh, whole, Shard(1)),
                                    shd.with_model(mesh, whole, Shard(0))),
                       shd.with_model(mesh, rows, Shard(2)))
    return fn(low, w_dt, dt_bias)


def _scan(cfg: ModelConfig, kernel: bool, dt, xs, b_t, c_t, a, h0):
    """The selective scan from dt, x, B, C and A: (y, h_final); ``h0`` None:
    zeros."""
    if h0 is None:
        h0 = torch.zeros((xs.shape[0], xs.shape[2], a.shape[-1]), dtype=torch.float32,
                         device=xs.device)
    if kernel and not cfg.bf16_stream:
        return _SSMFusedFn.apply(dt, xs, b_t, c_t, a, h0, cfg.ssm.chunk_size)
    return _scan_formed(cfg, kernel, *discretise(dt, xs, b_t, a), c_t, h0)


def _scan_on_shards(cfg: ModelConfig, kernel: bool, dt, xs, b_t, c_t, a, h0):
    """``_scan``; on DTensors each rank on its batch rows
    (``sharding.row_placements``) and, where d_inner divides `model`, its
    channels (``sharding.on_shards``): the scan is independent per (row,
    channel), and DTensor's own strategies for its products would flatten
    (row, channel) into a dim the pod mesh shards three ways."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(xs, DTensor):
        return _scan(cfg, kernel, dt, xs, b_t, c_t, a, h0)
    mesh = xs.device_mesh
    split = xs.shape[2] % shd.mesh_axis_size(mesh, "model") == 0
    rows = shd.row_placements(mesh, xs.shape[0])
    seq = shd.with_model(mesh, rows, Shard(2) if split else Replicate())      # (B, S, di)
    st = shd.with_model(mesh, rows, Shard(1) if split else Replicate())       # (B, di, n)
    ch = shd.with_model(mesh, [Replicate()] * len(rows), Shard(0) if split else Replicate())
    if h0 is not None and not isinstance(h0, DTensor):
        h0 = DTensor.from_local(h0, mesh, [Replicate()] * len(rows), run_check=False)
    fn = shd.on_shards(lambda *t: _scan(cfg, kernel, *t), mesh,
                       (seq, seq, rows, rows, ch, st if h0 is not None else None), (seq, st))
    return fn(dt, xs, b_t, c_t, a, h0)


def mamba_mixer(params: Params, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence mixer.  x: (B, S, D) -> (out (B, S, D), final state)."""
    di, dt_rank, n, d_conv = dims(cfg)
    xs, z = _in_proj(x, params["w_in"], di)              # (B, S, di) each
    prev = state["conv"] if state is not None else None
    xs, conv_state = _conv_silu(xs, params["conv_w"], params["conv_b"], prev)

    bcdt = _bcdt_proj(xs, params["w_bcdt"])              # (B, S, dt_rank+2n)
    dt = _dt_proj(bcdt[..., :dt_rank], params["w_dt"], params["dt_bias"])
    b_t = bcdt[..., dt_rank:dt_rank + n].float()
    c_t = bcdt[..., dt_rank + n:].float()

    a = -torch.exp(params["a_log"])                      # (di, n)
    h0 = state["ssm"] if state is not None else None
    y, h_final = _scan_on_shards(cfg, use_pallas(cfg, x), dt, xs, b_t, c_t, a, h0)
    y = _gate(y, xs, z, params["d_skip"], x.dtype)
    out = project(y, params["w_out"])
    return out, {"conv": conv_state, "ssm": h_final.float()}


def mamba_decode(params: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step.  x: (B, 1, D); state: conv (B, d_conv-1, di), ssm (B,
    di, n).  Returns the new state; the caller writes it where it wants."""
    return mamba_mixer(params, x, cfg, state=state)


def state_spec(cfg: ModelConfig, batch: int):
    di, _, n, d_conv = dims(cfg)
    return {"conv": ((batch, d_conv - 1, di), torch_dtype(cfg.dtype)),
            "ssm": ((batch, di, n), torch.float32)}
