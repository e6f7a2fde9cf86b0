"""Core building blocks shared by every architecture, as plain functions on
tensors.

Parameters are plain nested dicts of tensors with the JAX package's key
paths and shapes, so they compose with ``repro_torch.utils.tree`` and the
bucketed grad-sync in ``repro_torch.parallel.grad_sync``.  Initializers take
an explicit ``torch.Generator``; tensors are created on ``device`` (with
``device="meta"`` only shapes and dtypes are made, no values are drawn).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import row_placements
from repro_torch.utils.tree import tree_leaves

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _device_of(gen: Optional[torch.Generator], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if gen is None:
        raise ValueError("need a torch.Generator or an explicit device")
    return gen.device


# a leaf of more elements is drawn in blocks of rows, so that its float32
# draw never holds more than one block (command-r-35b's stacked MLP leaf is
# 7.4 G elements: 30 GB in float32, beside 60 GB of bf16 weights)
_INIT_WHOLE_MAX = 1 << 30
_INIT_BLOCK = 1 << 28


def _trunc_normal(shape, gen, device, std: float, dtype: torch.dtype) -> torch.Tensor:
    """Inverse-CDF sampling of a normal of ``std`` cut to +-2 sigma."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.mul_(hi - lo).add_(lo).mul_(2.0).sub_(1.0)          # in place: the leaf may be GBs
    u.clamp_(-1.0 + 1e-7, 1.0 - 1e-7)
    x = torch.erfinv(u).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(std).to(dtype)


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype: torch.dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init (LeCun style)."""
    device = _device_of(gen, device)
    shape = tuple(shape)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if math.prod(shape) <= _INIT_WHOLE_MAX:
        return _trunc_normal(shape, gen, device, std, dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.view(-1, shape[-1])
    step = max(1, _INIT_BLOCK // shape[-1])
    for r0 in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - r0)
        rows[r0:r0 + n] = _trunc_normal((n, shape[-1]), gen, device, std, dtype)
    return out


def embed_init(gen: Optional[torch.Generator], shape: Sequence[int], dtype: torch.dtype,
               device=None) -> torch.Tensor:
    device = _device_of(gen, device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)
    return x.mul_(0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and any(p.is_shard(x.dim() - 1) for p in x.placements):
        return _rms_norm_split(x, weight, eps)
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def _rms_norm_split(x, weight, eps: float):
    """``rms_norm`` of a DTensor split on its last dim (the residual stream
    over `data` where the rows are whole over it,
    ``sharding.constrain_stream``): each rank sums its slice's squares, the
    sums are all-reduced over the axes that split the dim, and each rank
    scales its slice (``sharding.on_shards``).  DTensor's own strategy for
    the mean over a split dim differs by torch release."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last, n = x.device_mesh, x.dim() - 1, x.shape[-1]
    pl = list(x.placements)
    if any(not (p.is_shard() or p.is_replicate()) for p in pl):
        raise ValueError(f"rms_norm takes no pending sum: {pl}")
    sq = shd.on_shards(lambda t: torch.sum(torch.square(t.float()), dim=-1, keepdim=True), mesh,
                       (pl,), [Partial() if p.is_shard(last) else p for p in pl])(x)
    sq = sq.redistribute(mesh, [Replicate() if p.is_partial() else p for p in sq.placements])
    wpl = [Shard(0) if p.is_shard(last) else Replicate() for p in pl]

    def scale(t, s, w):
        return (t.float() * torch.rsqrt(s / n + eps) * w.float()).to(t.dtype)
    return shd.on_shards(scale, mesh, (pl, list(sq.placements), wpl), pl)(x, sq, weight)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, d) with d even; positions: broadcastable to (..., S).
    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2])."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)                 # (d/2,)
    angles = positions[..., None].float() * freqs                 # (..., S, d/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype: torch.dtype, n_layers: int = 0,
             device=None) -> Params:
    """SwiGLU MLP; stacked over a leading layer dim when n_layers > 0."""
    lead = (n_layers,) if n_layers else ()
    return {
        "wi": dense_init(gen, lead + (d_model, d_ff), dtype, device=device),
        "wg": dense_init(gen, lead + (d_model, d_ff), dtype, device=device),
        "wo": dense_init(gen, lead + (d_ff, d_model), dtype, device=device),
    }


def _model_only(w):
    """A DTensor weight gathered over every mesh axis but `model` (under
    ``fsdp_tp`` the specs split it over `data` too): FSDP's gather before
    the products, its gradient reduce-scattered back.  DTensor alone would
    split the products' contraction over `data` instead, and reduce their
    outputs by collectives that differ by torch release.  Anything else
    passes through."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    pl = [p if n == "model" else Replicate() for n, p in zip(names, w.placements)]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh, pl)


def project(x: torch.Tensor, w: torch.Tensor, gather: bool = False) -> torch.Tensor:
    """``x @ w``, a layer's product with one of its weights.  Where the
    batch rows are whole over `data` (``sharding.rows_whole``: a batch
    smaller than the data ways, as at long-context decode) the product is
    split over `data` on the weight's own shard (``sharding.linear``): the
    fsdp weights are never gathered, and no `data` rank repeats another's
    work.  Elsewhere ``x @ w``, with ``gather`` the weight first gathered
    over every mesh axis but `model` (``_model_only``)."""
    if shd.rows_whole(x):
        return shd.linear(x, w)
    if gather and shd.rows_gathered(x, w):
        return _rows_gathered(x, w)
    return x @ (_model_only(w) if gather else w)


def _rows_gathered(x, w):
    """``x @ w`` for a weight whose output columns the specs split over
    `data`, at a decode step's few rows (``sharding.rows_gathered``): the
    rows gathered over `data`, each rank's product with its own columns,
    one all-to-all back to its rows (``sharding.rows_to_columns``); over
    `model` as ``x @ w``: a pending sum where it splits the contraction."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, names = x.device_mesh, x.device_mesh.mesh_dim_names
    xin = [Replicate() if n == "data" else p for n, p in zip(names, x.placements)]
    out = [px if n == "data" else Partial() if pw.is_shard(0) else px
           for n, px, pw in zip(names, x.placements, w.placements)]
    return shd.on_shards(lambda a, b: shd.rows_to_columns(a @ b, mesh, "data"), mesh,
                         (xin, list(w.placements)), out)(x, w)


def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    wg, wi, wo = (params[k] for k in ("wg", "wi", "wo"))
    h = torch.nn.functional.silu(project(x, wg, True)) * project(x, wi, True)
    return project(h, wo, True)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

class _ShardedXent(torch.autograd.Function):
    """The summed cross-entropy of a chunk of DTensor logits (B, chunk, V),
    the rows placed as the batch and the vocab split over `model` (the
    vocab-parallel loss): each rank takes the max, the sum of exponentials
    and the target logit over its own columns, and only those (B, chunk)
    values cross `model`.  The backward, softmax minus one-hot, is local.
    DTensor's own rules for ``logsumexp``, ``gather`` and their backwards
    gather the logits whole or move them between layouts."""

    @staticmethod
    def forward(ctx, logits, labels, valid_vocab: int):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        mesh, names = logits.device_mesh, logits.device_mesh.mesh_dim_names
        rows = row_placements(mesh, logits.shape[0])
        cols = [Shard(logits.dim() - 1) if n == "model" else p for n, p in zip(names, rows)]
        logits = logits.redistribute(mesh, cols)
        local = logits.to_local()
        lo = compute_local_shape_and_global_offset(logits.shape, mesh, cols)[1][-1]
        if valid_vocab and valid_vocab < logits.shape[-1]:
            col = lo + torch.arange(local.shape[-1], device=local.device)
            local = local.masked_fill(col >= valid_vocab, -1e30)

        def over_model(t, op):
            pend = [Partial(op) if n == "model" else p for n, p in zip(names, rows)]
            return DTensor.from_local(t, mesh, pend, run_check=False).redistribute(
                mesh, rows).to_local()

        mx = over_model(local.amax(dim=-1), "max")
        e = torch.exp(local - mx[..., None])
        se = over_model(e.sum(dim=-1), "sum")
        lbl = labels.redistribute(mesh, rows).to_local().long()
        inside = (lbl >= lo) & (lbl < lo + local.shape[-1])
        idx = torch.where(inside, lbl - lo, torch.zeros_like(lbl))
        tgt = over_model(torch.where(inside, torch.gather(local, -1, idx[..., None])[..., 0],
                                     torch.zeros_like(mx)), "sum")
        ctx.save_for_backward(e / se[..., None], idx, inside)
        ctx.layout = (mesh, cols, logits.shape, logits.stride())
        out = [Partial() if p.is_shard() else Replicate() for p in rows]
        return DTensor.from_local((torch.log(se) + mx - tgt).sum(), mesh, out, run_check=False)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        p, idx, inside = ctx.saved_tensors
        mesh, cols, shape, stride = ctx.layout
        g = g.full_tensor() if isinstance(g, DTensor) else g
        grad = p.scatter_add(-1, idx[..., None], -inside[..., None].to(p.dtype)) * g
        return DTensor.from_local(grad, mesh, cols, run_check=False, shape=shape,
                                  stride=stride), None, None


def chunked_softmax_xent(x: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, valid_vocab: int = 0) -> torch.Tensor:
    """Cross-entropy over a huge vocab without materializing (B, S, V).

    x: (B, S, D) final hidden states; lm_head: (D, V); labels: (B, S) int.
    Walks S in blocks of ``chunk``; each block computes logits, the
    logsumexp and the target logit (on DTensors, ``_ShardedXent``).
    ``valid_vocab``: logits of padded vocab columns >= this are masked to
    -1e30 (0 = all valid).  Mean over B*S.
    """
    from torch.distributed.tensor import DTensor, Replicate

    B, S, D = x.shape
    V = lm_head.shape[-1]
    vocab_mask = (torch.arange(V, device=x.device) >= valid_vocab
                  if (valid_vocab and valid_vocab < V) else None)
    if S % chunk != 0:
        chunk = S  # one block for odd smoke shapes
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    labels = labels.long()
    pending = None
    for start in range(0, S, chunk):
        xc = x[:, start:start + chunk]
        lc = labels[:, start:start + chunk]
        logits = (xc @ lm_head).float()                           # (B, chunk, V)
        if isinstance(logits, DTensor):
            # each chunk's pending sum added on the rank, reduced once below
            part = _ShardedXent.apply(logits, lc, valid_vocab)
            pending = part.device_mesh, part.placements
            total = total + part.to_local(grad_placements=[Replicate()] * part.device_mesh.ndim)
            continue
        if vocab_mask is not None:
            logits = logits.masked_fill(vocab_mask, -1e30)
        lse = torch.logsumexp(logits, dim=-1)
        # the difference before the [..., 0]: on a vocab-sharded DTensor the
        # gather is a masked partial sum, which a view must not come between
        total = total + torch.sum((lse[..., None] - torch.gather(logits, -1, lc[..., None]))[..., 0])
    if pending is not None:
        mesh, placements = pending
        total = DTensor.from_local(total, mesh, placements, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim)
    return total / (B * S)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def count_params(params: Params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))
