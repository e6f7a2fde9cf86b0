"""Sharding rules: map every parameter / activation / cache leaf to a
partition spec for the production meshes, and a spec to DTensor placements.

The port's counterpart of the JAX package's ``parallel/sharding.py``; the
rule tables are its own copy, entry for entry.

Strategies
----------
``dp_tp``   batch over (pod, data); tensor-parallel over `model`;
            params replicated across `data`.
``fsdp_tp`` as above, plus parameters and optimizer state sharded over
            `data` *within* a pod (hybrid FSDP: replicated across pods so
            param all-gathers stay inside a pod, gradients cross pods once).

A spec is the reference's ``PartitionSpec`` entries as a tuple, one entry
per leading tensor dim (missing trailing entries are replicated): ``None``,
an axis name, or a tuple of axis names, e.g. ``(None, "model")`` or
``(("pod", "data"), None)``.  A spec tree is a flat dict keyed by the
leaf's dotted key path (``utils.tree.tree_paths``), in flatten order.
``param_placements`` turns a spec into the placements of a
``torch.distributed.tensor`` DTensor on a ``DeviceMesh``.

A "mesh" here is a ``DeviceMesh``, a ``parallel.collectives.World`` (one
``data`` axis of ``world.size`` ranks: the trainer's form), or any object
with ``axis_names`` and ``devices.shape`` (the JAX mesh's interface).

Optimizer state is always ZeRO-1 sharded (``launch/specs.opt_state_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.collectives import World
from repro_torch.utils.tree import tree_leaves, tree_paths

Spec = Tuple[Any, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a DeviceMesh, a World or a JAX-like mesh."""
    if isinstance(mesh, World):
        return {"data": mesh.size}
    if hasattr(mesh, "mesh_dim_names"):                  # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def batch_shardable(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """The axes the batch dim is split over, or None (replicated)."""
    axes = batch_axes(mesh)
    size = 1
    for a in axes:
        size *= mesh_axis_size(mesh, a)
    if batch % size == 0:
        return axes
    if batch % mesh_axis_size(mesh, "data") == 0:
        return ("data",)
    return None


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

# trailing-dims rules: (parent, leaf) -> tuple of axis roles
# roles: "f" = fsdp axis (data when fsdp_tp else None), "m" = model, None = repl.
_RULES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("attn", "wq"): ("f", "m"),
    ("attn", "wk"): ("f", "m"),
    ("attn", "wv"): ("f", "m"),
    ("attn", "wo"): ("m", "f"),
    ("attn", "w_q"): ("f", "m"),
    ("attn", "w_uk"): ("f", "m"),
    ("attn", "w_uv"): ("f", "m"),
    ("attn", "w_o"): ("m", "f"),
    ("attn", "w_dkv"): ("f", None),
    ("attn", "w_kr"): ("f", None),
    ("attn", "ln_kv"): (None,),
    ("xattn", "wq"): ("f", "m"),
    ("xattn", "wk"): ("f", "m"),
    ("xattn", "wv"): ("f", "m"),
    ("xattn", "wo"): ("m", "f"),
    ("mlp", "wi"): ("f", "m"),
    ("mlp", "wg"): ("f", "m"),
    ("mlp", "wo"): ("m", "f"),
    ("shared", "wi"): ("f", "m"),
    ("shared", "wg"): ("f", "m"),
    ("shared", "wo"): ("m", "f"),
    ("moe", "router"): ("f", None),
    ("moe", "wi"): ("m", "f", None),
    ("moe", "wg"): ("m", "f", None),
    ("moe", "wo"): ("m", None, "f"),
    ("embed", "w"): ("f", "m"),
    ("lm_head", "w"): ("f", "m"),
    # SSM (mamba) ----------------------------------------------------------
    ("ssm", "w_in"): ("f", "m"),        # (D, 2*d_inner)
    ("ssm", "w_x"): ("f", "m"),         # conv/in projections on d_inner
    ("ssm", "conv_w"): (None, "m"),     # (d_conv, d_inner)
    ("ssm", "conv_b"): ("m",),
    ("ssm", "w_bcdt"): ("m", None),     # (d_inner, 2*d_state+dt_rank)
    ("ssm", "w_dt"): (None, "m"),       # (dt_rank, d_inner)
    ("ssm", "dt_bias"): ("m",),
    ("ssm", "a_log"): ("m", None),      # (d_inner, d_state)
    ("ssm", "d_skip"): ("m",),
    ("ssm", "w_out"): ("m", "f"),       # (d_inner, D)
    # RWKV6 ----------------------------------------------------------------
    ("rwkv", "w_r"): ("f", "m"),
    ("rwkv", "w_k"): ("f", "m"),
    ("rwkv", "w_v"): ("f", "m"),
    ("rwkv", "w_g"): ("f", "m"),
    ("rwkv", "w_o"): ("m", "f"),
    ("rwkv", "w_decay"): ("f", "m"),
    ("rwkv", "w_decay_lora_a"): ("f", None),
    ("rwkv", "w_decay_lora_b"): (None, "m"),
    ("rwkv", "u_bonus"): ("m",),
    ("rwkv", "mix"): (None, None),
    ("rwkv", "wk_ch"): ("f", "m"),      # channel-mix
    ("rwkv", "wv_ch"): ("m", "f"),
    ("rwkv", "wr_ch"): ("f", None),
}

# §Perf variant (cfg.moe_shard == "edim_dff"): keep experts on `model` but
# move the fsdp axis off the CONTRACTING d_model dim onto d_ff, so matmuls
# never contract a sharded dim — XLA stops all-gathering expert weights and
# instead all-reduces the (small) activations.  Same storage footprint.
_MOE_DFF_RULES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("moe", "wi"): ("m", None, "f"),
    ("moe", "wg"): ("m", None, "f"),
    ("moe", "wo"): ("m", "f", None),
}

# §Perf variant "dff_only" (dp_tp MoE, e.g. moonshot): replicate the expert
# dim and TP-shard d_ff — the dispatch/combine einsums see no sharded E, so
# their backward stops all-gathering (E,B,C,D); the wo partial sums defer
# through the combine to a (B,S,D)-sized all-reduce.
_MOE_DFF_ONLY_RULES: Dict[Tuple[str, str], Tuple[Optional[str], ...]] = {
    ("moe", "wi"): (None, None, "m"),
    ("moe", "wg"): (None, None, "m"),
    ("moe", "wo"): (None, "m", None),
}


def _leaf_spec(path: Tuple[str, ...], ndim: int, strategy: str,
               moe_shard: str = "edim_dmodel") -> Spec:
    f = "data" if strategy == "fsdp_tp" else None
    key = None
    for i in range(len(path) - 1):
        if (path[i], path[-1]) in _RULES:
            key = (path[i], path[-1])
    if key is None and len(path) >= 2 and (path[-2], path[-1]) in _RULES:
        key = (path[-2], path[-1])
    if key is None:
        return ()  # norms, biases, scalars: replicated
    roles = _RULES[key]
    if moe_shard == "edim_dff" and key in _MOE_DFF_RULES:
        roles = _MOE_DFF_RULES[key]
    elif moe_shard == "dff_only" and key in _MOE_DFF_ONLY_RULES:
        roles = _MOE_DFF_ONLY_RULES[key]
    spec = tuple({"f": f, "m": "model"}.get(r, None) if isinstance(r, str) else None
                 for r in roles)
    if len(spec) > ndim:       # un-stacked single layer params
        spec = spec[-ndim:]
    pad = (None,) * (ndim - len(spec))
    return pad + spec


def _path_names(path: str) -> Tuple[str, ...]:
    """The key names of a dotted key path (``utils.tree.tree_paths``)."""
    return tuple(path.split("."))


def param_specs(params: Any, cfg: ModelConfig) -> Dict[str, Spec]:
    """``{key path: spec}`` for a parameter tree (tensors, meta or real)."""
    moe_shard = getattr(cfg, "moe_shard", "edim_dmodel")
    return {path: _leaf_spec(_path_names(path), leaf.dim(), cfg.sharding, moe_shard)
            for path, leaf in zip(tree_paths(params), tree_leaves(params))}


def param_placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements of one spec on a DeviceMesh: ``Shard(d)`` on each
    mesh dim that tensor dim ``d``'s entry names, ``Replicate()`` on the
    others.  A dim named by several axes (``("pod", "data")``) is split
    over them in mesh order, major first, as a PartitionSpec splits it."""
    from torch.distributed.tensor import Replicate, Shard

    out: List[Any] = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple) and axis in entry)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names mesh axis {axis!r} on two tensor dims")
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_shardings(params: Any, cfg: ModelConfig, mesh) -> Dict[str, List[Any]]:
    """``{key path: placements}`` on a DeviceMesh."""
    return {path: param_placements(spec, mesh)
            for path, spec in param_specs(params, cfg).items()}


# ---------------------------------------------------------------------------
# activation / batch / cache specs
# ---------------------------------------------------------------------------

def data_batch_spec(mesh, batch: int) -> Spec:
    """Per-dim placement of a ``(batch, seq)`` array: ``(axes, None)`` or
    ``(None, None)``."""
    axes = batch_shardable(mesh, batch)
    return (axes, None) if axes else (None, None)


def row_placements(mesh, batch: int) -> List[Any]:
    """Placements of an activation whose dim 0 is a batch of ``batch`` rows:
    ``Shard(0)`` on the axes the batch splits over (``batch_shardable``),
    ``Replicate()`` on the others, `model` among them."""
    from torch.distributed.tensor import Replicate, Shard

    rows = batch_shardable(mesh, batch) or ()
    return [Shard(0) if n in rows else Replicate() for n in mesh.mesh_dim_names]


class _GradLikeInput(torch.autograd.Function):
    """The identity, whose backward lays the gradient out in memory as the
    input was: ``local_map`` wraps a local gradient in a DTensor that
    claims the forward input's strides, and a later view of it (the
    backward of the reshape that made a transposed input) would read memory
    laid out otherwise in the wrong order."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.new_empty_strided(*ctx.layout).copy_(g)


class AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` along dim 0 (``recv`` / ``send``:
    rows from / to each rank), its backward the reverse exchange."""

    @staticmethod
    def forward(ctx, x, recv, send, group):
        from torch.distributed import _functional_collectives as funcol

        ctx.args = (send, recv, group)
        return funcol.wait_tensor(funcol.all_to_all_single(x, recv, send, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        send, recv, group = ctx.args
        return (funcol.wait_tensor(funcol.all_to_all_single(g.contiguous(), send, recv, group)),
                None, None, None)


def rows_to_columns(y, mesh, axis: str):
    """Inside ``on_shards``: ``y`` (R, ..., N/k), every rank's product for
    all R rows (gathered over ``axis``, k ranks) and its own N/k columns,
    exchanged over ``axis`` (one all-to-all) into this rank's R/k rows and
    every column: (R/k, ..., N), columns in rank order."""
    k, group = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_group(axis)
    n = y.shape[0] // k
    got = AllToAll.apply(y.contiguous(), [n] * k, [n] * k, group)      # k blocks of n rows
    got = got.reshape(k, n, *y.shape[1:]).movedim(0, -2)                 # (n, ..., k, N/k)
    return got.reshape(*got.shape[:-2], -1)


def rows_gathered(x, w) -> bool:
    """Whether a product of ``x`` (its rows, dim 0, split over `data`)
    with a weight ``w`` whose output columns the specs split over `data`
    (an fsdp ``(.., "data")`` leaf) moves less by gathering the rows than
    the weight: a decode step's few rows, not a training batch's.  Then
    each rank multiplies every row by its own columns and one all-to-all
    returns its rows (``rows_to_columns``), where XLA's compiled decode
    also gathers the activations and leaves the weight split."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or "data" not in x.device_mesh.mesh_dim_names:
        return False
    names = x.device_mesh.mesh_dim_names
    i, cols = names.index("data"), w.dim() - 1
    others = all(not pw.is_shard(cols) for n, pw in zip(names, w.placements) if n != "data")
    return (x.placements[i].is_shard(0) and w.placements[i].is_shard(cols) and others
            and x.numel() < w.numel())


def on_shards(fn, mesh, in_placements, out_placements):
    """``fn`` run by each rank on its local shards of its DTensor arguments,
    redistributed first to ``in_placements`` (``local_map``; ``None`` for an
    argument that is not a tensor), its outputs placed by
    ``out_placements``: a fixed lowering where DTensor's per-op strategy
    choice would not keep the specs' layout.

    Gradients flow through.  An argument that is whole on a mesh axis over
    which another argument is split (a weight beside a batch split over
    `data`, the shared B and C of a scan split by channel over `model`) is
    used by every rank for its own share of the work: its gradient is a
    pending sum (``Partial``) over that axis."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    placed = [pl for pl in in_placements if pl is not None]
    split = [any(pl[i].is_shard() for pl in placed) for i in range(mesh.ndim)]
    grads = tuple(None if pl is None else
                  [Partial() if split[i] and not p.is_shard() else p for i, p in enumerate(pl)]
                  for pl in in_placements)

    def local(*args):
        return fn(*(_GradLikeInput.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                    else a for a in args))
    return local_map(local, out_placements=out_placements, in_placements=tuple(in_placements),
                     in_grad_placements=grads, device_mesh=mesh, redistribute_inputs=True)


def tokens_divide(x) -> bool:
    """Whether ``on_tokens`` can split the S tokens of the (B, S, ...)
    activation ``x`` over `model` (S a multiple of its ways; always on
    plain tensors).  Where it cannot (a decode step: S = 1), the products
    of weights whole over `model` go through ``linear``, which splits their
    columns."""
    from torch.distributed.tensor import DTensor

    return not isinstance(x, DTensor) or x.shape[1] % mesh_axis_size(x.device_mesh, "model") == 0


def on_tokens(fn, acts, weights):
    """``fn(*acts, *weights)``, token-wise in the (B, S, ...) activations
    ``acts``, whose S divides `model` (``tokens_divide``).  On DTensors each
    rank takes its batch rows and its S / `model` tokens, with the weights
    whole (``on_shards``: an fsdp split gathered first, the gradient a
    pending sum over the axes that split the tokens); the output is placed
    as the activations.  For products whose weights the rules leave whole
    over `model` (RWKV's channel mix and decay LoRA, MLA's latent and
    rope-key projections): without the split every `model` rank would run
    every token's products.  Plain tensors: ``fn`` as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(acts[0], DTensor):
        return fn(*acts, *weights)
    if not tokens_divide(acts[0]):
        raise ValueError(f"{acts[0].shape[1]} tokens do not split over `model`: use linear")
    mesh, B = acts[0].device_mesh, acts[0].shape[0]
    tok = with_model(mesh, row_placements(mesh, B), Shard(1))
    whole = [Replicate()] * mesh.ndim
    return on_shards(fn, mesh, (*(tok for _ in acts), *(whole for _ in weights)),
                     tok)(*acts, *weights)


def token_product(x, w):
    """``x @ w`` for a weight the specs leave whole over `model`: split by
    tokens (``on_tokens``) where they divide `model`, else by the weight's
    columns (``linear``), each `model` rank its slice of the output."""
    if tokens_divide(x):
        return on_tokens(torch.matmul, (x,), (w,))
    return linear(x, w)


def rows_whole(x) -> bool:
    """Whether the DTensor ``x`` (dim 0 its batch rows) holds its rows whole
    over `data`: a batch smaller than the data ways (long-context decode, a
    batch of one), which ``batch_shardable`` leaves replicated.  Then every
    `data` rank would run the whole step; ``linear`` splits the products
    over `data` instead, and the residual stream lies split on d_model over
    it (``constrain_stream``).  False on plain tensors and on a mesh with no
    `data` axis."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor) or "data" not in x.device_mesh.mesh_dim_names:
        return False
    return "data" not in (batch_shardable(x.device_mesh, x.shape[0]) or ())


def constrain_stream(x):
    """``x``, the residual stream (B, [S,] D) between the products, and its
    gradient placed by ``constrain_rows`` where the batch splits over
    `data`.  Where it does not (``rows_whole``), d_model is split over
    `data` instead, the layout the reference's compiled long-context step
    keeps (its products then contract each rank's slice of d_model, or
    write it): every axis but `data` is placed first (a pending sum over
    `model` reduced on each rank's d_model slice, a split gathered), then
    `data` (a pending sum reduce-scattered, a whole tensor sliced, which
    moves nothing).  Plain tensors pass through."""
    from torch.distributed.tensor import Shard

    if not rows_whole(x):
        return constrain_rows(x)
    mesh = x.device_mesh
    want = [Shard(x.dim() - 1) if n == "data" else p
            for n, p in zip(mesh.mesh_dim_names, row_placements(mesh, x.shape[0]))]
    first = [p if n == "data" else w for n, p, w in zip(mesh.mesh_dim_names, x.placements, want)]
    if first != list(x.placements):
        x = _Constrain.apply(x, tuple(first), None)
    return x if want == list(x.placements) else _Constrain.apply(x, tuple(want), None)


def linear(x, w):
    """``x @ w`` of an activation (..., K) and a weight (K, N), each rank on
    its shards by a fixed rule (``on_shards``), where DTensor's own matmul
    strategy would choose by a cost model that differs by torch release.
    For each mesh axis, by ``x``'s placement on it and then ``w``'s:

    - ``x`` split on a leading dim (batch rows, tokens): that split kept,
      the weight whole over the axis (an fsdp split gathered: FSDP);
    - ``x`` split on K (the residual stream over `data`, ``rows_whole``),
      or whole with the weight's rows split: each rank contracts its slice
      of K against its rows of the weight (a whole weight is sliced, which
      moves nothing), and the output is a pending sum;
    - otherwise each rank takes its slice of the weight's columns: its own
      shard, or, over `data` and `model`, a slice of a weight whole over
      the axis (where a whole weight met a whole activation, every rank
      would repeat the product); over `pod` both stay whole (the pods are
      replicas of a batch their axis does not split).

    A pending sum over any axis but `model` is all-reduced here (the
    output feeds a nonlinearity or an attention); over `model` it is left
    to the layer's constraint, as ``x @ w`` leaves it.  Plain tensors:
    ``x @ w``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(x, DTensor):
        return x @ w
    mesh, last = x.device_mesh, x.dim() - 1
    xin, win, out = [], [], []
    for name, px, pw in zip(mesh.mesh_dim_names, x.placements, w.placements):
        if px.is_partial():
            raise ValueError(f"linear takes no pending sum: {x.placements}")
        if px.is_shard() and px.dim < last:
            xin.append(px), win.append(Replicate()), out.append(px)
        elif px.is_shard() or pw.is_shard(0):
            if pw.is_shard(1):
                raise ValueError(f"linear: K split over an axis that splits the weight's columns "
                                 f"({x.placements}, {w.placements})")
            xin.append(Shard(last)), win.append(Shard(0)), out.append(Partial())
        elif pw.is_shard(1) or name in ("data", "model"):
            xin.append(px), win.append(Shard(1)), out.append(Shard(last))
        else:                                   # `pod` at long-context decode: the replicas
            xin.append(px), win.append(pw), out.append(px)
    y = on_shards(torch.matmul, mesh, (xin, win), out)(x, w)
    reduced = [Replicate() if p.is_partial() and n != "model" else p
               for n, p in zip(mesh.mesh_dim_names, y.placements)]
    return y if reduced == list(y.placements) else y.redistribute(mesh, reduced)


def with_model(mesh, placements, p) -> List[Any]:
    """``placements`` on ``mesh`` with the `model` axis's entry ``p``."""
    return [p if n == "model" else q for n, q in zip(mesh.mesh_dim_names, placements)]


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient to
    ``grad_placements`` (the same placements unless given: the transpose of
    a sharding constraint is the same constraint).  DTensor's own
    ``redistribute`` sends the gradient back to the input's placements, a
    pending sum among them, and the products of the backward then gather
    weights to multiply that pending sum whole."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements):
        ctx.placements = grad_placements or placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None, None


def grad_as_placed(x):
    """``x`` unchanged, and its gradient placed as ``x`` is: the gradient of
    a projection's output put back on its column shards before the
    product's backward, which DTensor would otherwise run whole where the
    attention took its rows over `model`.  Plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(x.placements), None)


def constrain_rows(x, grad_placements=None):
    """``x`` placed by ``row_placements``, a pending sum reduced, and its
    gradient placed so too (or by ``grad_placements``): the residual
    stream's layout between the layers, as the specs give it (batch over
    the data axes, features whole on every `model` rank; the counterpart of
    ``with_sharding_constraint(x, P(batch_axes))``).  DTensor alone picks
    each op's output layout by its cost model, and moves the batch onto
    `model` too where that is cheaper for one op.  Plain tensors pass
    through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(row_placements(x.device_mesh, x.shape[0])),
                            grad_placements)


def constrain_cols(x):
    """``x`` (B, S, F) placed by ``row_placements`` with F split over
    `model`, and its gradient so too: the input of a product whose weight
    the specs split on its rows over `model` (an attention's ``wo``).  The
    product is then local and its output a pending sum, as in the layers
    whose heads `model` splits; where the attention took its rows over
    `model` (``attention._on_shards``), DTensor would instead run the
    weight's gradient whole on every `model` rank.  Plain tensors pass
    through."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return _Constrain.apply(x, tuple(with_model(mesh, row_placements(mesh, x.shape[0]),
                                                Shard(2))), None)


def row_mean(t, dims: Tuple[int, ...]):
    """``t.mean(dim=dims)`` over leading dims that include its batch rows
    (dim 0).  On DTensors each rank sums its own rows (``on_shards``) and
    the sums are all-reduced over the batch axes, once, to a replicated
    result: DTensor's own strategies for a mean over a split dim differ by
    torch release (a reduce-scatter of the whole tensor in one, an
    all-reduce of the result in another).  Plain tensors: ``mean``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t.mean(dim=dims)
    mesh = t.device_mesh
    rows = row_placements(mesh, t.shape[0])
    count = 1
    for d in dims:
        count *= t.shape[d]
    summed = on_shards(lambda u: u.sum(dim=dims), mesh, (rows,),
                       [Partial() if p.is_shard() else Replicate() for p in rows])(t)
    return summed.redistribute(mesh, [Replicate()] * mesh.ndim) / count


def seq_axes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The batch axes ``cfg.seq_parallel`` names (``"data"``, ``"pod,data"``;
    empty: no sequence parallelism)."""
    return tuple(a for a in cfg.seq_parallel.split(",") if a)


def seq_placements(mesh, axes: Tuple[str, ...]) -> List[Any]:
    """Placements of a (B, S, ...) activation held sequence-parallel:
    ``Shard(0)`` on the batch ``axes``, ``Shard(1)`` on `model`,
    ``Replicate()`` on the others (the reference's ``P(axes, "model",
    None)``)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if n in axes else Shard(1) if n == "model" else Replicate()
            for n in mesh.mesh_dim_names]


def constrain_seq(x, axes: Tuple[str, ...], grad_placements=None):
    """``x`` placed by ``seq_placements`` (a pending sum over `model`
    reduce-scattered along S), and its gradient so too (or by
    ``grad_placements``): the residual stream between and around the
    blocks under ``cfg.seq_parallel``.  Plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _Constrain.apply(x, tuple(seq_placements(x.device_mesh, axes)), grad_placements)


def cache_pspec(cfg: ModelConfig, mesh, batch: int, leaf_path: Tuple[str, ...],
                ndim: int) -> Spec:
    """Decode-cache sharding.

    Layout (L, B, W, ...) — batch over the data axes when divisible;
    otherwise the sequence (W) dim is sharded over them (flash-decoding);
    kv-heads over `model` when divisible, else W also takes `model`.

    Recurrent-state leaves (SSM/RWKV) have no W dim: their feature axis is
    `model`-sharded and batch over data when divisible.
    """
    baxes = batch_shardable(mesh, batch)
    leaf = leaf_path[-1]
    # --- recurrent / cross-attention states, dispatched by leaf name ------
    if leaf == "conv":          # (L, B, d_conv-1, d_inner)
        return (None, baxes, None, "model")
    if leaf == "ssm":           # (L, B, d_inner, d_state)
        return (None, baxes, "model", None)
    if leaf == "state":         # (L, B, H, hd, hd)  rwkv wkv state
        return (None, baxes, "model", None, None)
    if leaf in ("tm_x", "cm_x"):  # (L, B, D)
        return (None, baxes, "model")
    if leaf in ("xk", "xv"):    # (L, B, enc_seq, KV, hd)
        m = mesh_axis_size(mesh, "model")
        kv_ok = cfg.num_kv_heads % m == 0
        # enc_seq (1500) is not tile-friendly: replicate over `model`
        # unless the kv-heads divide.
        return (None, baxes, None, "model" if kv_ok else None, None)
    m = mesh_axis_size(mesh, "model")
    kv_shardable = cfg.num_kv_heads % m == 0 and cfg.attention == "gqa"
    w_axes = []
    if baxes is None:
        w_axes.extend(batch_axes(mesh))
    if not kv_shardable:
        w_axes.append("model")
    spec: List[Any] = [None] * ndim
    # dims: (L, B, W, [KV, hd]) or (L, B, W, latent)
    b_dim, w_dim = ndim - 3 if ndim >= 4 else 1, ndim - 2 if ndim >= 4 else 2
    if ndim == 4:           # (L, B, W, latent) or (L, B, W, feat)
        b_dim, w_dim = 1, 2
    elif ndim == 5:         # (L, B, W, KV, hd)
        b_dim, w_dim = 1, 2
        if kv_shardable:
            spec[3] = "model"
    elif ndim == 3:         # (L, B, feat)  (ssm states)
        spec[1] = baxes
        spec[2] = "model"
        return tuple(spec)
    if baxes:
        spec[b_dim] = baxes
    if w_axes:
        spec[w_dim] = tuple(w_axes) if len(w_axes) > 1 else w_axes[0]
    return tuple(spec)


def stacked_empty(val, n: int):
    """An uninitialised ``(n, *val.shape)`` buffer of ``val``'s dtype and
    device, for a stack written a slice at a time.  On a DTensor it keeps
    ``val``'s sharding (shifted past the new dim) and makes a pending sum
    (``Partial``) replicated, since a buffer holds no pending sum and later
    slices may come placed otherwise; each write then redistributes its
    slice to the buffer.  Nothing is communicated to make it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(val, DTensor):
        return val.new_empty((n,) + tuple(val.shape))
    def shifted(p):
        if not p.is_shard():
            return Replicate()
        if hasattr(p, "split_factor"):                       # a strided shard
            return type(p)(p.dim + 1, split_factor=p.split_factor)
        return Shard(p.dim + 1)

    local = val.to_local()
    placements = [shifted(p) for p in val.placements]
    shape = (n,) + tuple(val.shape)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local.new_empty((n,) + tuple(local.shape)), val.device_mesh,
                              placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def lookup(table, tokens):
    """``table[tokens]``, the embedding lookup.

    On DTensors each rank looks up its own tokens' rows (``on_shards``) in
    the table gathered over every mesh axis but `model`, which keeps its
    slice of the embedding dim; the table's gradient is then a partial sum
    over the axes the tokens split.  DTensor's own rules for ``index`` and
    its backward ``index_put`` cannot take a batch split over two mesh axes
    (``("pod", "data")``) in every torch release.

    Where the specs split the table's rows (``fsdp_tp``: over `data`) and
    the step's tokens are fewer than its rows (a decode step), the table
    stays split (``_vocab_parallel``): gathering it would move more than
    the whole batch's tokens and rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    tok = list(tokens.placements)
    if any(p.is_shard() for n, p in zip(mesh.mesh_dim_names, tok) if n == "model"):
        raise ValueError("lookup takes tokens replicated over `model`")
    if tokens.numel() < table.shape[0] and any(
            p.is_shard(0) for n, p in zip(mesh.mesh_dim_names, table.placements) if n != "model"):
        return _vocab_parallel(table, tokens)
    tab = with_model(mesh, [Replicate()] * mesh.ndim, Shard(1))
    fn = on_shards(lambda t, i: t[i.long()], mesh, (tab, tok),
                   with_model(mesh, tok, Shard(tokens.dim())))
    return fn(table, tokens)


def _vocab_parallel(table, tokens):
    """``lookup`` on the table's own row shards: the tokens gathered over
    the axes that split the table's rows, each rank looks up those in its
    rows (zeros for the others), and the pending sum is reduced onto the
    tokens' own placement (a reduce-scatter where they were split, an
    all-reduce where they were whole)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, names = table.device_mesh, table.device_mesh.mesh_dim_names
    split = [n != "model" and p.is_shard(0) for n, p in zip(names, table.placements)]
    tab = [Shard(0) if s else Replicate() for s in split]
    tab = with_model(mesh, tab, Shard(1))
    tok = [Replicate() if s else p for s, p in zip(split, tokens.placements)]
    shape, lo = compute_local_shape_and_global_offset(table.shape, mesh, tab)

    def local(t, i):
        i = i.long() - lo[0]
        inside = (i >= 0) & (i < shape[0])
        return t[i.clamp(0, shape[0] - 1)] * inside[..., None].to(t.dtype)

    out = [Partial() if s else p for s, p in zip(split, tok)]
    got = on_shards(local, mesh, (tab, tok), with_model(mesh, out, Shard(tokens.dim())))(
        table, tokens)
    return got.redistribute(mesh, with_model(mesh, list(tokens.placements), Shard(tokens.dim())))


def write_at(buf, dim: int, index: int, value) -> None:
    """``buf.select(dim, index).copy_(value)``, in place.

    On a DTensor sharded along ``dim`` (a ring-buffer cache whose slots are
    split over ranks), only the rank whose shard holds ``index`` writes, into
    its local shard; DTensor alone would gather the whole buffer to select
    one slot, and the write would land in that copy.  ``value`` is first
    placed as the slot is on the other mesh dims."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(buf, DTensor) or not any(p.is_shard(dim) for p in buf.placements):
        buf.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    local_shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    slot = [Replicate() if p.is_shard(dim) else
            Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p for p in buf.placements]
    local = value.redistribute(mesh, slot).to_local()
    if offset[dim] <= index < offset[dim] + local_shape[dim]:
        buf.to_local().select(dim, index - offset[dim]).copy_(local)


def shard_batch(batch: Dict[str, np.ndarray], world: World) -> Dict[str, np.ndarray]:
    """This process's rows of a global batch: rows ``[r*B/K, (r+1)*B/K)``
    for rank ``r`` of ``K`` when ``K`` divides ``B``, else all of them."""
    if world.local_ranks != 1:
        raise ValueError("shard_batch is for a process that holds one rank")
    B = len(next(iter(batch.values())))
    if batch_shardable(world, B) is None:
        return batch
    n = B // world.size
    return {k: v[world.rank * n:(world.rank + 1) * n] for k, v in batch.items()}
