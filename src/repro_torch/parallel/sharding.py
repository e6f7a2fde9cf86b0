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

    On DTensors each rank looks up its own tokens' rows (``local_map``) in
    the table gathered over every mesh axis but `model`, which keeps its
    slice of the embedding dim; the table's gradient is then a partial sum
    over the axes the tokens split.  DTensor's own rules for ``index`` and
    its backward ``index_put`` cannot take a batch split over two mesh axes
    (``("pod", "data")``) in every torch release."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(table, DTensor):
        return table[tokens.long()]
    names = table.device_mesh.mesh_dim_names
    tok = list(tokens.placements)
    if any(p.is_shard() for n, p in zip(names, tok) if n == "model"):
        raise ValueError("lookup takes tokens replicated over `model`")
    tab = [Shard(1) if n == "model" else Replicate() for n in names]
    out = [Shard(tokens.dim()) if n == "model" else p for n, p in zip(names, tok)]
    grad = [Shard(1) if n == "model" else Partial() if p.is_shard() else Replicate()
            for n, p in zip(names, tok)]
    fn = local_map(lambda t, i: t[i.long()], out_placements=out, in_placements=(tab, tok),
                   in_grad_placements=(grad, tok), device_mesh=table.device_mesh,
                   redistribute_inputs=True)
    return fn(table, tokens)


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
