"""Meta-tensor stand-ins + partition specs for every (arch x input-shape),
and the step functions that run on DTensors placed by them.

The port's counterpart of the JAX package's ``launch/specs.py``.  Nothing
here allocates memory: params, optimizer state, batches and KV caches are
trees of ``meta`` tensors (the counterpart of ``jax.ShapeDtypeStruct``).
Specs are flat dicts ``{key path: spec}`` (``parallel/sharding.py``);
``distribute`` turns a tree and its specs into DTensors on a DeviceMesh,
which is how the dry run (meta shards over a fake process group) and a real
mesh run the same step.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.registry import ModelApi
from repro_torch.optim.optimizers import OptState
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import (tree_leaves, tree_map, tree_paths, tree_unflatten,
                                    value_and_grad)


class StepSpec(NamedTuple):
    """Everything the dry run needs to trace one (arch x shape x mesh) combo."""
    kind: str
    args: Tuple[Any, ...]            # meta-tensor trees; decode's cache index is an int
    in_shardings: Tuple[Any, ...]    # a spec dict per tensor argument, None for the int
    out_shardings: Any
    donate_argnums: Tuple[int, ...]


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def params_shape(api: ModelApi) -> Any:
    return api.init(None, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """Training/prefill batch: meta tensors + specs."""
    B, S = shape.global_batch, shape.seq_len
    bspec = shd.data_batch_spec(mesh, B) if mesh is not None else ()
    b0 = bspec[0] if bspec else None
    batch = {"tokens": _meta((B, S), torch.int32)}
    specs = {"tokens": bspec}
    if shape.kind == "train":
        batch["labels"] = _meta((B, S), torch.int32)
        specs["labels"] = bspec
    if cfg.family == "vlm" and cfg.prefix_embeds:
        batch["prefix_embeds"] = _meta((B, cfg.prefix_embeds, cfg.d_model), torch_dtype(cfg.dtype))
        specs["prefix_embeds"] = (b0, None, "model")
    if cfg.family == "encdec":
        batch["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), torch_dtype(cfg.dtype))
        specs["frames"] = (b0, None, None)
    return batch, specs


def decode_batch_specs(cfg: ModelConfig, shape: InputShape, mesh):
    B = shape.global_batch
    bspec = shd.data_batch_spec(mesh, B) if mesh is not None else ()
    batch = {"tokens": _meta((B, 1), torch.int32)}
    specs = {"tokens": (bspec[0] if bspec else None, None)}
    # enc-dec cross-attention K/V live in the decode cache (computed once at
    # prefill), so the decode batch is tokens-only for every family.
    return batch, specs


def _is_shape_dtype(node) -> bool:
    return (isinstance(node, tuple) and len(node) == 2 and isinstance(node[0], tuple)
            and isinstance(node[1], torch.dtype))


def cache_structs(api: ModelApi, batch: int, cache_len: int):
    """``api.cache_spec``'s (shape, dtype) leaves as meta tensors."""
    def walk(node):
        if _is_shape_dtype(node):
            return _meta(*node)
        return {k: walk(v) for k, v in node.items()}
    return walk(api.cache_spec(batch, cache_len))


def cache_shardings(cfg: ModelConfig, mesh, batch: int, cache: Any) -> Dict[str, Any]:
    return {path: shd.cache_pspec(cfg, mesh, batch, shd._path_names(path), leaf.dim())
            for path, leaf in zip(tree_paths(cache), tree_leaves(cache))}


# ---------------------------------------------------------------------------
# optimizer-state sharding (ZeRO-1)
# ---------------------------------------------------------------------------

def _axes_of(spec) -> list:
    out = []
    for e in spec:
        out.extend(e if isinstance(e, tuple) else [e])
    return out


def opt_state_specs(params: Any, cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """m/nu are fp32 copies of params, additionally sharded over `data` on
    the first replicated dim that divides (ZeRO-1).  Keyed by the key paths
    of the optimizer state ``OptState(count, mu, nu)``."""
    pspecs = shd.param_specs(params, cfg)
    dsize = shd.mesh_axis_size(mesh, "data")

    def zero1(leaf, spec):
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        if "data" not in _axes_of(dims):
            for i, (d, s) in enumerate(zip(dims, leaf.shape)):
                if d is None and s % dsize == 0 and s >= dsize:
                    dims[i] = "data"
                    break
        return tuple(dims)

    moments = [zero1(leaf, pspecs[path])
               for path, leaf in zip(tree_paths(params), tree_leaves(params))]
    state_paths = tree_paths(OptState(0, params, params))
    return dict(zip(state_paths, [()] + moments + moments))


def opt_state_shape(params: Any, opt) -> Any:
    return opt.init(params)


# ---------------------------------------------------------------------------
# top-level StepSpec builders
# ---------------------------------------------------------------------------

def train_step_spec(api: ModelApi, shape: InputShape, mesh, opt) -> StepSpec:
    cfg = api.cfg
    p_meta = params_shape(api)
    o_meta = opt_state_shape(p_meta, opt)
    batch, bspecs = batch_specs(cfg, shape, mesh)
    p_specs = shd.param_specs(p_meta, cfg)
    o_specs = opt_state_specs(p_meta, cfg, mesh)
    in_sh = (p_specs, o_specs, bspecs)
    out_sh = (p_specs, o_specs, None)
    return StepSpec("train", (p_meta, o_meta, batch), in_sh, out_sh, (0, 1))


def prefill_step_spec(api: ModelApi, shape: InputShape, mesh) -> StepSpec:
    cfg = api.cfg
    p_meta = params_shape(api)
    batch, bspecs = batch_specs(cfg, shape, mesh)
    in_sh = (shd.param_specs(p_meta, cfg), bspecs)
    return StepSpec("prefill", (p_meta, batch), in_sh, None, ())


def decode_step_spec(api: ModelApi, shape: InputShape, mesh) -> StepSpec:
    """The cache index is a Python int, the last slot of a full cache: the
    port's decode reads it on the host (JAX passes an int32 scalar)."""
    cfg = api.cfg
    B = shape.global_batch
    p_meta = params_shape(api)
    batch, bspecs = decode_batch_specs(cfg, shape, mesh)
    cache = cache_structs(api, B, shape.seq_len)
    cache_sh = cache_shardings(cfg, mesh, B, cache)
    in_sh = (shd.param_specs(p_meta, cfg), bspecs, cache_sh, None)
    out_sh = (None, cache_sh)
    return StepSpec("decode", (p_meta, batch, cache, shape.seq_len - 1), in_sh, out_sh, (2,))


def _unshard_specs(api: ModelApi) -> Dict[str, Any]:
    """Param specs with the fsdp (`data`) axis removed — the compute-time
    layout for ZeRO-1-style stepping (cfg.fsdp_unshard_step)."""
    cfg = api.cfg.replace(sharding="dp_tp")
    return shd.param_specs(params_shape(api), cfg)


def step_spec(api: ModelApi, shape: InputShape, mesh, opt=None) -> StepSpec:
    if shape.kind == "train":
        return train_step_spec(api, shape, mesh, opt)
    if shape.kind == "prefill":
        return prefill_step_spec(api, shape, mesh)
    return decode_step_spec(api, shape, mesh)


# ---------------------------------------------------------------------------
# DTensors placed by the specs, and the step functions
# ---------------------------------------------------------------------------

def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def distribute(tree: Any, specs: Dict[str, Any], mesh) -> Any:
    """Each leaf of ``tree`` as a DTensor on ``mesh`` placed by its spec
    (the leaf is this process's full tensor; ``distribute_tensor`` keeps
    this rank's shard).  On a mesh of one rank the shard is the leaf
    itself, wrapped without a copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(leaf, placements):
        if mesh.size() == 1:
            return DTensor.from_local(leaf, mesh, placements, run_check=False)
        return distribute_tensor(leaf, mesh, placements)

    return tree_unflatten(tree, [one(leaf, shd.param_placements(specs[path], mesh))
                                 for path, leaf in zip(tree_paths(tree), tree_leaves(tree))])


def _constants_replicated(params: Any, *trees: Any):
    """On DTensors, the model's own constant tensors (rope angles,
    positions, masks, the optimizer's learning rate) are plain tensors that
    every rank builds alike: let DTensor ops take them as replicated.  So
    that nothing else is taken so, every tensor leaf of the step's inputs
    (``params`` and ``trees``: optimizer state, batch, cache) must then be a
    DTensor; a plain one raises ``TypeError``.  On plain parameters,
    nothing."""
    if not any(_is_dtensor(t) for t in tree_leaves(params)):
        return contextlib.nullcontext()
    for tree in (params, *trees):
        for path, t in zip(tree_paths(tree), tree_leaves(tree)):
            if isinstance(t, torch.Tensor) and not _is_dtensor(t):
                raise TypeError(f"{path or 'leaf'} is a plain tensor among DTensors; "
                                f"place it by its spec (specs.distribute)")
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _placed_like(tree: Any, specs: Optional[Dict[str, Any]]) -> Any:
    """Redistribute each DTensor leaf to the placements of its spec."""
    if specs is None:
        return tree
    return tree_unflatten(tree, [
        t.redistribute(t.device_mesh, shd.param_placements(specs[path], t.device_mesh))
        if _is_dtensor(t) else t
        for path, t in zip(tree_paths(tree), tree_leaves(tree))])


def reduce_grads(grads: Any, params: Any) -> Any:
    """Each DTensor gradient redistributed to its parameter's placements: a
    ``Partial`` gradient becomes an all-reduce where the parameter is
    replicated over an axis and a reduce-scatter where it is sharded.
    Plain tensors pass through."""
    return tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                    if _is_dtensor(p) else g, grads, params)


def _view_shape(shape, size) -> tuple:
    size = list(size)
    if -1 in size:
        known = 1
        for n in size:
            known *= n if n != -1 else 1
        total = 1
        for n in shape:
            total *= n
        size[size.index(-1)] = total // known
    return tuple(size)


def _splits_evenly(placements, shape, mesh_sizes) -> bool:
    """Whether every tensor dim split over two or more mesh dims is split
    into whole pieces (the product of their sizes divides it)."""
    for d, n in enumerate(shape):
        ways = [m for p, m in zip(placements, mesh_sizes) if p.is_shard() and p.dim == d]
        if len(ways) > 1 and n % math.prod(ways):
            return False
    return True


def _view_strategy(op_schema):
    """``aten.view`` on a DTensor: DTensor's own rule (no redistribution;
    a flatten of two sharded dims stays sharded) where it applies; where the
    view would split a sharded dim unevenly and that rule raises, its
    reshape rule, which replicates the mesh dim that splits it; and where a
    dim split over several mesh dims would not come out whole (both rules
    check one mesh dim at a time), the innermost of them is replicated too,
    until it does."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops._view_ops import dim_maps, propagate_shape_and_sharding
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    rules = dim_maps[torch.Tensor.view](*op_schema.args_schema, **op_schema.kwargs_schema)
    inp = op_schema.args_schema[0]
    mesh = op_schema.get_mesh_from_args(validate=False)
    shape = tuple(inp.shape)
    out_shape = _view_shape(shape, op_schema.args_schema[1])
    strategy = OpStrategy([])
    for spec in inp.strategies:
        src = list(spec.output_spec.placements)
        strict = True
        while True:
            try:
                tgt, out = propagate_shape_and_sharding(tuple(src), shape, rules,
                                                        tuple(mesh.shape), strict)
            except RuntimeError:
                if not strict:
                    raise
                strict = False             # an uneven split: let the reshape rule replicate
                continue
            if _splits_evenly(out, out_shape, tuple(mesh.shape)):
                break
            src[max(k for k, p in enumerate(src) if p.is_shard())] = Replicate()
        in_spec = DTensorSpec(mesh=mesh, placements=tuple(tgt),
                              tensor_meta=spec.output_spec.tensor_meta)
        strategy.strategies.append(OpSpec(
            output_specs=DTensorSpec(mesh=mesh, placements=tuple(out)), input_specs=(in_spec,),
            redistribute_cost=[generate_redistribute_costs(inp, in_spec)]))
    return strategy


def _flip_sharding(x, dims):
    """``aten.flip`` (the backward of ``cumsum``): any dim it does not flip
    may stay sharded, and a pending sum stays pending."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    flipped = {d % len(x.shape) for d in dims}
    return ([([Replicate()], [Replicate(), None]), ([Partial()], [Partial(), None])]
            + [([Shard(d)], [Shard(d), None]) for d in range(len(x.shape)) if d not in flipped])


_RULES_REGISTERED = False


def _register_dtensor_rules() -> None:
    """Two DTensor rules the model code needs, registered once a process
    (by the first ``make_step_fn``).  They replace DTensor's own for every
    DTensor user of the process, not only the steps built here:

    - ``aten.view`` and ``aten._unsafe_view`` get ``_view_strategy``: a view
      that would split a sharded dim unevenly (``(B, S, H * hd)`` ->
      ``(B, S, H, hd)`` with `model` wider than H) replicates that mesh dim
      first instead of raising; every other view keeps DTensor's rule.  The
      model code reshapes freshly made activations and never writes through
      such a view, so a copy in its place changes no result.
    - ``aten.flip`` gets ``_flip_sharding``: some torch releases have no
      rule for it."""
    global _RULES_REGISTERED
    if _RULES_REGISTERED:
        return
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops.utils import register_op_strategy
    from torch.distributed.tensor.experimental import register_sharding

    _RULES_REGISTERED = True
    for op in (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default):
        register_op_strategy(op, schema_info=RuntimeSchemaInfo(1))(_view_strategy)
    register_sharding(torch.ops.aten.flip.default)(_flip_sharding)


def make_step_fn(api: ModelApi, kind: str, opt=None):
    """The step of ``kind`` on plain tensors or on DTensors.

    ``train`` reduces each gradient to the placements of its parameter
    (``reduce_grads``) before the update, so the update runs on the layout
    the specs give the parameters.  With ``cfg.fsdp_unshard_step`` under ``fsdp_tp`` the
    parameters are first redistributed to the ``dp_tp`` placements (one
    all-gather of the parameter stack a step), where JAX constrains them
    with ``with_sharding_constraint``."""
    cfg = api.cfg
    _register_dtensor_rules()
    unshard = (_unshard_specs(api)
               if getattr(cfg, "fsdp_unshard_step", False)
               and cfg.sharding == "fsdp_tp" else None)
    if kind == "train":
        def train_step(params, opt_state, batch):
            with _constants_replicated(params, opt_state, batch):
                compute_params = _placed_like(params, unshard)
                (loss, metrics), grads = value_and_grad(api.loss_fn, compute_params, batch)
                grads = reduce_grads(grads, params)
                lr = 3e-4
                new_p, new_o = opt.update(params, opt_state, grads, lr)
            return new_p, new_o, {"loss": loss, **metrics}
        return train_step
    if kind == "prefill":
        def prefill_step(params, batch):
            with _constants_replicated(params, batch), torch.no_grad():
                logits, caches = api.prefill(_placed_like(params, unshard), batch)
            return logits
        return prefill_step
    if kind == "decode":
        def decode_step(params, batch, cache, cache_index):
            with _constants_replicated(params, batch, cache), torch.no_grad():
                return api.decode_step(params, batch, cache, cache_index)
        return decode_step
    raise ValueError(kind)
