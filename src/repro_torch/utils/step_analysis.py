"""What one step costs each device: FLOPs, bytes, collectives and memory,
read from the operations the eager port issues.

The port's counterpart of the JAX package's ``utils/hlo.py``.  That module
parses the compiled, SPMD-partitioned HLO of a step; the port has no
compiled program, so it ports the contract instead: ``analyze(step_fn,
*args)`` runs the step (in the dry run on DTensors whose shards are meta
tensors, over a fake process group) under a ``TorchDispatchMode`` and
returns a record with ``HloAnalysis``'s fields.

The mode returns ``NotImplemented`` for every operation on DTensors, so
DTensor lowers it first to the operations on this rank's local shards and
to the collectives its redistributions need, and the mode sees those.  So
every count is **per device**, like the reference's post-SPMD counts:

- ``flops``            matmul FLOPs (``torch.utils.flop_counter``'s
                       formulas: mm, bmm, addmm, baddbmm, convolutions,
                       attention) at local shapes; the reference counts
                       ``dot`` FLOPs alone
- ``bytes``            operand + output bytes of every aten op at
                       local shapes, views and allocation without a write
                       (``empty``) excluded: what the eager port really
                       moves, one kernel an op.  Not XLA's fusion
                       boundaries, so not comparable with a TPU figure
- ``collective_bytes`` output bytes per collective kind (the reference's
                       kind names, ``COLLECTIVE_KINDS``), from the
                       ``_c10d_functional`` ops DTensor issues; collectives
                       over a group of one rank move nothing and are left out
- ``collective_counts`` their number per kind
- ``collective_bytes_by_axis`` the same bytes split by the mesh axis whose
                       group ran them, which the roofline prices by link
- ``collective_elements_by_axis`` their output elements, split so too:
                       what compares with a compiler that carries a
                       collective in another dtype
- ``peak_bytes``       the peak of bytes held by tensors the step made
                       (this rank's), the counterpart of XLA's temp size

Eager mode runs every layer, so nothing is counted once for a loop of
layers and there is no ``while_trips``.  DTensor's own shape propagation
runs in a nested fake mode; those operations are not the step's and are
skipped.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_FUNCOL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL_NAMESPACES = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")

_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "detach", "alias", "lift_fresh", "_local_scalar_dense", "set_", "resize_",
               "_to_copy_meta"}


@dataclass
class StepAnalysis:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, int] = field(default_factory=dict)
    collective_bytes_by_axis: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collective_elements_by_axis: Dict[str, Dict[str, float]] = field(default_factory=dict)
    peak_bytes: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_axes(mesh) -> Dict[tuple, str]:
    """``{ranks of this rank's group: mesh axis}`` of a DeviceMesh.  Keyed
    by ranks, not by group name: DTensor may run a redistribution it
    planned on an equal mesh made earlier, over that mesh's groups."""
    from torch.distributed import get_process_group_ranks

    if mesh is None or not mesh.mesh_dim_names:
        return {}
    return {tuple(get_process_group_ranks(mesh.get_group(name))): name
            for name in mesh.mesh_dim_names}


class _Recorder(TorchDispatchMode):
    def __init__(self, group_axes: Dict[tuple, str], held: Any = ()):
        super().__init__()
        from torch._guards import active_fake_mode
        from torch.utils.flop_counter import flop_registry

        self._active_fake_mode = active_fake_mode
        self._flop_registry = flop_registry
        self._fake_on_entry = active_fake_mode()
        self._group_axes = group_axes
        self.out = StepAnalysis()
        self._cb: Dict[str, float] = defaultdict(float)
        self._cc: Dict[str, int] = defaultdict(int)
        self._by_axis: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self._el_by_axis: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self._live: Dict[int, int] = {}
        self._cur = 0
        # storages the step was handed (its arguments): an op that writes
        # into one in place makes no new memory
        self._held = {id(t.untyped_storage()) for t in _local_tensors(held)}

    def _free(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live or key in self._held:
            return
        n = storage.nbytes()
        self._live[key] = n
        self._cur += n
        self.out.peak_bytes = max(self.out.peak_bytes, self._cur)
        weakref.finalize(storage, self._free, key)

    def _collective(self, name: str, args, out) -> None:
        from torch.distributed import get_process_group_ranks
        from torch.distributed.distributed_c10d import _resolve_process_group

        group_name = [a for a in args if isinstance(a, str)][-1]      # the last: reduce ops are str too
        group = _resolve_process_group(group_name)
        if group.size() == 1:
            return
        kind = _FUNCOL[name]
        nbytes = sum(_nbytes(t) for t in _tensors(out))
        self._cb[kind] += nbytes
        self._cc[kind] += 1
        axis = self._group_axes.get(tuple(get_process_group_ranks(group)), "?")
        self._by_axis[axis][kind] += nbytes
        self._el_by_axis[axis][kind] += sum(t.numel() for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor or (isinstance(t, type) and issubclass(t, DTensor)) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._active_fake_mode() is not self._fake_on_entry:
            return out                                     # DTensor's shape propagation
        if not isinstance(func, torch._ops.OpOverload):
            return out
        name = func._overloadpacket.__name__
        if func.namespace in _FUNCOL_NAMESPACES:
            if name in _FUNCOL:
                self._collective(name, args, out)
            return out
        if func.namespace == "prim" or func.is_view or name in _NO_TRAFFIC:
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.out.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _tensors(out)
        self.out.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    def result(self) -> StepAnalysis:
        self.out.collective_bytes = dict(self._cb)
        self.out.collective_counts = dict(self._cc)
        self.out.collective_bytes_by_axis = {a: dict(v) for a, v in self._by_axis.items()}
        self.out.collective_elements_by_axis = {a: dict(v) for a, v in self._el_by_axis.items()}
        return self.out


def analyze(step_fn: Callable, *args, mesh=None) -> Tuple[Any, StepAnalysis]:
    """Run ``step_fn(*args)`` once under the recorder; ``(its result, the
    record)``.  ``mesh`` names the axes the collectives ran over."""
    rec = _Recorder(_group_axes(mesh), args)
    with rec:
        result = step_fn(*args)
    return result, rec.result()


def _local_tensors(tree: Any) -> list:
    from torch.distributed.tensor import DTensor

    return [t.to_local() if isinstance(t, DTensor) else t for t in _tensors(tree)]


def local_bytes(tree: Any) -> int:
    """Bytes this rank holds of a tree of (D)Tensors: the local shards."""
    return sum(_nbytes(t) for t in _local_tensors(tree))
