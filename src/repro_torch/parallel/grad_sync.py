"""Bucketed, hierarchical, optionally-compressed gradient synchronisation:
the paper's communication phase as a first-class runtime feature.

The paper shows that Horovod's transport leaves a 100 Gbps NIC at <32 Gbps
and that a *well-scheduled* communication phase (fusion buffers + full link
utilization) reaches a ~100 % scaling factor.  The levers at this layer:

- **fusion buckets** (paper: 64 MB / 5 ms): gradients are flattened and
  packed into <= ``fusion_buffer_mb`` slabs so each collective moves a large
  contiguous buffer instead of per-tensor messages;
- **hierarchical all-reduce**: reduce-scatter inside the node over the fast
  links, all-reduce across nodes on the 1/N-sized shard, all-gather inside
  the node;
- **gradient compression** (paper section 3.2): fp16 / int8 / ternary /
  topk via the hand-written kernels in ``repro_torch.kernels``, applied per
  bucket.  Compressed buckets are exchanged with all-gather + a local fused
  reduction (Horovod compression semantics: sums are computed on
  dequantized values, so compression error does not accumulate across
  hops).

Collectives go through the small interface of
``repro_torch.parallel.collectives``: the in-process world, or one rank of
a ``torch.distributed`` group a process (NCCL on ``--device cuda``, gloo
on ``--device cpu``), which is how K > 1 runs::

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m repro_torch.launch.train --comm-mode explicit --compression int8 ...

Buckets are issued strictly in ``plan.comm_plan(comm).bucket_order()``, one
at a time on the current stream: one collective in flight, in the order the
simulator prices.
Unlike the JAX package, which packs all buckets before the first
collective, a bucket is packed right before it is synced and unpacked right
after, so only one f32 bucket and its encoded copies are alive at a time;
the arithmetic per bucket is the same.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CommConfig
from repro_torch.core.schedule import lower_buckets
from repro_torch.kernels import ops as kops
from repro_torch.parallel.collectives import PerRank, World
from repro_torch.utils import trace
from repro_torch.utils.tree import tree_leaves, tree_unflatten


# ---------------------------------------------------------------------------
# bucketing: tree <-> fixed-size flat slabs
# ---------------------------------------------------------------------------

def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


class BucketPlan:
    """Static packing plan: leaf -> (bucket id, offset) assignments.

    Built once per parameter-tree structure.  Leaves are packed in tree
    order (dict keys sorted, as ``jax.tree_util`` flattens), mirroring the
    paper's fusion buffer fill order.
    """

    def __init__(self, shapes: Sequence[Tuple[int, ...]], dtypes, limit_bytes: int):
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.dtypes = list(dtypes)
        self.assignments: List[Tuple[int, int]] = []      # (bucket, offset)
        self.bucket_sizes: List[int] = []
        self.bucket_tensors: List[int] = []               # leaves per bucket
        cur, cur_bytes, cur_tensors = 0, 0, 0
        offset = 0
        for size, dtype in zip(self.sizes, self.dtypes):
            nbytes = size * _itemsize(dtype)
            if cur_bytes > 0 and cur_bytes + nbytes > limit_bytes:
                self.bucket_sizes.append(offset)
                self.bucket_tensors.append(cur_tensors)
                cur += 1
                cur_bytes, offset, cur_tensors = 0, 0, 0
            self.assignments.append((cur, offset))
            offset += size
            cur_bytes += nbytes
            cur_tensors += 1
        if offset:
            self.bucket_sizes.append(offset)
            self.bucket_tensors.append(cur_tensors)

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    def leaves_of(self, bucket: int) -> List[int]:
        """Indices (in tree order) of the leaves packed into ``bucket``."""
        return [i for i, (b, _) in enumerate(self.assignments) if b == bucket]

    def comm_plan(self, comm: CommConfig):
        """Lower this packing into the comm-schedule IR.

        Buckets are packed (and flushed) in tree order, so the plan's
        ``bucket_order()`` is exactly what the simulator predicts for the
        same scheduler.  Packed buckets are f32, hence 4 bytes per element.
        """
        return lower_buckets(
            [(0.0, float(n_elems * 4), n_tensors)
             for n_elems, n_tensors in zip(self.bucket_sizes, self.bucket_tensors)],
            scheduler=comm.scheduler, n_chunks=comm.sched_chunks)


def make_plan(tree: Any, limit_mb: float) -> Tuple[BucketPlan, Any]:
    """(plan, treedef); the treedef is the tree itself, the template that
    ``tree_unflatten`` rebuilds from."""
    leaves = tree_leaves(tree)
    plan = BucketPlan([l.shape for l in leaves], [l.dtype for l in leaves],
                      int(limit_mb * 1024 * 1024))
    return plan, tree


def pack_bucket(plan: BucketPlan, leaves: Sequence[torch.Tensor], bucket: int) -> torch.Tensor:
    flat = torch.cat([leaves[i].float().reshape(-1) for i in plan.leaves_of(bucket)])
    trace.count("sync.bytes_packed", 4 * flat.numel())
    return flat


def pack(plan: BucketPlan, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Leaves -> list of flat f32 buckets."""
    return [pack_bucket(plan, leaves, b) for b in range(plan.n_buckets)]


def unpack_bucket(plan: BucketPlan, flat: torch.Tensor, bucket: int) -> Dict[int, torch.Tensor]:
    out = {}
    for i in plan.leaves_of(bucket):
        off = plan.assignments[i][1]
        out[i] = flat[off:off + plan.sizes[i]].reshape(plan.shapes[i]).to(plan.dtypes[i])
    return out


def unpack(plan: BucketPlan, buckets: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    by_leaf: Dict[int, torch.Tensor] = {}
    for b, flat in enumerate(buckets):
        by_leaf.update(unpack_bucket(plan, flat, b))
    return [by_leaf[i] for i in range(len(plan.assignments))]


# ---------------------------------------------------------------------------
# per-bucket collectives; xs holds one tensor per rank of the world.  Each
# phase of a bucket is a span (``utils/trace``) with the bucket's id and the
# bytes the phase reads (pack: the float32 bytes it writes), the ranks of
# this process together.
# ---------------------------------------------------------------------------

def _nbytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _all_gather(world: World, xs: PerRank, *group) -> PerRank:
    trace.count("sync.bytes_gathered", _nbytes(xs))
    return world.all_gather(xs, *group)


def _allreduce_mean(xs: PerRank, world: World, bucket: int = 0) -> PerRank:
    with trace.span("sync.gather", bucket=bucket, bytes=_nbytes(xs)):
        sums = world.all_reduce_sum(xs, "world")
    with trace.span("sync.add", bucket=bucket, bytes=_nbytes(sums)):
        return [t / world.size for t in sums]


def _hierarchical_mean(xs: PerRank, world: World, bucket: int = 0) -> PerRank:
    """In-node reduce-scatter -> cross-node all-reduce -> in-node all-gather."""
    nd = world.node_size
    n = xs[0].shape[0]
    pad = (-n) % nd
    with trace.span("sync.gather", bucket=bucket, bytes=_nbytes(xs)):
        if pad:
            xs = [torch.cat([x, x.new_zeros(pad)]) for x in xs]
        shards = world.reduce_scatter_sum([x.reshape(nd, -1) for x in xs], "node")
        if world.n_nodes > 1:
            shards = world.all_reduce_sum(shards, "cross")
        full = [g.reshape(-1) for g in _all_gather(world, shards, "node")]
    with trace.span("sync.add", bucket=bucket, bytes=_nbytes(full)):
        return [(f[:n] if pad else f) / world.size for f in full]


def _compressed_mean(xs: PerRank, comm: CommConfig, world: World,
                     use_kernels: bool = True, bucket: int = 0) -> PerRank:
    """Horovod-compression semantics: all-gather compressed payloads, then
    dequantize and reduce locally with one fused K-way add."""
    n_total = world.size
    if comm.compression in ("int8", "ternary"):
        enc, dec = ((kops.quantize_int8, kops.dequantize_int8) if comm.compression == "int8"
                    else (kops.ternarize, kops.deternarize))
        with trace.span("sync.encode", bucket=bucket, bytes=_nbytes(xs)):
            encoded = [enc(x, use_kernel=use_kernels) for x in xs]
        n = encoded[0][2]
        codes, scales = [e[0] for e in encoded], [e[1] for e in encoded]
        with trace.span("sync.gather", bucket=bucket, bytes=_nbytes(codes) + _nbytes(scales)):
            qg = _all_gather(world, codes)
            sg = _all_gather(world, scales)
        out = []
        for q_all, s_all in zip(qg, sg):
            # the reference multiplies inline and XLA fuses it into one pass;
            # the decode kernel is that pass, with the same values bit for bit
            with trace.span("sync.decode", bucket=bucket, bytes=_nbytes((q_all, s_all))):
                deq = dec(q_all.reshape(-1, kops.BLOCK), s_all.reshape(-1, 1), q_all.numel(),
                          use_kernel=use_kernels)
            with trace.span("sync.add", bucket=bucket, bytes=_nbytes((deq,))):
                total = kops.fused_add(deq.reshape(n_total, -1), use_kernel=use_kernels)
                out.append(total[:n] / n_total)
        return out
    if comm.compression == "fp16":
        with trace.span("sync.encode", bucket=bucket, bytes=_nbytes(xs)):
            payload = [x.to(torch.bfloat16) for x in xs]
    elif comm.compression == "topk":
        # as the reference: the masked bucket travels dense (no sparse payload)
        with trace.span("sync.encode", bucket=bucket, bytes=_nbytes(xs)):
            payload = [kops.topk_sparsify(x, comm.topk_ratio, sample=1 << 14,
                                          use_kernel=use_kernels) for x in xs]
    else:
        raise ValueError(comm.compression)
    with trace.span("sync.gather", bucket=bucket, bytes=_nbytes(payload)):
        gathered = _all_gather(world, payload)
    with trace.span("sync.add", bucket=bucket, bytes=_nbytes(gathered)):
        return [kops.fused_add(g.reshape(n_total, -1), use_kernel=use_kernels) / n_total
                for g in gathered]


def _sync_bucket(xs: PerRank, comm: CommConfig, world: World,
                 use_kernels: bool = True, bucket: int = 0) -> PerRank:
    if comm.compression != "none":
        return _compressed_mean(xs, comm, world, use_kernels, bucket)
    if comm.hierarchical:
        return _hierarchical_mean(xs, world, bucket)
    return _allreduce_mean(xs, world, bucket)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

@torch.no_grad()
def sync_grads_per_rank(grads: Sequence[Any], world: World, comm: CommConfig,
                        use_kernels: bool = True) -> List[Any]:
    """``grads[r]`` is rank ``r``'s gradient tree; returns one synced tree
    per rank, each the mean over ranks.  See :func:`sync_grads`."""
    if len(grads) != world.local_ranks:
        raise ValueError(f"expected {world.local_ranks} gradient trees, got {len(grads)}")
    template = grads[0]
    with trace.span("step.sync"):
        plan, _ = make_plan(template, comm.fusion_buffer_mb)
        leaves = [tree_leaves(g) for g in grads]
        new_leaves: List[List[Any]] = [[None] * len(leaves[0]) for _ in grads]
        for b in plan.comm_plan(comm).bucket_order():
            f32_bytes = 4 * plan.bucket_sizes[b] * len(grads)
            with trace.span("sync.pack", bucket=b, bytes=f32_bytes):
                xs = [pack_bucket(plan, rank_leaves, b) for rank_leaves in leaves]
            synced = _sync_bucket(xs, comm, world, use_kernels, b)
            del xs
            with trace.span("sync.unpack", bucket=b, bytes=f32_bytes):
                for r, flat in enumerate(synced):
                    for i, leaf in unpack_bucket(plan, flat, b).items():
                        new_leaves[r][i] = leaf
    return [tree_unflatten(template, nl) for nl in new_leaves]


def sync_grads(grads: Any, world: World, comm: CommConfig,
               use_kernels: bool = True) -> Any:
    """Average ``grads`` over the world's ranks, for a process that holds
    one rank (``world.local_ranks == 1``: a ``DistributedWorld``, or the
    in-process world of one).

    Equivalent to a per-leaf mean over ranks, but bucketed (fusion
    buffers), hierarchical and optionally compressed: the paper's
    communication phase.  On one rank every collective degenerates (gather
    of one, sum of one), yet the encode -> gather -> dequantize -> fused
    add chain still runs, as it does in the JAX trainer on one device.
    ``use_kernels=False`` takes the plain versions of the codec kernels
    even on CUDA tensors (the reference path of a comparison run).
    """
    if world.local_ranks != 1:
        raise ValueError("sync_grads takes one rank's tree; use "
                         "sync_grads_per_rank for an in-process world of several ranks")
    return sync_grads_per_rank([grads], world, comm, use_kernels)[0]


@torch.no_grad()
def allreduce_mean_leaves(grads: Any, world: World) -> Any:
    """``--comm-mode auto`` at K > 1: each leaf summed over the world in its
    own dtype, then divided by K; the counterpart of the gradient psum that
    XLA inserts under SPMD.  For a process that holds one rank."""
    if world.local_ranks != 1:
        raise ValueError("allreduce_mean_leaves takes one rank's tree")
    with trace.span("step.sync"):
        return tree_unflatten(grads, [world.all_reduce_sum([g])[0] / world.size
                                      for g in tree_leaves(grads)])


def grad_sync_flops_and_bytes(total_bytes: int, n_workers: int,
                              comm: CommConfig) -> dict:
    """Analytic wire traffic of one sync."""
    ratio = {"none": 1.0, "fp16": 2.0, "int8": 4.0, "ternary": 4.0,
             "topk": 1.0 / max(comm.topk_ratio, 1e-9) / 2.0}[comm.compression]
    if comm.compression == "none":
        wire = 2.0 * total_bytes * (n_workers - 1) / n_workers
    else:  # all-gather of compressed payloads
        wire = total_bytes / ratio * (n_workers - 1)
    return {"wire_bytes_per_worker": wire, "compression_ratio": ratio}
