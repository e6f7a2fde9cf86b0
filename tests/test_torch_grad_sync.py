"""``repro_torch.parallel.grad_sync`` against ``repro.parallel.grad_sync``:
the bucket plan (also at the full-width stablelm-3b tree, built without
memory on both sides), pack/unpack, one-rank sync against the JAX sync on a
(1, 1) mesh, and the mean semantics over an in-process world of 8 ranks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import np32, to_jax, to_torch

from repro.configs import get_config as jget
from repro.configs.base import CommConfig as JComm
from repro.kernels import ops as jops
from repro.models.registry import get_model as jmodel
from repro.parallel import grad_sync as jgs
from repro_torch.configs import CommConfig, get_config as tget
from repro_torch.models.registry import get_model as tmodel
from repro_torch.parallel import grad_sync as tgs
from repro_torch.parallel.collectives import InProcessWorld
from repro_torch.utils.tree import tree_leaves, tree_paths

SCHEDULERS = ["fifo", "priority", "chunked"]


def _same_plan(pj, pt):
    assert pt.bucket_sizes == pj.bucket_sizes
    assert pt.assignments == pj.assignments
    assert pt.bucket_tensors == pj.bucket_tensors
    assert pt.n_buckets == pj.n_buckets
    for sched in SCHEDULERS:
        for chunks in (1, 4):
            oj = pj.comm_plan(JComm(scheduler=sched, sched_chunks=chunks)).bucket_order()
            ot = pt.comm_plan(CommConfig(scheduler=sched, sched_chunks=chunks)).bucket_order()
            assert ot == oj


@pytest.mark.parametrize("limit_kb", [1, 16, 64, 65536])
def test_bucket_plan_matches_on_mixed_shapes(limit_kb):
    rng = np.random.default_rng(limit_kb)
    shapes = [tuple(int(d) for d in rng.integers(1, 40, rng.integers(0, 4))) for _ in range(30)]
    kinds = [("float32", jnp.float32, torch.float32), ("bfloat16", jnp.bfloat16, torch.bfloat16)]
    picks = [kinds[int(i)] for i in rng.integers(0, 2, len(shapes))]
    pj = jgs.BucketPlan(shapes, [k[1] for k in picks], limit_kb * 1024)
    pt = tgs.BucketPlan(shapes, [k[2] for k in picks], limit_kb * 1024)
    _same_plan(pj, pt)


@pytest.mark.parametrize("fusion_mb", [64.0, 8.0, 512.0])
def test_full_width_stablelm_plan_is_identical(fusion_mb):
    """The real 2.8 B-parameter tree, shapes only: ``jax.eval_shape`` on one
    side, the ``meta`` device on the other."""
    shapes_j = jax.eval_shape(jmodel(jget("stablelm-3b")).init, jax.random.key(0))
    tree_t = tmodel(tget("stablelm-3b")).init(None, device="meta")
    assert tuple(tree_t["blocks"]["attn"]["wq"].shape) == (32, 2560, 2560)
    assert tuple(tree_t["blocks"]["mlp"]["wi"].shape) == (32, 2560, 6912)
    jpaths = [".".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(shapes_j)[0]]
    assert tree_paths(tree_t) == jpaths
    pj, _ = jgs.make_plan(shapes_j, fusion_mb)
    pt, _ = tgs.make_plan(tree_t, fusion_mb)
    assert pt.shapes == [tuple(s) for s in pj.shapes]
    _same_plan(pj, pt)
    assert sum(pt.bucket_sizes) == sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(shapes_j))


@pytest.mark.parametrize("seed,limit_kb", [(0, 1), (1, 4), (2, 64)])
def test_pack_unpack_roundtrip(seed, limit_kb):
    rng = np.random.default_rng(seed)
    tree = {"a": to_torch(rng.standard_normal((7, 9)).astype(np.float32)),
            "b": {"x": to_torch(rng.standard_normal(501).astype(np.float32), torch.bfloat16),
                  "y": to_torch(rng.standard_normal(()).astype(np.float32))},
            "c": to_torch(rng.standard_normal((3, 4, 5)).astype(np.float32))}
    plan, _ = tgs.make_plan(tree, limit_kb / 1024.0)
    leaves = tree_leaves(tree)
    buckets = tgs.pack(plan, leaves)
    assert [int(b.numel()) for b in buckets] == plan.bucket_sizes
    assert all(b.dtype == torch.float32 for b in buckets)
    out = tgs.unpack(plan, buckets)
    for a, b in zip(out, leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np32(a), np32(b))


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((20, 15)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32),
            "blocks": {"k": rng.standard_normal((3, 40, 11)).astype(np.float32)}}


@pytest.mark.parametrize("compression,hier,tol", [
    ("none", False, 1e-7), ("none", True, 1e-7),
    ("fp16", False, 1e-6),      # the same bf16 rounding, then an exact f32 sum of one row
    ("int8", False, 1e-6),      # the same arithmetic: equal codes and scales
    ("ternary", False, 1e-6),
    ("topk", False, 1e-7),      # the same threshold and mask, then a sum of one row
])
@pytest.mark.parametrize("fusion_kb", [1, 65536])
def test_one_rank_sync_equals_jax_sync(compression, hier, tol, fusion_kb):
    g = _grad_tree(3)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    gj = jax.tree_util.tree_map(to_jax, g)
    gj["b"] = gj["b"].astype(jnp.bfloat16)              # f32 and bf16 leaves mixed
    out_j = jgs.sync_grads(gj, mesh, JComm(compression=compression, hierarchical=hier,
                                           fusion_buffer_mb=fusion_kb / 1024.0))
    gt = {"w": to_torch(g["w"]), "b": to_torch(g["b"], torch.bfloat16),
          "blocks": {"k": to_torch(g["blocks"]["k"])}}
    out_t = tgs.sync_grads(gt, InProcessWorld(1), CommConfig(
        compression=compression, hierarchical=hier, fusion_buffer_mb=fusion_kb / 1024.0))
    for path, a, b in zip(tree_paths(out_t), tree_leaves(out_t), jax.tree_util.tree_leaves(out_j)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        np.testing.assert_allclose(np32(a), np32(b), atol=tol, rtol=0, err_msg=path)


@pytest.mark.parametrize("compression,hier,tol", [
    # the tolerances of tests/test_grad_sync.py::test_multidevice_mean_semantics
    ("none", False, 1e-6), ("none", True, 1e-6), ("fp16", False, 2e-2),
    ("int8", False, 2e-2), ("ternary", False, 1.5),
])
def test_eight_rank_mean_semantics(compression, hier, tol):
    K = 8
    world = InProcessWorld(K, node_size=4 if hier else None)      # 2 nodes x 4
    rng = np.random.default_rng(0)
    per_rank = [{"w": rng.standard_normal((16, 8)).astype(np.float32),
                 "b": rng.standard_normal((40,)).astype(np.float32)} for _ in range(K)]
    expect = {k: np.mean([g[k] for g in per_rank], axis=0) for k in ("w", "b")}
    grads = [{k: to_torch(v) for k, v in g.items()} for g in per_rank]
    out = tgs.sync_grads_per_rank(grads, world, CommConfig(compression=compression,
                                                           hierarchical=hier))
    assert len(out) == K
    for r in range(K):
        for k in ("w", "b"):
            assert np.abs(np32(out[r][k]) - expect[k]).max() <= tol, (r, k)


def test_hierarchical_pads_odd_buckets_and_world_checks():
    world = InProcessWorld(6, node_size=3)
    xs = [torch.full((10,), float(r)) for r in range(6)]          # 10 % 3 != 0
    out = tgs._hierarchical_mean(xs, world)
    for o in out:
        assert tuple(o.shape) == (10,)
        np.testing.assert_allclose(np32(o), 2.5, rtol=1e-6)
    assert world.groups("node") == [[0, 1, 2], [3, 4, 5]]
    assert world.groups("cross") == [[0, 3], [1, 4], [2, 5]]
    with pytest.raises(ValueError):
        InProcessWorld(6, node_size=4)
    with pytest.raises(ValueError):
        world.all_gather(xs[:2])
    with pytest.raises(ValueError):
        tgs.sync_grads({"a": xs[0]}, world, CommConfig())


def test_collectives_of_the_in_process_world():
    world = InProcessWorld(4, node_size=2)
    xs = [torch.arange(4, dtype=torch.float32) + 10 * r for r in range(4)]
    gathered = world.all_gather(xs)
    assert all(tuple(g.shape) == (4, 4) for g in gathered)
    np.testing.assert_array_equal(np32(gathered[3][2]), np32(xs[2]))
    summed = world.all_reduce_sum(xs, "node")
    np.testing.assert_array_equal(np32(summed[0]), np32(xs[0] + xs[1]))
    np.testing.assert_array_equal(np32(summed[3]), np32(xs[2] + xs[3]))
    shards = world.reduce_scatter_sum([x.reshape(2, 2) for x in xs], "node")
    np.testing.assert_array_equal(np32(shards[1]), np32((xs[0] + xs[1])[2:]))
    np.testing.assert_array_equal(np32(xs[0]), np.arange(4, dtype=np.float32))   # inputs untouched


def test_buckets_are_issued_in_plan_order(monkeypatch):
    g = {k: torch.ones(300) for k in "abcd"}
    comm = CommConfig(scheduler="priority", fusion_buffer_mb=1 / 1024.0)
    plan, _ = tgs.make_plan(g, comm.fusion_buffer_mb)
    assert plan.n_buckets == 4
    seen = []
    orig = tgs.pack_bucket
    monkeypatch.setattr(tgs, "pack_bucket", lambda p, l, b: seen.append(b) or orig(p, l, b))
    tgs.sync_grads(g, InProcessWorld(1), comm)
    assert tuple(seen) == plan.comm_plan(comm).bucket_order() == (3, 2, 1, 0)


def test_topk_waits_for_a_later_slice():
    """topk runs the reference's branch: each rank masks its bucket to the
    ~1 % largest |x| (threshold from a strided sample of 1 << 14), the dense
    masked buckets are gathered and summed.
    K = 4 against the float64 mean of the masked inputs, the masks computed
    by the JAX package."""
    K = 4
    rng = np.random.default_rng(11)
    per_rank = [{"w": rng.standard_normal((300, 70)).astype(np.float32),
                 "b": rng.standard_normal((999,)).astype(np.float32)} for _ in range(K)]
    comm = CommConfig(compression="topk", topk_ratio=0.01)
    grads = [{k: to_torch(v) for k, v in g.items()} for g in per_rank]
    plan, _ = tgs.make_plan(grads[0], comm.fusion_buffer_mb)
    assert plan.n_buckets == 1
    masked = []
    for g in per_rank:                                  # the bucket: leaves in tree order, f32
        bucket = np.concatenate([g["b"].reshape(-1), g["w"].reshape(-1)])
        masked.append(np.asarray(jops.topk_sparsify(to_jax(bucket), 0.01, sample=1 << 14)))
    expect = np.mean(np.stack(masked).astype(np.float64), axis=0)
    out = tgs.sync_grads_per_rank(grads, InProcessWorld(K), comm)
    for r in range(K):
        got = np.concatenate([np32(out[r]["b"]).reshape(-1), np32(out[r]["w"]).reshape(-1)])
        np.testing.assert_allclose(got, expect, rtol=0, atol=1e-6)    # f32 sums of 4 rows
    kept = sum(int((m != 0).sum()) for m in masked)
    assert 0.005 * K * expect.size <= kept <= 0.02 * K * expect.size


@pytest.mark.parametrize("compression", ["none", "fp16", "int8", "ternary", "topk"])
@pytest.mark.parametrize("workers", [1, 8, 64])
def test_flops_and_bytes_identical(compression, workers):
    a = jgs.grad_sync_flops_and_bytes(10 ** 9, workers, JComm(compression=compression))
    b = tgs.grad_sync_flops_and_bytes(10 ** 9, workers, CommConfig(compression=compression))
    assert a == b
