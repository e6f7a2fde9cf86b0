"""The specs' DTensor placements and step function on a real (2, 2)
DeviceMesh: four gloo processes on the CPU (``tests/_torch_mesh_worker.py``
under ``python -m torch.distributed.run``, as ``tests/test_torch_distributed.py``
starts its ranks).

- Placing a smoke stablelm tree by ``param_placements`` and reading it back
  with ``full_tensor()`` gives it bit for bit, and each rank holds the
  shard its spec says.
- One ``make_step_fn(api, "train", opt)`` step on the mesh gives the
  single-process step's loss within 1e-5 in float32: the program the dry
  run traces is one that really runs; so does the step on the flash
  kernel's route (``local_map`` over the shards, here the kernel's plain
  version, as on any CPU tensor) on a (4, 1) mesh of the same ranks.  Its parameters agree within a third
  of the step: AdamW's first step moves each element by about lr = 3e-4
  times m / sqrt(v), and for a gradient element near eps = 1e-8 that ratio
  depends on the last bits of the summed gradient, which the mesh sums in
  another order.
- The same step of one smoke model of each other family the dry run's
  fixed lowering touches (MoE, MLA, RWKV-6, Jamba, Whisper) on the (2, 2)
  mesh, and the kernel's route with the heads split over `model`: the
  single-process loss within 1e-5, the parameters as above.
- A dense and an MoE decoder under ``seq_parallel="data"``, and the
  attention on a (1, 4) mesh whose `model` axis the kv heads do not
  divide: the loss and every gradient leaf of one process.
- A decode step of batch 1, the cache's slots split over the mesh: the
  dense decoder's (GQA, slots over `data`) and the MLA decoder's (latent
  cache, slots over `data` and `model`: each rank's partial softmax merged
  across both, flash-decoding) give one process's logits and cache.
- A decode step of each lowering a decode takes on a mesh
  (``DECODE_CASES``): a batch of one, whole over `data` (the products
  split over `data` on the weights' own shards), under ``fsdp_tp`` and
  ``dp_tp``, in each family; a row and a token a `data` rank, fewer
  tokens than `model` ranks (RWKV's column-split products; the fsdp
  decoders' gathered rows and vocab-parallel lookup; Whisper's
  cross-attention on (row, head) pairs): one process's logits and cache."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_mesh_worker import (DECODE_AT, DECODE_CASES, FAMILY_ARCHS, FAMILY_S, HEAD_SPLITS,
                                MLA_ARCH, SEQ_PARALLEL_ARCHS, decode_case_inputs, decode_inputs,
                                inputs)

from repro_torch.launch import specs
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_paths, value_and_grad

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
K = 4
TIME_LIMIT = 300          # seconds for the torchrun of four ranks (about 30 s on 8 idle cores)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The single-process reference steps are small: one thread keeps them
    from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("mesh")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO / "src")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(K), str(WORKER), str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIME_LIMIT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)         # torchrun and every rank it started
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-3000:] + err[-5000:]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(K)]


def test_full_tensor_gives_the_tree_back_bit_for_bit(ranks):
    _, params, _ = inputs()
    for r in ranks:
        for got, want in zip(r["back"], tree_leaves(params)):
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_each_rank_holds_the_shard_its_spec_names(ranks):
    api, params, _ = inputs()
    sp = shd.param_specs(params, api.cfg)
    sizes = {"data": 2, "model": 2}
    for r in ranks:
        for path, leaf, shape in zip(tree_paths(params), tree_leaves(params), r["local_shapes"]):
            want = list(leaf.shape)
            for dim, entry in enumerate(sp[path]):
                if entry is not None:
                    want[dim] //= sizes[entry]
            assert list(shape) == want, path
    assert ranks[0]["placements"] == ranks[3]["placements"]


def test_one_train_step_on_the_mesh_is_the_single_process_step(ranks):
    api, params, batch = inputs()
    opt = get_optimizer("adamw")
    new_p, _, metrics = specs.make_step_fn(api, "train", opt)(params, opt.init(params), batch)
    want = float(metrics["loss"])
    for r in ranks:
        assert abs(float(r["loss"]) - want) <= 1e-5 * abs(want)
        assert abs(float(r["kernel_route_loss"]) - want) <= 1e-5 * abs(want)
        for got, ref in zip(r["new_params"], tree_leaves(new_p)):
            torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_each_family_trains_on_the_mesh_as_in_one_process(ranks, arch):
    """The dry run's fixed lowering, run for real on the (2, 2) mesh: the
    residual stream held to rows (``sharding.constrain_rows``), the
    attention, WKV, Mamba scan and MoE experts on each rank's shards
    (``sharding.on_shards``; experts split over `model`, a pending sum
    after), the vocab-parallel loss (``layers._ShardedXent``).  One step's
    loss equals the single-process step's within 1e-5, its parameters as
    the dense decoder's do."""
    api, params, batch = inputs(arch, FAMILY_S)
    opt = get_optimizer("adamw")
    new_p, _, metrics = specs.make_step_fn(api, "train", opt)(params, opt.init(params), batch)
    want = float(metrics["loss"])
    for r in ranks:
        got = r["families"][arch]
        assert abs(float(got["loss"]) - want) <= 1e-5 * abs(want)
        for a, b in zip(got["new_params"], tree_leaves(new_p)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", SEQ_PARALLEL_ARCHS)
def test_sequence_parallelism_gives_the_single_process_gradients(ranks, arch):
    """``seq_parallel="data"`` on the (2, 2) mesh: the residual stream held
    with S split over `model` around and inside each block
    (``sharding.constrain_seq``), each block's normalised input gathered for
    its products and their outputs reduce-scattered back.  The loss equals
    the single process's within 1e-5 and every gradient leaf within 1e-5 of
    its largest entry (float32, another summation order), for a dense and
    an MoE decoder."""
    api, params, batch = inputs(arch, FAMILY_S)
    (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
    for r in ranks:
        got = r["seq_parallel"][arch]
        assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        for path, a, b in zip(tree_paths(grads), got["grads"], tree_leaves(grads)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()) + 1e-12,
                                       msg=path)


@pytest.mark.parametrize("split", list(HEAD_SPLITS))
def test_attention_on_a_model_axis_its_kv_heads_do_not_divide(ranks, split):
    """A (1, 4) mesh of the same ranks, whose `model` axis the smoke's 2 kv
    heads do not divide (``attention._on_shards``): the (row, kv head)
    pairs split over it, a kv head with its 2 query heads or its one, in
    the dense decoder and in Whisper's encoder, cross- and self-attention.
    The loss and every gradient leaf equal one process's, as under sequence
    parallelism."""
    arch, shape = HEAD_SPLITS[split]
    api, params, batch = inputs(arch, FAMILY_S, **shape)
    (loss, _), grads = value_and_grad(api.loss_fn, params, batch)
    for r in ranks:
        got = r["head_splits"][split]
        assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        for path, a, b in zip(tree_paths(grads), got["grads"], tree_leaves(grads)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()) + 1e-12,
                                       msg=path)


def test_the_kernel_route_splits_heads_over_model(ranks):
    """The flash kernel's route (its plain version on CPU shards) under
    autograd with the heads split over a `model` axis of two ranks."""
    api, params, batch = inputs()
    opt = get_optimizer("adamw")
    want = float(specs.make_step_fn(api, "train", opt)(params, opt.init(params), batch)[2]["loss"])
    for r in ranks:
        assert abs(float(r["kernel_route_2x2"]) - want) <= 1e-5 * abs(want)


def test_a_decode_step_writes_its_slot_on_the_rank_that_holds_it(ranks):
    """Batch 1 on a (2, 2) mesh: the cache's slots split over `data`, so the
    new key and value are written into one rank's shard.  The step's logits
    equal a single-process decode's within 1e-5 (the sharded products sum
    in another order), the written slot too, and every other slot of the
    cache is untouched, bit for bit."""
    api, params, token, cache = decode_inputs()
    before = [t.clone() for t in tree_leaves(cache)]
    logits, new_cache = specs.make_step_fn(api, "decode")(params, {"tokens": token}, cache,
                                                          DECODE_AT)
    others = [i for i in range(before[0].shape[2]) if i != DECODE_AT]
    for r in ranks:
        assert r["decode"]["specs"]["blocks.k"][2] == "data"        # the slots' dim
        torch.testing.assert_close(r["decode"]["logits"], logits, rtol=1e-5, atol=1e-5)
        for got, want, old in zip(r["decode"]["cache"], tree_leaves(new_cache), before):
            assert torch.equal(got[:, :, others], old[:, :, others])
            torch.testing.assert_close(got[:, :, DECODE_AT], want[:, :, DECODE_AT],
                                       rtol=1e-5, atol=1e-5)
            assert not torch.equal(got[:, :, DECODE_AT], old[:, :, DECODE_AT])


def test_an_mla_decode_step_merges_the_slots_split_over_both_axes(ranks):
    """The MLA decoder (deepseek-v2 smoke) at batch 1 on the (2, 2) mesh:
    no kv heads to split, so the latent cache's slots split over `data` and
    `model`, four to a rank, and each rank's running max, denominator and
    context over its slots are all-reduced over both axes
    (``attention._latent_on_shards``).  The logits equal a single-process
    decode's within 1e-5, and so does the written slot; every other slot is
    untouched, bit for bit."""
    api, params, token, cache = decode_inputs(MLA_ARCH)
    before = [t.clone() for t in tree_leaves(cache)]
    logits, new_cache = specs.make_step_fn(api, "decode")(params, {"tokens": token}, cache,
                                                          DECODE_AT)
    others = [i for i in range(before[0].shape[2]) if i != DECODE_AT]
    for r in ranks:
        got_specs = r["decode_mla"]["specs"]
        assert got_specs["blocks.c_kv"][2] == ("data", "model")     # the slots' dim
        torch.testing.assert_close(r["decode_mla"]["logits"], logits, rtol=1e-5, atol=1e-5)
        for got, want, old in zip(r["decode_mla"]["cache"], tree_leaves(new_cache), before):
            assert torch.equal(got[:, :, others], old[:, :, others])
            torch.testing.assert_close(got[:, :, DECODE_AT], want[:, :, DECODE_AT],
                                       rtol=1e-5, atol=1e-5)
            assert not torch.equal(got[:, :, DECODE_AT], old[:, :, DECODE_AT])


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_each_decode_lowering_gives_the_single_process_step(ranks, case):
    """One decode step of ``DECODE_CASES[case]`` on the (2, 2) mesh: the
    logits and every leaf of the returned cache equal a single-process
    decode's within 1e-5 (the split products sum in another order)."""
    api, params, token, cache = decode_case_inputs(*DECODE_CASES[case])
    logits, new_cache = specs.make_step_fn(api, "decode")(params, {"tokens": token}, cache,
                                                          DECODE_AT)
    for r in ranks:
        got = r["decode_cases"][case]
        torch.testing.assert_close(got["logits"], logits, rtol=1e-5, atol=1e-5)
        for path, a, b in zip(tree_paths(new_cache), got["cache"], tree_leaves(new_cache)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=path)
