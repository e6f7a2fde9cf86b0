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
  another order."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_mesh_worker import DECODE_AT, decode_inputs, inputs

from repro_torch.launch import specs
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.parallel import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_paths

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
K = 4
TIME_LIMIT = 120          # seconds for the torchrun of four ranks (about 15 s on 8 idle cores)


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
