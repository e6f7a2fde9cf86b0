"""The port across processes, on the CPU: ``DistributedWorld`` on four gloo
ranks against ``InProcessWorld(4, 2)`` for every collective and axis,
``sync_grads`` over it against ``sync_grads_per_rank`` in every mode, and
the trainer under ``torchrun`` against the JAX trainer on the global batch.

Each multi-process run is one ``python -m torch.distributed.run --standalone
--nproc_per_node 4`` (it picks a free rendezvous port), in a session of its
own that is killed whole if it outlives its time limit.  The ranks' results
come back through ``tests/_torch_dist_worker.py``'s files."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dist_worker import K, NODE, SYNC_MODES, TRAIN_COMMON, TRAIN_RUNS, inputs
from _torch_port import np32, to_jax

from repro.configs import CommConfig as JComm, INPUT_SHAPES as JSHAPES, get_config as jget
from repro.configs.base import InputShape as JShape
from repro.data.pipeline import SyntheticLM as JData
from repro.launch import train as jtrain
from repro.models.registry import get_model as jmodel
from repro.optim.optimizers import get_optimizer as jopt
from repro.optim.schedule import get_schedule as jsched
from repro.parallel import sharding as jshd
from repro_torch.checkpoint import store
from repro_torch.configs import CommConfig, get_config as tget
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import get_model as tmodel
from repro_torch.optim.optimizers import get_optimizer as topt
from repro_torch.parallel import sharding as tshd
from repro_torch.parallel.collectives import DistributedWorld, InProcessWorld
from repro_torch.parallel.grad_sync import (allreduce_mean_leaves, sync_grads,
                                           sync_grads_per_rank)
from repro_torch.utils.tree import tree_leaves, tree_paths

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
TIME_LIMIT = 120          # seconds for one torchrun of four ranks (about 8 s on 8 idle cores)
AXES = ("world", "node", "cross")


def torchrun(args, time_limit: int = TIME_LIMIT) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO / "src")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(K), *map(str, args)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=time_limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)         # torchrun and every rank it started
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def run_worker(what: str, out_dir: Path) -> list:
    proc = torchrun([WORKER, what, out_dir])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(K)]


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    return run_worker("collectives", tmp_path_factory.mktemp("collectives"))


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    return run_worker("train", tmp_path_factory.mktemp("train"))


def _sums_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    # gloo adds in another order than the in-process loop: f32 rounding, and
    # an absolute floor of the same size for sums that cancel
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("op", ["all_gather", "all_reduce_sum", "reduce_scatter_sum"])
def test_distributed_world_matches_in_process(collective_runs, op, axis):
    world = InProcessWorld(K, NODE)
    per_rank = [inputs(r) for r in range(K)]
    xs = [p["rs"][axis] if op == "reduce_scatter_sum" else p["x"] for p in per_rank]
    want = getattr(world, op)(xs, axis)
    for r in range(K):
        got = collective_runs[r][f"{op}/{axis}"]
        assert got.shape == want[r].shape and got.dtype == want[r].dtype
        if op == "all_gather":
            assert torch.equal(got, want[r]), f"rank {r}"
        else:
            _sums_close(got, want[r], f"rank {r}")


@pytest.mark.parametrize("mode", list(SYNC_MODES))
def test_sync_grads_across_processes_matches_per_rank(collective_runs, mode):
    comm = CommConfig(mode="explicit", fusion_buffer_mb=0.004, **SYNC_MODES[mode])
    want = sync_grads_per_rank([inputs(r)["grads"] for r in range(K)], InProcessWorld(K, NODE),
                               comm)
    for r in range(K):
        got = collective_runs[r][f"sync/{mode}"]
        assert tree_paths(got) == tree_paths(want[r])
        for path, g, w in zip(tree_paths(got), tree_leaves(got), tree_leaves(want[r])):
            assert g.dtype == w.dtype, path
            if comm.compression != "none":
                # an exact gather, then the same fused add in rank order
                assert torch.equal(g, w), f"rank {r} {path}"
            elif g.dtype == torch.float32:
                _sums_close(g, w, f"rank {r} {path}")
            else:
                # the f32 mean, rounded to bf16: an f32 ulp of another sum
                # order can cross a bf16 rounding boundary, one bf16 ulp
                np.testing.assert_allclose(np32(g), np32(w), rtol=2.0 ** -8, atol=1e-6,
                                           err_msg=f"rank {r} {path}")


def test_auto_mode_is_the_per_leaf_mean(collective_runs):
    """``allreduce_mean_leaves``: each leaf summed in its own dtype, then
    divided by K, against the float64 mean; bf16 sums round at each of
    their K - 1 additions, by up to half a bf16 ulp of the running sum."""
    grads = [inputs(r)["grads"] for r in range(K)]
    for r in range(K):
        got = collective_runs[r]["auto"]
        for path, g, *ws in zip(tree_paths(got), tree_leaves(got), *map(tree_leaves, grads)):
            assert g.dtype == ws[0].dtype, path
            want = sum(w.double() for w in ws) / K
            scale = sum(w.double().abs() for w in ws) / K
            eps = 2.0 ** -8 if g.dtype == torch.bfloat16 else 2.0 ** -23
            assert bool(((g.double() - want).abs() <= K * eps * scale + 1e-30).all()), path
        if r:
            for a, b in zip(tree_leaves(got), tree_leaves(collective_runs[0]["auto"])):
                assert torch.equal(a, b), f"rank {r} differs from rank 0"


def test_one_rank_entry_points_refuse_a_world_of_several():
    world = InProcessWorld(K, NODE)
    grads = [inputs(r)["grads"] for r in range(K)]
    comm = CommConfig(mode="explicit", compression="int8")
    with pytest.raises(ValueError, match="one rank"):
        sync_grads(grads[0], world, comm)
    with pytest.raises(ValueError, match="one rank"):
        allreduce_mean_leaves(grads[0], world)
    with pytest.raises(ValueError, match="4 gradient trees"):
        sync_grads_per_rank(grads[:3], world, comm)
    with pytest.raises(ValueError, match="one tensor per local rank"):
        world.all_gather([grads[0]["w"]])
    with pytest.raises(RuntimeError, match="init_process_group"):
        DistributedWorld()
    with pytest.raises(ValueError, match="multiple of node_size"):
        InProcessWorld(4, 3)


def test_batch_rule_is_the_reference_spec():
    """``data_batch_spec`` of the port's one data axis against the JAX
    package's on a mesh of the same data size (only its axis names and
    device shape are read)."""
    class Mesh:
        axis_names = ("data", "model")

        def __init__(self, n):
            self.devices = np.empty((n, 1), dtype=object)

    for size in (1, 2, 4):
        for batch in (1, 2, 3, 4, 8):
            # PartitionSpec writes a one-axis entry ("data",) as "data"
            spec = tuple((a,) if isinstance(a, str) else a
                         for a in jshd.data_batch_spec(Mesh(size), batch))
            assert tshd.data_batch_spec(InProcessWorld(size), batch) == spec
    batch = {"tokens": np.arange(12).reshape(4, 3), "labels": np.arange(12).reshape(4, 3) + 1}
    one = tshd.shard_batch(batch, InProcessWorld(1))
    assert set(one) == set(batch) and all(np.array_equal(one[k], batch[k]) for k in batch)
    with pytest.raises(ValueError, match="one rank"):
        tshd.shard_batch(batch, InProcessWorld(4))


def _port_init_as_jax(cfg_t, cfg_j):
    """The parameters every rank of ``ttrain.main`` starts from (seed 0 on
    the CPU), as the JAX tree."""
    params_t = tmodel(cfg_t).init(torch.Generator(device="cpu").manual_seed(0))
    shapes = jax.eval_shape(jmodel(cfg_j).init, jax.random.key(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    assert tree_paths(params_t) == [".".join(str(k.key) for k in p) for p, _ in flat]
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(np32(t), dtype=s.dtype) for t, (_, s) in zip(tree_leaves(params_t), flat)])


def _jax_losses(mode: str, steps: int = 3, batch: int = 4) -> list:
    cj = jget("stablelm-3b").smoke()
    api, opt = jmodel(cj), jopt("adamw")
    params = _port_init_as_jax(tget("stablelm-3b").smoke(), cj)
    shape = JSHAPES["train_4k"].smoke()
    data = JData(cj, JShape(shape.name, shape.seq_len, batch, shape.kind), seed=0)
    comm = JComm(mode="auto") if mode == "auto" else JComm(mode="explicit", compression=mode)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step_fn = jax.jit(jtrain.make_train_step(api, opt, mesh, comm, jsched("cosine", 3e-4, 5, steps),
                                             clip_norm=1.0))
    state, losses = opt.init(params), []
    for step in range(steps):
        with mesh:
            params, state, met = step_fn(params, state,
                                         {k: to_jax(v) for k, v in data.batch(step).items()})
        losses.append(float(met["loss"]))
    return losses


@pytest.mark.parametrize("mode", ["auto", "none"])
def test_four_ranks_match_the_jax_trainer_on_the_global_batch(train_runs, mode):
    """Each of four ranks takes one row of a global batch of 4; the mean of
    their gradients is the global batch's, and the loss reported is the
    global batch's: rank 0's three losses against the JAX trainer's."""
    got = [run[mode] for run in train_runs]
    for r, run in enumerate(got):
        assert run["rows"] == [1, 1, 1], f"rank {r}"
        assert run["result"]["world"] == K and run["result"]["backend"] == "gloo"
        assert run["result"]["losses"] == got[0]["result"]["losses"], f"rank {r}"
    want = _jax_losses(mode)
    # the tolerance of test_three_train_steps_match_jax: Adam turns last-bit
    # gradient differences into relative parameter differences of about 1e-4
    np.testing.assert_allclose(got[0]["result"]["losses"], want, rtol=1e-3)
    np.testing.assert_allclose(got[0]["result"]["losses"][0], want[0], rtol=1e-5)


def test_int8_ranks_end_with_equal_parameters_and_only_rank0_prints(train_runs):
    runs = [run["int8"] for run in train_runs]
    for r, run in enumerate(runs):
        assert run["rows"] == [1, 1, 1]
        for a, b in zip(run["params"], runs[0]["params"]):
            assert torch.equal(a, b), f"rank {r}"
        assert ("[train] done" in run["printed"]) == (r == 0), f"rank {r} printed {run['printed']!r}"
    assert "world 4 (gloo), 1 of 4 rows a rank" in runs[0]["printed"]


def test_batch_smaller_than_the_world_is_replicated(train_runs):
    """A global batch of 2 on 4 ranks: every rank takes the whole batch, and
    the run equals one rank's."""
    one = ttrain.main(TRAIN_COMMON + TRAIN_RUNS["int8-b2"])
    for r, run in enumerate(train_runs):
        got = run["int8-b2"]
        assert got["rows"] == [2, 2, 2], f"rank {r}"
        # the same tolerances as against JAX: another thread count, another
        # rounding of the mean of 4 equal gradients, then Adam
        np.testing.assert_allclose(got["result"]["losses"], one["losses"], rtol=1e-3)
        np.testing.assert_allclose(got["result"]["losses"][0], one["losses"][0], rtol=1e-5)
    assert one["world"] == 1 and one["backend"] == "in-process"


def test_torchrun_entry_point_trains_and_rank0_writes_the_checkpoint(tmp_path):
    """As a user starts it: ``torchrun -m repro_torch.launch.train``."""
    ckpt = tmp_path / "ckpt"
    proc = torchrun(["-m", "repro_torch.launch.train", *TRAIN_COMMON, *TRAIN_RUNS["int8"],
                     "--ckpt-dir", ckpt, "--ckpt-every", "2"])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    assert proc.stdout.count("[train] done") == 1           # rank 0 only
    assert "world 4 (gloo)" in proc.stdout
    assert store.latest_step(ckpt) == 2 and not list(ckpt.glob("*.tmp"))
    cfg = tget("stablelm-3b").smoke()
    params = tmodel(cfg).init(torch.Generator().manual_seed(1))
    state = store.restore(ckpt, {"params": params, "opt": topt("adamw").init(params)})
    assert int(state["opt"].count) == 3                  # saved after step 2's update
