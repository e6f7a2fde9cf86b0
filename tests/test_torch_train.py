"""The slice as a whole: training steps of ``make_train_step`` on the smoke
config against the JAX package's, ``dryrun``'s bucket order, and the
launcher's refusal to run on the CPU unasked."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy, np32, to_jax

from repro.configs import CommConfig as JComm, INPUT_SHAPES as JSHAPES, get_config as jget
from repro.data.pipeline import SyntheticLM as JData
from repro.launch import train as jtrain
from repro.models.registry import get_model as jmodel
from repro.optim.optimizers import get_optimizer as jopt
from repro.optim.schedule import get_schedule as jsched
from repro_torch.configs import CommConfig, INPUT_SHAPES, get_config as tget
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, device_put_batch
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_model as tmodel
from repro_torch.optim.optimizers import get_optimizer as topt
from repro_torch.optim.schedule import get_schedule as tsched
from repro_torch.parallel.collectives import InProcessWorld
from repro_torch.utils.tree import tree_leaves, tree_paths


def test_synthetic_batches_identical():
    cj, ct = jget("stablelm-3b").smoke(), tget("stablelm-3b").smoke()
    dj = JData(cj, JSHAPES["train_4k"].smoke(), seed=3)
    dt = SyntheticLM(ct, INPUT_SHAPES["train_4k"].smoke(), seed=3)
    for step in (0, 1, 17):
        bj, bt = dj.batch(step), dt.batch(step)
        assert set(bj) == set(bt) == {"tokens", "labels"}
        for k in bj:
            np.testing.assert_array_equal(bj[k], bt[k])
    moved = device_put_batch(dt.batch(0), "cpu")
    assert moved["tokens"].dtype == torch.int32 and tuple(moved["tokens"].shape) == (2, 64)


def test_prefetcher_yields_in_order_and_stops():
    it = Prefetcher(iter(range(100)), depth=2)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    it.close()
    assert not it.t.is_alive()


@pytest.mark.parametrize("compression", ["int8", "none"])
def test_three_train_steps_match_jax(compression):
    steps = 3
    cj, ct = jget("stablelm-3b").smoke(), tget("stablelm-3b").smoke()
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")
    shape = INPUT_SHAPES["train_4k"].smoke()
    data = SyntheticLM(ct, shape, seed=0)

    comm_kw = dict(mode="explicit", compression=compression)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    opt_j, opt_t = jopt("adamw"), topt("adamw")
    step_j = jax.jit(jtrain.make_train_step(api_j, opt_j, mesh, JComm(**comm_kw),
                                            jsched("cosine", 3e-4, 5, 20), clip_norm=1.0))
    step_t = ttrain.make_train_step(api_t, opt_t, InProcessWorld(1), CommConfig(**comm_kw),
                                    tsched("cosine", 3e-4, 5, 20), clip_norm=1.0)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    for step in range(steps):
        batch = data.batch(step)
        with mesh:
            params_j, state_j, met_j = step_j(params_j, state_j,
                                              {k: to_jax(v) for k, v in batch.items()})
        params_t, state_t, met_t = step_t(params_t, state_t, device_put_batch(batch, "cpu"))
        # rtol 1e-3: from step 1 on the loss is a function of parameters that
        # went through Adam's g / sqrt(g^2), which turns last-bit gradient
        # differences between XLA and ATen into relative parameter
        # differences of about 1e-4; step 0 agrees to 1e-5
        np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(met_t["lr"]), float(met_j["lr"]), rtol=1e-5, atol=1e-12)
    for path, a, b in zip(tree_paths(params_t), tree_leaves(params_t),
                          jax.tree_util.tree_leaves(params_j)):
        # three steps at lr <= 1.8e-4 move a weight by at most 5.4e-4 in all;
        # where a gradient is near zero the sign of Adam's update is itself
        # uncertain, so an absolute bound well below one step's size
        np.testing.assert_allclose(np32(a), np.asarray(b), atol=1e-4, rtol=1e-3, err_msg=path)
    assert int(state_t.count) == steps


@pytest.mark.parametrize("compression", ["topk"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "stablelm-3b"])
def test_two_train_steps_match_jax_for_rwkv_and_topk(arch, compression):
    """The RWKV-6 trainer and the topk codec: two explicit-comm AdamW steps
    of the port against JAX's on the same smoke parameters and batches."""
    cj, ct = jget(arch).smoke(), tget(arch).smoke()
    api_j, api_t = jmodel(cj), tmodel(ct)
    params_j = api_j.init(jax.random.key(0))
    params_t = params_from_jax(jax_tree_to_numpy(params_j), ct, "cpu")
    data = SyntheticLM(ct, INPUT_SHAPES["train_4k"].smoke(), seed=0)
    comm_kw = dict(mode="explicit", compression=compression)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    opt_j, opt_t = jopt("adamw"), topt("adamw")
    step_j = jax.jit(jtrain.make_train_step(api_j, opt_j, mesh, JComm(**comm_kw),
                                            jsched("cosine", 3e-4, 5, 20), clip_norm=1.0))
    step_t = ttrain.make_train_step(api_t, opt_t, InProcessWorld(1), CommConfig(**comm_kw),
                                    tsched("cosine", 3e-4, 5, 20), clip_norm=1.0)
    state_j, state_t = opt_j.init(params_j), opt_t.init(params_t)
    for step in range(2):
        batch = data.batch(step)
        with mesh:
            params_j, state_j, met_j = step_j(params_j, state_j,
                                              {k: to_jax(v) for k, v in batch.items()})
        params_t, state_t, met_t = step_t(params_t, state_t, device_put_batch(batch, "cpu"))
        # rtol 1e-3 as in test_three_train_steps_match_jax (Adam turns last-bit
        # gradient differences into parameter differences of about 1e-4)
        np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(met_t["grad_norm"]), float(met_j["grad_norm"]), rtol=1e-3)


def _args(argv):
    return ttrain.build_parser().parse_args(argv)


@pytest.mark.parametrize("scheduler", ["fifo", "priority"])
@pytest.mark.parametrize("fusion_mb", ["64", "0.05"])
def test_dryrun_prints_the_same_bucket_order(scheduler, fusion_mb, capsys):
    argv = ["--smoke", "--dryrun", "--scheduler", scheduler, "--fusion-mb", fusion_mb,
            "--comm-mode", "explicit"]
    out_t = ttrain.main(argv)
    line_t = capsys.readouterr().out.strip().splitlines()[-1]
    out_j = jtrain.main(argv)
    line_j = capsys.readouterr().out.strip().splitlines()[-1]
    assert out_t == out_j
    assert line_t == line_j
    assert out_t["n_buckets"] == (1 if fusion_mb == "64" else len(out_t["bucket_order"]))


def test_dryrun_full_width_costs_no_memory():
    out = ttrain.main(["--dryrun", "--scheduler", "priority"])
    assert out["arch"] == "stablelm-3b" and out["n_buckets"] == len(out["bucket_order"]) > 5
    assert out["bucket_order"] == sorted(out["bucket_order"], reverse=True)


def test_main_refuses_cuda_on_a_machine_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--smoke", "--steps", "1", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--smoke", "--steps", "1"])          # cuda is the default


def test_main_trains_on_the_cpu_when_asked():
    out = ttrain.main(["--smoke", "--steps", "8", "--comm-mode", "explicit",
                       "--compression", "int8", "--device", "cpu", "--lr", "3e-3"])
    for key in ("arch", "steps", "first_loss", "last_loss", "median_step_s", "compile_s",
                "tokens_per_s", "loss_decreased"):
        assert key in out
    assert out["loss_decreased"] and out["device"] == "cpu" and len(out["losses"]) == 8


@pytest.mark.parametrize("flags", [["--comm-mode", "auto"],
                                   ["--comm-mode", "explicit", "--compression", "ternary"],
                                   ["--comm-mode", "explicit", "--compression", "fp16",
                                    "--use-pallas", "never", "--layers", "1"],
                                   ["--comm-mode", "explicit", "--compression", "topk"],
                                   ["--arch", "rwkv6-1.6b", "--comm-mode", "explicit",
                                    "--compression", "int8"]])
def test_main_other_modes_run(flags):
    out = ttrain.main(["--smoke", "--steps", "2", "--device", "cpu", *flags])
    assert np.isfinite(out["last_loss"])


def test_comm_from_args_matches_jax():
    argv = ["--comm-mode", "explicit", "--compression", "int8", "--fusion-mb", "8",
            "--flat-allreduce", "--scheduler", "chunked", "--sched-chunks", "2"]
    cj = jtrain.comm_from_args(_args(argv))
    ct = ttrain.comm_from_args(_args(argv))
    assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
