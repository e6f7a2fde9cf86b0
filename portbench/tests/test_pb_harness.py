"""The harness driven on the CPU at a tiny size, past its look for a card:
a cell added as data runs, the reference agrees with the program, and the
control and each fault the cells can have come out as not correct."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, TINY_CELLS
from portbench.harness import check, spec, trainer

CPU = torch.device("cpu")
SEEDS = (1, 2, 2147483659)


def _run(root, cell_name, seed):
    cell = spec.load(cell_name, root)
    return trainer.run(cell, seed, 0.5, False, CPU, time.time())


@pytest.mark.parametrize("cell_name", sorted(TINY_CELLS))
def test_a_cell_added_as_data_runs_and_is_correct(tiny_root, cell_name):
    out = _run(tiny_root, cell_name, 3)
    w = out["window"]
    assert w.attempted >= 1 and w.failed == 0 and w.seconds() >= 0.5
    assert w.setup_s > 0
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", sorted(TINY_CELLS))
def test_the_reference_agrees_with_the_program(tiny_root, cell_name, seed):
    cell = spec.load(cell_name, tiny_root)
    prog = trainer.Program(cell, seed, CPU, None)
    readings = prog.checked_steps(3, cell.traffic["optimizer"]["b1"])
    prog.close()
    ref = trainer.reference_readings(cell, seed, CPU, 1)
    assert readings.losses[0] == pytest.approx(ref.losses[0], rel=1e-6)
    correct, rows = check.verdict(check.gaps(readings, ref), spec.limits(cell))
    assert correct, rows


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", sorted(TINY_CELLS))
def test_the_tf32_control_is_not_correct(tiny_root, cell_name, seed):
    cell = spec.load(cell_name, tiny_root)
    ref = trainer.reference_readings(cell, seed, CPU, 1)
    control = trainer.reference_readings(cell, seed, CPU, 1, "tf32")
    correct, rows = check.verdict(check.gaps(control, ref), spec.limits(cell))
    assert not correct, rows


def _unchanged(step_fn):
    """The step computes on copies and returns its state unchanged."""
    from repro_torch.utils.tree import tree_map

    def step(params, opt_state, batch):
        copy = tree_map(lambda t: t.clone(), (params, opt_state))
        return params, opt_state, step_fn(*copy, batch)[2]
    return step


def _half(step_fn):
    """Half of each batch left out, the mean taken over the rest."""
    def step(params, opt_state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step_fn(params, opt_state, {k: v[:rows] for k, v in batch.items()})
    return step


@pytest.mark.parametrize("cell_name", sorted(TINY_CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half], ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(tiny_root, monkeypatch, fault, cell_name):
    build = trainer.Program.__init__

    def broken(self, *args, **kwargs):
        build(self, *args, **kwargs)
        self.step_fn = fault(self.step_fn)
    monkeypatch.setattr(trainer.Program, "__init__", broken)
    out = _run(tiny_root, cell_name, 1)
    assert not out["correct"], out["checks"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           json.loads((REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_nothing_loads_jax_or_the_jax_package_and_the_reference_loads_no_program():
    code = """
import sys
sys.path[:0] = [{repo!r}, {src!r}]
import portbench.reference.model, portbench.reference.train, portbench.reference.precision
import portbench.reference.mla
import portbench.counts.flops, portbench.counts.flops_mla, portbench.counts.bounds
import portbench.counts.buckets
ref_top = {{m.split(".")[0] for m in sys.modules}}
import portbench.calibrate
import portbench.harness.trainer, portbench.harness.ranks
from portbench.harness import spec, trainer
cell = spec.load("stablelm-3b-f32.train-s4096-int8")
trainer.program_leaves(cell)
spec.model_config(cell)
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "repro"}}), "repro_torch" in ref_top, "repro_torch" in top)
""".format(repo=str(REPO), src=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "False", "True"]


def test_the_rank_launcher_rendezvouses_at_world_2_over_gloo():
    from portbench.harness import ranks

    code = """
import sys, torch
sys.path[:0] = [{src!r}]
from repro_torch.launch.train import build_world
import torch.distributed as dist
world, device = build_world(torch.device("cpu"))
total = world.all_reduce_sum([torch.tensor([float(world.rank + 1)])])[0]
assert world.size == 2 and total.item() == 3.0, (world.size, total)
dist.destroy_process_group()
""".format(src=str(REPO / "src"))
    assert ranks.launch(2, [sys.executable, "-c", code], {}, timeout=120) == 0
