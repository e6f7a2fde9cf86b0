"""Leaves that a configuration's reference moves by a rule and not by its
gradient (``ruled_leaves``, a router's correction bias): ``follow`` gives
them no AdamW, ``check.gaps`` holds their change and not their gradient,
and the program's readings need no moment of them."""
import json
import math
from pathlib import Path

import pytest
import torch

from conftest import TINY_CELLS, TINY_LIMITS
from portbench.counts import arch
from portbench.harness import check, spec, traffic as traffic_lib, trainer, weights
from portbench.reference.train import Readings, follow

CPU = torch.device("cpu")
TRAFFIC = dict(json.loads((Path(__file__).resolve().parents[1]
                           / "traffic/train-s4096-int8.json").read_text()), seq_len=32, batch=2)
RULED = "blocks.ln1.w"         # (layers, d_model): two dims, so AdamW would decay it

FIXTURE = '''
from portbench.reference import model


def leaves(a):
    return model.leaves(a)


def ruled_leaves(a):
    return ["blocks.ln1.w"]


def loss(params, tokens, labels, a, mm, half=False):
    return model.loss(params, tokens, labels, a, mm, half)


def after_update(params, extras, a):
    params["blocks.ln1.w"].add_(0.5)
'''


def _ruled_arch(home: Path) -> arch.Arch:
    (home / "reference").mkdir(parents=True)
    (home / "reference" / "ruled.py").write_text(FIXTURE)
    cfg = dict(TINY_CELLS["tiny-dense.train-s128x2"][1],
               port={"attention": "mha", "reference": "reference/ruled.py"})
    return arch.from_dict(cfg, "tiny-ruled", home)


def _batches(a: arch.Arch, n: int):
    gen = traffic_lib.for_cell(a.vocab, TRAFFIC, 5)
    return [gen(i) for i in range(n)]


def test_follow_moves_a_ruled_leaf_by_its_rule_alone(tmp_path):
    a = _ruled_arch(tmp_path / "portbench")
    ref = arch.module(a, "reference")
    w = weights.make(ref.leaves(a), 5, CPU, torch.float32)
    readings = follow(a, w, _batches(a, 3), TRAFFIC)
    assert readings.ruled == (RULED,)
    i = readings.paths.index(RULED)
    # three steps of +0.5 from ones, and nothing of AdamW's lr 3e-4 or its decay
    shape = dict(ref.leaves(a))[RULED]
    assert readings.change_norms[i] == float(torch.linalg.vector_norm(torch.full(shape, 1.5)))
    assert readings.grad_norms[i] == 0.0
    # every other leaf is AdamW's, as it is where no leaf is ruled
    plain = follow(arch.from_dict(TINY_CELLS["tiny-dense.train-s128x2"][1], "tiny-dense"),
                   w, _batches(a, 1), TRAFFIC)
    assert readings.losses[0] == plain.losses[0]
    assert all(c > 0 for k, c in zip(readings.paths, readings.change_norms) if k != RULED)


def test_a_ruled_leaf_that_is_no_leaf_is_refused(tmp_path):
    a = _ruled_arch(tmp_path / "portbench")
    ref = arch.module(a, "reference")
    w = weights.make(ref.leaves(a), 5, CPU, torch.float32)
    w.pop(RULED)
    with pytest.raises(ValueError, match=RULED):
        follow(a, w, _batches(a, 1), TRAFFIC)


def _readings(bias_grad: float, bias_change: float, ruled) -> Readings:
    return Readings(["a", "b", "bias", "c"], [2.0], [1.0, 2.0, bias_grad, 3.0],
                    [1.0, 1.0, bias_change, 1.0], ruled)


def test_gaps_hold_a_ruled_leaf_by_its_change_and_never_by_its_gradient():
    # the reference's bias has no gradient; the program's reads one, and its
    # change is 0.75 where the reference's is 0.5
    ref, prog = _readings(0.0, 0.5, ("bias",)), _readings(5.0, 0.75, ("bias",))
    gaps = check.gaps(prog, ref)
    assert gaps["change_gap"] == (0.25, "bias")            # 0.25 over the median leaf's 1.0
    assert gaps["grad_gap"] == (0.0, "a") and gaps["grad_gap_median"][0] == 0.0
    correct, rows = check.verdict(gaps, TINY_LIMITS)
    assert not correct
    assert [r["name"] for r in rows if r["value"] > r["limit"]] == ["change_gap"]
    # unruled, the same leaf would go out of the change as round-off only
    # and read on the gradient
    plain = check.gaps(_readings(5.0, 0.75, ()), _readings(0.0, 0.5, ()))
    assert plain["change_gap"][0] == 0.0 and plain["grad_gap"][1] == "bias"


def _dropping(step_fn, path: str):
    """The step, its optimizer's state holding no first moment of ``path``."""
    def step(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        mu = node = dict(opt_state.mu)
        *outer, last = path.split(".")
        for key in outer:
            node[key] = dict(node[key])
            node = node[key]
        del node[last]
        return params, opt_state._replace(mu=mu), metrics
    return step


def _program(a: arch.Arch) -> trainer.Program:
    cell = spec.Cell(name=f"{a.name}.x", chips=1, config=a.name, arch=a, traffic=TRAFFIC,
                     cell={}, end_to_end=[], per_layer=[])
    return trainer.Program(cell, 7, CPU, None)


@pytest.mark.parametrize("dropped, raises", [(RULED, False), ("blocks.ln2.w", True)])
def test_checked_steps_read_a_ruled_leaf_without_a_moment(tmp_path, dropped, raises):
    a = _ruled_arch(tmp_path / "portbench")
    b1 = TRAFFIC["optimizer"]["b1"]
    whole = _program(a)
    expected = whole.checked_steps(1, b1)
    whole.close()
    prog = _program(a)
    prog.step_fn = _dropping(prog.step_fn, dropped)
    try:
        if raises:
            with pytest.raises(KeyError, match=dropped):
                prog.checked_steps(1, b1)
            return
        got = prog.checked_steps(1, b1)
    finally:
        prog.close()
    i = got.paths.index(RULED)
    assert got.ruled == (RULED,) and got.grad_norms[i] == 0.0
    assert expected.grad_norms[i] > 0 and math.isfinite(expected.grad_norms[i])
    assert got.losses == expected.losses and got.change_norms == expected.change_norms
    assert [g for k, g in zip(got.paths, got.grad_norms) if k != RULED] == \
        [g for k, g in zip(expected.paths, expected.grad_norms) if k != RULED]
