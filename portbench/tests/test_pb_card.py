"""On the card, at each cell's own size: the program's checked steps are
correct against the reference and the control is not.  Skips without a
card; run on one with ``python -m pytest portbench/tests -m card``."""
import json

import pytest
import torch

from conftest import REPO
from portbench.harness import check, spec, trainer
from portbench.reference.precision import CONTROL

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_program_correct_and_control_not_at_the_cells_size(card, cell_name):
    cell = spec.load(cell_name)
    seed = 2147483777
    prog = trainer.Program(cell, seed, card, None)
    readings = prog.checked_steps(int(cell.cell["checked_steps"]), cell.traffic["optimizer"]["b1"])
    prog.close()
    del prog
    torch.cuda.empty_cache()
    ref = trainer.reference_readings(cell, seed, card, cell.world)
    correct, rows = check.verdict(check.gaps(readings, ref), spec.limits(cell))
    assert correct, rows
    control = trainer.reference_readings(cell, seed, card, cell.world, CONTROL[cell.arch.dtype])
    correct, rows = check.verdict(check.gaps(control, ref), spec.limits(cell))
    assert not correct, rows
