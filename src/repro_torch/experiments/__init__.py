"""Declarative experiment engine for the paper's sweep methodology.

- :mod:`repro_torch.experiments.spec`      — ``ExperimentSpec`` / ``Cell`` grids
- :mod:`repro_torch.experiments.grids`     — named paper grids + suites
- :mod:`repro_torch.experiments.runner`    — concurrent fan-out over the simulator
- :mod:`repro_torch.experiments.artifacts` — versioned JSON artifact I/O
- :mod:`repro_torch.experiments.compare`   — tolerance-gated artifact diffing
- :mod:`repro_torch.experiments.cli`       — ``python -m repro_torch.experiments``
"""
from repro_torch.experiments.spec import CELL_AXES, Cell, ExperimentSpec
from repro_torch.experiments.grids import GRIDS, SUITES, resolve
from repro_torch.experiments.runner import (ENGINE_VERSION, index_cells, run_cell,
                                      run_spec, run_suite)
from repro_torch.experiments.compare import CompareReport, Violation, compare
from repro_torch.experiments import artifacts

__all__ = [
    "CELL_AXES", "Cell", "ExperimentSpec", "GRIDS", "SUITES", "resolve",
    "ENGINE_VERSION", "index_cells", "run_cell", "run_spec", "run_suite",
    "CompareReport", "Violation", "compare", "artifacts",
]
