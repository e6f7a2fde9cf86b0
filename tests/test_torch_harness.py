"""The port's harness against the JAX package's: ``benchmarks/torch_figures.py``
(rows and validations of ``benchmarks/figures.py`` at 1e-9),
``benchmarks/torch_run.py`` (all four sections on the CPU, section 3 in the
reference's layout), ``benchmarks/torch_sweep_bench.py`` (its engine against
the seed engine's port copy), ``tools/torch_profile_engine.py`` (the
reference tool's cells) and ``tools/torch_check_docs.py``."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))                                   # benchmarks/, tools/

from benchmarks import figures as jfigs  # noqa: E402
from benchmarks import torch_figures as tfigs  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks import torch_sweep_bench as tsweep  # noqa: E402
from tools import torch_check_docs  # noqa: E402

TOL = 1e-9


def _close(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=TOL, abs_tol=TOL)
    return a == b


@pytest.mark.parametrize("name", ["fig2_computation_time", "table_transmission",
                                  "bytescheduler_bound", "scheduler_contention"])
def test_every_figure_function_gives_the_references_rows_and_checks(name):
    got, want = getattr(tfigs, name)(), getattr(jfigs, name)()
    for out in (got, want):
        if isinstance(out[1], dict):
            out[1].pop("us")                                # wall clock
    assert _close(got[0], want[0]) and got[1] == want[1]


def test_run_passes_on_the_cpu_and_prices_the_references_layout(tmp_path, capsys):
    assert torch_run.main(["--device", "cpu",
                           "--dryrun-results", str(tmp_path / "none.json")]) == 0
    out = capsys.readouterr().out
    for title in ("SECTION 1", "SECTION 2", "SECTION 3", "SECTION 4", "ALL BENCHMARKS PASS",
                  "golden-artifact gate: compared 7 experiment(s)", "scheduler-golden gate",
                  "none.json not present"):
        assert title in out
    section2 = out.split("SECTION 2")[1].split("SECTION 3")[0]
    assert "quantize_int8_plain" in section2 and "_kernel," not in section2
    assert (REPO / "artifacts" / "experiments" / "torch_paper.json").exists()
    rows = torch_run.whatif_rows()
    assert {r["arch"] for r in rows} == set(torch_run.WHATIF_ARCHS) and len(rows) == 12
    for r in rows:
        assert r["n_gpus"] == 256 * r["pods"] and r["dp"] == 16 * r["pods"]
        assert r["mp"] == r["n_gpus"] // 16 // r["pods"] == 16
        assert 0 < r["scaling_factor"] <= 1
        assert f"h100_whatif[{r['arch']},gpus={r['n_gpus']},dp={r['dp']},mp=16]" in out


def test_sweep_bench_writes_its_table_and_its_engine_is_the_seeds(tmp_path):
    from _torch_reference_engine import run_reference_flows
    from repro_torch.core.events import run_flows

    flows = tsweep._stress_flows(jobs=2, n_chunks=4)
    for a, b in zip(run_reference_flows(flows, max_iters_factor=100), run_flows(flows)):
        assert math.isclose(a.end, b.end, rel_tol=TOL) and a.op_id == b.op_id
    out = tmp_path / "bench.json"
    assert tsweep.main(["--quick", "--out", str(out)]) == 0      # raises if it diverges
    res = json.loads(out.read_text())
    assert res["kind"] == "repro-torch-sweep-bench" and res["cpu_model"]
    assert res["metrics"]["stress_flows"] >= 2000 and res["metrics"]["sweep_cells"] > 0
    assert tsweep.check_regression(res, tmp_path / "missing.json")[0].startswith("cannot read")


def _listed(tool: str, grid: str) -> list:
    proc = subprocess.run([sys.executable, str(REPO / "tools" / tool), "--grid", grid, "--list"],
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()


@pytest.mark.parametrize("grid", ["paper-fig3", "scheduler"])
def test_profile_engine_lists_the_reference_tools_cells(grid):
    got, want = _listed("torch_profile_engine.py", grid), _listed("profile_engine.py", grid)
    assert len(got) == len(want) > 0 and got == want


def test_profile_engine_times_the_phases_of_a_cell(capsys):
    from tools import torch_profile_engine

    assert torch_profile_engine.main(["--grid", "paper-fig3", "--cell", "0", "--phases",
                                      "--repeat", "1"]) == 0
    assert "engine" in capsys.readouterr().out
    assert torch_profile_engine.main(["--grid", "paper-fig3", "--cell", "9999"]) == 2


def test_check_docs_passes_and_catches_a_planted_grid(tmp_path, capsys):
    assert torch_check_docs.main([]) == 0
    bad = tmp_path / "README.md"
    bad.write_text((REPO / "README.md").read_text()
                   + "\n`python -m repro_torch.experiments run --grid no-such-grid`\n")
    assert torch_check_docs.main([str(bad), str(REPO / "ROADMAP.md")]) == 1
    assert "`--grid no-such-grid` is not a registered grid" in capsys.readouterr().out
