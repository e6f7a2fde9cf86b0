"""The port's own copy of the experiment engine (``repro_torch.experiments``)
against the JAX package's and against the committed goldens.

- each of the eight golden suites, run through the port's CLI, passes the
  port's ``compare`` against ``artifacts/golden/*_suite.json`` (1e-9);
- the registered grids and suites, their cell counts and spec hashes equal
  the reference's, and ``run_spec`` agrees cell by cell;
- counterparts of ``tests/test_experiments.py`` (spec, artifacts, compare,
  CLI) and of ``tests/test_runner_hardening.py`` (journal, resume, retries)
  on the port's modules.
"""
import contextlib
import copy
import io
import json
import math
from pathlib import Path

import pytest

from repro import experiments as jexp
from repro.experiments import grids as jgrids
from repro.experiments import validations as jval
from repro_torch.experiments import (GRIDS, SUITES, Cell, ExperimentSpec,
                                     artifacts, compare, grids, index_cells,
                                     run_cell, run_spec, run_suite)
from repro_torch.experiments import validations as tval
from repro_torch.experiments.cli import main as cli_main
from repro_torch.experiments.runner import _ADDEST, _load_journal

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "artifacts" / "golden"

# the eight suites CI gates, with the golden file each is compared with
SUITE_GOLDENS = {"paper": "paper_suite.json",
                 "scheduler": "scheduler_suite.json",
                 "scenario": "scenario_suite.json",
                 "compression": "compression_suite.json",
                 "churn": "churn_suite.json",
                 "fabric": "fabric_suite.json",
                 "wan": "wan_suite.json",
                 "xxl": "xxl_contention_suite.json"}


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli_main(argv)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# the goldens, through the port's CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suite", sorted(SUITE_GOLDENS))
def test_golden_suite_through_the_port_cli(suite, tmp_path):
    out = tmp_path / f"{suite}.json"
    rc, text = _quiet(["run", "--grid", suite, "--out", str(out)])
    assert rc == 0, text
    assert "all paper-claim checks pass" in text
    golden = GOLDEN / SUITE_GOLDENS[suite]
    report = compare(artifacts.read(golden), artifacts.read(out))
    assert report.ok, report.summary()
    assert report.n_cells == sum(len(e["cells"])
                                 for e in artifacts.read(golden)["experiments"])
    rc, text = _quiet(["compare", str(golden), str(out)])
    assert rc == 0 and "OK" in text, text


# ---------------------------------------------------------------------------
# the registry and the runner against the reference
# ---------------------------------------------------------------------------

def test_grids_suites_and_hashes_equal_the_reference():
    assert sorted(GRIDS) == sorted(jgrids.GRIDS) and len(GRIDS) == 18
    for name, spec in GRIDS.items():
        ref = jgrids.GRIDS[name]
        assert spec.canonical_json() == ref.canonical_json(), name
        assert spec.spec_hash() == ref.spec_hash(), name
        assert spec.n_cells == ref.n_cells == len(spec.expand()), name
        assert [c.to_dict() for c in spec.expand()] == \
            [c.to_dict() for c in ref.expand()], name
    assert SUITES == jgrids.SUITES and len(SUITES) == 9
    assert sorted(tval.VALIDATORS) == sorted(jval.VALIDATORS)
    for s in GRIDS:
        assert [x.name for x in grids.resolve(s)] == \
            [x.name for x in jgrids.resolve(s)]


def test_list_prints_what_the_reference_prints():
    from repro.experiments.cli import main as jmain
    rc, ours = _quiet(["list"])
    with contextlib.redirect_stdout(io.StringIO()) as ref:
        jrc = jmain(["list"])
    assert rc == jrc == 0
    assert ours == ref.getvalue()


def _same_cell(a, b, where):
    assert a.keys() == b.keys(), where
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and isinstance(y, float) and math.isfinite(y):
            assert abs(x - y) <= 1e-9 + 1e-9 * abs(y), (where, k, x, y)
        else:
            assert x == y, (where, k, x, y)


@pytest.mark.parametrize("grid", ["paper-fig3", "compression"])
def test_run_spec_matches_the_reference(grid):
    ours = run_spec(GRIDS[grid], executor="serial")
    ref = jexp.run_spec(jgrids.GRIDS[grid], executor="serial")
    assert ours["spec_hash"] == ref["spec_hash"]
    assert ours["spec"] == ref["spec"]
    assert ours["validations"] == ref["validations"]
    assert all(ours["validations"].values())
    assert len(ours["cells"]) == len(ref["cells"]) == GRIDS[grid].n_cells
    for i, (a, b) in enumerate(zip(ours["cells"], ref["cells"])):
        _same_cell(a, b, f"{grid} cell {i}")


def test_addest_names_are_v100_and_h100():
    from repro_torch.core.addest import AddEst
    assert set(_ADDEST) == {"v100", "h100"}
    assert _ADDEST["v100"]() == AddEst.v100()
    assert _ADDEST["h100"]() == AddEst.h100()
    spec = ExperimentSpec(name="t", models=("resnet50",), n_servers=(2,),
                          bandwidth_gbps=(10.0,), addest="h100")
    on_h100 = run_spec(spec, executor="serial")["cells"][0]
    on_v100 = run_spec(ExperimentSpec(name="t", models=("resnet50",),
                                      n_servers=(2,), bandwidth_gbps=(10.0,)),
                       executor="serial")["cells"][0]
    # the H100's faster adds can only shorten the sync
    assert on_h100["t_sync"] < on_v100["t_sync"]


# ---------------------------------------------------------------------------
# spec / grid expansion (counterparts of tests/test_experiments.py)
# ---------------------------------------------------------------------------

def test_expand_is_cartesian_product_in_stable_order():
    spec = ExperimentSpec(name="t", models=("a", "b"), n_servers=(2, 4),
                          bandwidth_gbps=(1.0, 10.0), transport=("ideal",))
    cells = spec.expand()
    assert len(cells) == spec.n_cells == 8
    assert cells[0] == Cell("a", 2, 1.0, "ideal", 1.0, "ring")
    assert cells[1] == Cell("a", 2, 10.0, "ideal", 1.0, "ring")
    assert cells[-1] == Cell("b", 4, 10.0, "ideal", 1.0, "ring")
    assert len({c.key() for c in cells}) == 8


def test_spec_round_trips_and_hash_is_stable_and_sensitive():
    spec = ExperimentSpec(name="t", models=["resnet50"], n_servers=[2])
    assert spec.models == ("resnet50",)
    again = ExperimentSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert again == spec and again.spec_hash() == spec.spec_hash()
    assert ExperimentSpec(name="t", bandwidth_gbps=(10.0,)).spec_hash() != \
        ExperimentSpec(name="t", bandwidth_gbps=(25.0,)).spec_hash()


def test_new_axes_elided_at_their_defaults():
    solo = Cell("resnet50", 2, 10.0, "ideal", 1.0, "ring")
    for key in ("n_jobs", "n_rails", "jitter_ms", "codec", "link_profile"):
        assert key not in solo.to_dict()
    assert Cell.from_dict(solo.to_dict()) == solo
    plain = ExperimentSpec(name="t")
    for key in ("n_jobs", "n_rails", "jitter_ms", "rail_policy",
                "jitter_seed", "codec", "fabric", "link_profile"):
        assert key not in plain.to_dict()
    swept = ExperimentSpec(name="t", n_jobs=(1, 2), n_rails=(1, 2))
    assert swept.to_dict()["n_jobs"] == (1, 2)
    assert swept.spec_hash() != plain.spec_hash()
    # the same spec hashes to the same value in both packages
    for s in (plain, swept):
        ref = jexp.ExperimentSpec.from_dict(s.to_dict())
        assert ref.spec_hash() == s.spec_hash()


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_executors_agree_bitwise(executor):
    spec = ExperimentSpec(name="t", models=("resnet50",), n_servers=(2, 8),
                          bandwidth_gbps=(10.0, 100.0),
                          scheduler=("fifo", "chunked"), sched_chunks=8,
                          jitter_ms=(0.0, 5.0), jitter_seed=13)
    serial = run_spec(spec, executor="serial")
    other = run_spec(spec, executor=executor, max_workers=2)
    assert serial["cells"] == other["cells"]
    assert serial["spec_hash"] == other["spec_hash"]


def test_contention_cell_is_simulate_contention_first_job():
    from repro_torch.core.simulator import simulate_contention
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    spec = ExperimentSpec(name="t", models=("resnet50",), n_servers=(2,),
                          bandwidth_gbps=(10.0,), n_jobs=(1, 4))
    by_jobs = {c.get("n_jobs", 1): c
               for c in run_spec(spec, executor="serial")["cells"]}
    want = simulate_contention([from_cnn("resnet50")] * 4, n_workers=16,
                               bandwidth=10.0 * GBPS)[0]
    assert by_jobs[4]["t_sync"] == want.t_sync
    assert by_jobs[4]["scaling_factor"] < by_jobs[1]["scaling_factor"]
    with pytest.raises(ValueError, match="ring"):
        run_cell(ExperimentSpec(name="t"),
                 Cell("resnet50", 2, 10.0, "ideal", 1.0, "switchml", "fifo", 4))


# ---------------------------------------------------------------------------
# artifacts and compare
# ---------------------------------------------------------------------------

def _small_artifact(tmp_path, name="a.json"):
    rec = run_spec(ExperimentSpec(name="small", models=("resnet50",),
                                  n_servers=(2,), bandwidth_gbps=(10.0,)))
    path = tmp_path / name
    artifacts.write(path, [rec])
    return path, rec


def test_artifact_round_trip_and_deterministic_bytes(tmp_path):
    p1, rec = _small_artifact(tmp_path, "a.json")
    p2, _ = _small_artifact(tmp_path, "b.json")
    assert p1.read_bytes() == p2.read_bytes()
    art = artifacts.read(p1)
    assert art["kind"] == "repro-experiment-artifact"
    assert art["experiments"][0]["cells"] == rec["cells"]
    report = compare(art, art)
    assert report.ok and report.n_cells == 1
    # the reference writes the same bytes for the same record
    from repro.experiments import artifacts as jart
    jart.write(tmp_path / "ref.json", [rec])
    assert (tmp_path / "ref.json").read_bytes() == p1.read_bytes()


def test_artifact_read_rejects_garbage(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{\"kind\": \"something-else\"}")
    with pytest.raises(artifacts.ArtifactError):
        artifacts.read(p)
    p.write_text("not json")
    with pytest.raises(artifacts.ArtifactError):
        artifacts.read(p)


def test_artifact_write_is_atomic_and_leaves_no_partial(tmp_path):
    p = tmp_path / "art.json"
    artifacts.write(p, [{"name": "x", "cells": []}])
    before = p.read_bytes()
    with pytest.raises(TypeError):
        artifacts.write(p, [{"bad": object()}])
    assert p.read_bytes() == before
    assert [f.name for f in tmp_path.iterdir()] == ["art.json"]


def test_compare_detects_drift_dropped_field_spec_drift_and_claim_flip(tmp_path):
    path, _ = _small_artifact(tmp_path)
    art = artifacts.read(path)
    drifted = copy.deepcopy(art)
    drifted["experiments"][0]["cells"][0]["scaling_factor"] += 1e-6
    report = compare(art, drifted)
    assert any(v.kind == "field" and "scaling_factor" in v.where
               for v in report.violations)
    assert compare(art, drifted, tolerances={"scaling_factor": 1e-3}).ok

    shrunk = copy.deepcopy(art)
    del shrunk["experiments"][0]["cells"][0]["t_sync"]
    assert any("t_sync" in v.where and "only in old" in v.detail
               for v in compare(art, shrunk).violations)

    other = run_spec(ExperimentSpec(name="small", models=("resnet50",),
                                    n_servers=(2,), bandwidth_gbps=(25.0,)))
    report = compare(art, artifacts.make_artifact([other]))
    assert any(v.kind == "spec" for v in report.violations)
    report = compare(art, artifacts.make_artifact([]))
    assert any("missing" in v.detail for v in report.violations)

    rec = run_spec(GRIDS["paper-fig1"])
    good = artifacts.make_artifact([rec])
    flipped = copy.deepcopy(good)
    for k in flipped["experiments"][0]["validations"]:
        flipped["experiments"][0]["validations"][k] = False
    report = compare(good, flipped)
    assert not report.ok
    assert all(v.kind == "validation" for v in report.violations)


def test_compare_refuses_a_golden_of_another_grid():
    """A golden with another spec hash is refused before any number."""
    paper = artifacts.read(GOLDEN / "paper_suite.json")
    fig1 = [e for e in paper["experiments"] if e["name"] == "paper-fig1"][0]
    wrong = copy.deepcopy(fig1)
    wrong["spec_hash"] = "0" * 16
    report = compare(artifacts.make_artifact([fig1]),
                     artifacts.make_artifact([wrong]))
    assert [v.kind for v in report.violations] == ["spec"]


# ---------------------------------------------------------------------------
# CLI exit codes
# ---------------------------------------------------------------------------

def test_cli_run_compare_report_list(tmp_path):
    out = tmp_path / "fig1.json"
    assert _quiet(["run", "--grid", "paper-fig1", "--out", str(out)])[0] == 0
    rc, text = _quiet(["compare", str(out), str(out)])
    assert rc == 0 and "OK" in text
    rc, text = _quiet(["report", str(out)])
    assert rc == 0 and "paper-fig1" in text and "PASS" in text
    art = artifacts.read(out)
    art["experiments"][0]["cells"][0]["t_sync"] *= 1.01
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(art))
    assert _quiet(["compare", str(out), str(bad)])[0] == 1
    with pytest.raises(KeyError):
        cli_main(["run", "--grid", "nope", "--out", str(tmp_path / "x")])
    with pytest.raises(SystemExit):
        cli_main(["run", "--grid", "paper-fig1", "--resume",
                  "--out", str(tmp_path / "x")])


def test_cli_run_exits_1_on_a_failed_claim(tmp_path, monkeypatch):
    from repro_torch.experiments import validations
    monkeypatch.setitem(validations.VALIDATORS, "paper-fig1",
                        lambda cells: {"always_fails": False})
    rc, text = _quiet(["run", "--grid", "paper-fig1",
                       "--out", str(tmp_path / "f.json")])
    assert rc == 1 and "FAILED paper-claim checks" in text


# ---------------------------------------------------------------------------
# journal, resume, retries (counterparts of tests/test_runner_hardening.py)
# ---------------------------------------------------------------------------

TINY = ExperimentSpec(name="tiny-hardening", models=("resnet50",),
                      n_servers=(2,), bandwidth_gbps=(10.0,),
                      transport=("ideal",), scheduler=("fifo", "priority"))
BROKEN = ExperimentSpec(name="tiny-broken",
                        models=("resnet50", "no-such-model"),
                        n_servers=(2,), bandwidth_gbps=(10.0,),
                        transport=("ideal",))


def test_journal_and_resume_after_a_torn_tail_is_byte_identical(tmp_path):
    j = tmp_path / "tiny.jsonl"
    single = run_spec(TINY, executor="serial", journal=j)
    lines = j.read_text().splitlines(keepends=True)
    head = json.loads(lines[0])
    assert head["kind"] == "repro-journal"
    assert head["spec_hash"] == TINY.spec_hash()
    assert len(lines) == 1 + len(single["cells"])
    done = _load_journal(j, TINY)
    assert [done[i] for i in range(len(single["cells"]))] == single["cells"]
    # crash after the first cell, mid-write of the second
    j.write_text("".join(lines[:2]) + lines[2][: len(lines[2]) // 2])
    resumed = run_spec(TINY, executor="serial", journal=j, resume=True)
    artifacts.write(tmp_path / "a.json", [single])
    artifacts.write(tmp_path / "b.json", [resumed])
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    # a journal of another grid is refused
    other = tmp_path / "other.jsonl"
    run_spec(BROKEN, executor="serial", journal=other)
    with pytest.raises(ValueError, match="refusing to resume"):
        run_spec(TINY, executor="serial", journal=other, resume=True)


def test_cli_resume_replays_the_journal(tmp_path):
    jdir = tmp_path / "journals"
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert _quiet(["run", "--grid", "paper-fig1", "--out", str(a),
                   "--journal", str(jdir)])[0] == 0
    assert (jdir / "paper-fig1.jsonl").exists()
    assert _quiet(["run", "--grid", "paper-fig1", "--out", str(b),
                   "--journal", str(jdir), "--resume"])[0] == 0
    assert a.read_bytes() == b.read_bytes()


def test_retry_exhaustion_degrades_gracefully():
    rec = run_spec(BROKEN, executor="serial", retries=1)
    bad = [c for c in rec["cells"] if c.get("failed")]
    assert len(bad) == 1 and bad[0]["model"] == "no-such-model"
    assert "error" in bad[0]
    assert rec["validations"]["no_failed_cells"] is False


def test_hardened_process_pool_matches_serial(tmp_path):
    plain = run_spec(TINY, executor="serial")
    hard = run_spec(TINY, executor="process", cell_timeout=300.0, retries=1,
                    journal=tmp_path / "j.jsonl", max_workers=2)
    assert json.dumps(plain, sort_keys=True) == json.dumps(hard, sort_keys=True)
    out = run_suite([TINY], journal_dir=tmp_path / "journals")
    assert (tmp_path / "journals" / "tiny-hardening.jsonl").exists()
    assert out[0]["cells"] == plain["cells"]


def test_index_cells_keys_every_axis():
    rec = run_spec(GRIDS["paper-fig1"])
    ix = index_cells(rec["cells"])
    assert len(ix) == GRIDS["paper-fig1"].n_cells
    assert all(len(k) == 17 for k in ix)
