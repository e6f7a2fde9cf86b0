"""The port's measurement seams of ``core/`` and its calibration bench against
the JAX package: ``AddEst``, ``get_codec`` and the codec table, the
calibration gate of ``benchmarks/torch_kernel_bench.py`` against
``benchmarks/kernel_bench.py``, and ``timeline.measure`` on the smoke
stablelm config.  Everything here runs the plain versions on the CPU; the
bench's CUDA timings come from ``chip_smoke.py`` on the card."""
import dataclasses
import json
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _torch_port import jax_tree_to_numpy

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))                                   # benchmarks/

from benchmarks import kernel_bench as jbench  # noqa: E402
from benchmarks import torch_kernel_bench as tbench  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES, get_config as jget  # noqa: E402
from repro.core import addest as jaddest  # noqa: E402
from repro.core import codec as jcodec  # noqa: E402
from repro.core import timeline as jtimeline  # noqa: E402
from repro.core.flops import layer_breakdown_from_params as jbreakdown  # noqa: E402
from repro.data.pipeline import SyntheticLM as JData  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import addest as taddest  # noqa: E402
from repro_torch.core import codec as tcodec  # noqa: E402
from repro_torch.core import timeline as ttimeline  # noqa: E402
from repro_torch.core.flops import layer_breakdown_from_params as tbreakdown  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from repro_torch.utils import trace  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

SIZES = np.concatenate([[-1.0, 0.0, 0.5, 1.0, 3.0], np.logspace(0, 34, 97, base=2.0),
                        np.random.default_rng(0).uniform(1, 2 ** 33, 50)])
BUCKET_ELEMENTS = 566_231_040          # stablelm-3b's largest gradient bucket


# ---------------------------------------------------------------------------
# AddEst
# ---------------------------------------------------------------------------

def test_addest_v100_is_bit_identical():
    a, b = taddest.AddEst.v100(), jaddest.AddEst.v100()
    assert a.sizes == b.sizes and a.times == b.times
    for x in SIZES:
        assert a(float(x)) == b(float(x))
    np.testing.assert_array_equal(a.batch(SIZES), b.batch(SIZES))
    assert (taddest.V100_MEM_BW, taddest.V100_LAUNCH_OVERHEAD) == (
        jaddest.V100_MEM_BW, jaddest.V100_LAUNCH_OVERHEAD)


def test_addest_h100_is_the_analytic_model_at_the_h100_constants():
    a = taddest.AddEst.h100()
    b = jaddest.AddEst.from_bandwidth(taddest.H100_MEM_BW, taddest.H100_LAUNCH_OVERHEAD)
    assert taddest.H100_MEM_BW == 3.35e12
    assert a.times == b.times
    np.testing.assert_array_equal(a.batch(SIZES), b.batch(SIZES))
    assert a(1 << 26) == pytest.approx(taddest.H100_LAUNCH_OVERHEAD + 3 * (1 << 26) / 3.35e12)


def test_addest_measure_on_the_cpu():
    est = taddest.AddEst.measure(sizes=(1 << 10, 1 << 16), repeats=2, device="cpu")
    assert est.sizes == (1024.0, 65536.0)
    assert all(t > 0 for t in est.times)
    assert est(0) == 0.0 and est(2048) > 0


def test_addest_measure_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        taddest.AddEst.measure(sizes=(1 << 10,), repeats=1)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def test_codec_constants_and_table_match():
    for name in ("INT8_WIRE_RATIO", "TERNARY_WIRE_RATIO", "PROBE_BYTES_PER_BYTE",
                 "ERROR_FEEDBACK_PASSES", "SIZE_ADAPTIVE", "SIZE_ADAPTIVE_THRESHOLD",
                 "FALLBACK_PASSES", "REGIME_WINS", "REGIME_LOSES", "REGIME_PURE_OVERHEAD",
                 "REGIME_NEUTRAL"):
        assert getattr(tcodec, name) == getattr(jcodec, name), name
    assert tcodec.TABLE_PATH == jcodec.TABLE_PATH
    assert tcodec.load_codec_table() == jcodec.load_codec_table()


def test_fallback_passes_equal_the_committed_table():
    table = json.loads((REPO / "artifacts" / "bench" / "BENCH_codec.json").read_text())["codecs"]
    assert {k: {"encode": v["encode_passes"], "decode": v["decode_passes"]}
            for k, v in table.items()} == tcodec.FALLBACK_PASSES


@pytest.mark.parametrize("spec,ratio", [("none", 1.0), ("none", 2.5), ("ratio:4", 1.0),
                                        ("ratio", 3.0), ("int8", 1.0), ("ternary", 1.0),
                                        ("topk:8", 1.0), ("topk", 20.0)])
def test_get_codec_matches_field_for_field(spec, ratio):
    a = tcodec.get_codec(spec, compression_ratio=ratio)
    b = jcodec.get_codec(spec, compression_ratio=ratio)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for nbytes in (0.0, 1.0, 64e6, 2.26e9):
        assert a.encode_seconds(nbytes) == b.encode_seconds(nbytes)
        assert a.decode_seconds(nbytes) == b.decode_seconds(nbytes)
    if not a.is_free:
        ea, eb = a.with_error_feedback(), b.with_error_feedback()
        assert dataclasses.asdict(ea) == dataclasses.asdict(eb)
        assert ea.name == a.name + "+ef"


@pytest.mark.parametrize("spec,ratio", [("none:2", 1.0), ("int8:3", 1.0), ("ternary", 2.0),
                                        ("int8", 4.0), ("bogus", 1.0), ("topk:abc", 1.0),
                                        ("size-adaptive", 1.0)])
def test_get_codec_refuses_what_the_reference_refuses(spec, ratio):
    with pytest.raises(ValueError) as ja:
        jcodec.get_codec(spec, compression_ratio=ratio)
    with pytest.raises(ValueError) as ta:
        tcodec.get_codec(spec, compression_ratio=ratio)
    assert str(ta.value) == str(ja.value)


def test_error_feedback_refuses_a_free_codec():
    for pkg in (tcodec, jcodec):
        with pytest.raises(ValueError):
            pkg.get_codec("ratio:4").with_error_feedback()


@pytest.mark.parametrize("args", [(0.5, 1.0, 10.0, 0.1), (0.05, 1.0, 10.0, 0.1),
                                  (1.2, 1.0, 10.0, 0.1), (0.001, 0.05, 10.0, 0.0),
                                  (0.001, 0.05, 10.0, 0.2), (1.0, 1.0, 10.0, 0.0)])
def test_classify_regime_matches(args):
    assert tcodec.classify_regime(*args) == jcodec.classify_regime(*args)


# ---------------------------------------------------------------------------
# the calibration bench
# ---------------------------------------------------------------------------

def test_kernel_codec_names_match_the_reference():
    names = tbench.kernel_codec_names()
    assert names == jbench.kernel_codec_names() == ["int8", "ternary"]


def _table(**passes):
    return {"kind": tbench.KIND, "codecs": {
        name: {"encode_passes": e, "decode_passes": d} for name, (e, d) in passes.items()}}


def _key(msg: str) -> str:
    # the two benches word their messages alike up to the module they name
    return re.split(r": | \(", msg)[0]


CHECK_CASES = [
    # committed, fresh
    (_table(int8=(0.6, 0.7), ternary=(0.6, 0.7), topk=(1.0, 1.0)),
     _table(int8=(0.61, 0.72), ternary=(0.59, 0.73), topk=(1.05, 1.0))),
    (_table(int8=(0.6, 0.7), ternary=(0.6, 0.7), topk=(1.0, 1.0)),
     _table(int8=(1.3, 0.7), ternary=(0.6, 0.3), topk=(1.0, 1.0))),          # drift both ways
    (_table(int8=(0.6, 0.7), topk=(1.0, 1.0)),
     _table(int8=(0.6, 0.7), ternary=(0.6, 0.7), topk=(1.0, 1.0))),          # ternary missing
    (_table(ternary=(0.6, 0.7), topk=(0.0, 1.0)),
     _table(int8=(0.6, 0.7), ternary=(0.6, 0.7), topk=(1.0, 1.0))),          # zero, int8 missing
    ({"kind": "something-else", "codecs": {}}, _table(int8=(1.0, 1.0))),
    (None, _table(int8=(1.0, 1.0))),                                         # unreadable
]


@pytest.mark.parametrize("committed,fresh", CHECK_CASES)
def test_check_table_flags_what_the_reference_flags(committed, fresh, tmp_path):
    path = tmp_path / "table.json"
    if committed is not None:
        path.write_text(json.dumps(committed))
    got = tbench.check_table(fresh, path)
    want = jbench.check_table(fresh, path)
    assert [_key(m) for m in got] == [_key(m) for m in want]
    assert (len(got) == 0) == (committed is CHECK_CASES[0][0])


def test_calibrate_on_the_cpu_writes_the_schema(tmp_path):
    trace.reset_counts()
    out = tmp_path / "t.json"
    rc = tbench.main(["--calibrate", "--quick", "--device", "cpu", "--elements", str(1 << 14),
                      "--out", str(out)])
    assert rc == 0
    t = json.loads(out.read_text())
    assert set(t) == {"kind", "schema_version", "quick", "interpret", "n_bytes", "probe_us",
                      "launch_probe_us", "device_model", "codecs"}
    assert t["kind"] == jbench.KIND and t["schema_version"] == jbench.SCHEMA_VERSION
    assert t["quick"] is True and t["interpret"] is True and t["n_bytes"] == 4 << 14
    assert t["device_model"] == {"name": "h100", "mem_bw": 3.35e12,
                                 "launch_overhead": taddest.H100_LAUNCH_OVERHEAD,
                                 "probe_bytes_per_byte": 2.0, "card": "cpu"}
    assert set(t["codecs"]) == {"int8", "ternary", "topk"}
    for c in t["codecs"].values():
        assert set(c) == {"encode_us", "decode_us", "encode_passes", "decode_passes"}
        assert c["encode_passes"] > 0 and c["decode_passes"] > 0
    assert t["codecs"]["topk"]["decode_passes"] == 1.0
    assert t["probe_us"] > 0 and t["launch_probe_us"] > 0
    # a table gated against itself passes; the plain versions launched nothing
    assert tbench.check_table(t, out) == []
    assert all(v == 0 for v in trace.counts("launch").values())
    # the CPU table reads back through the codec module like the committed one
    table = tcodec.load_codec_table(str(out))
    assert table["int8"] == {"encode": t["codecs"]["int8"]["encode_passes"],
                             "decode": t["codecs"]["int8"]["decode_passes"]}


def test_the_bench_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tbench.main(["--calibrate"])
    with pytest.raises(RuntimeError):
        tbench.calibrate(quick=True)


def test_the_h100_table_is_the_cards_and_prices_codecs():
    path = tcodec.H100_TABLE_PATH
    assert path == REPO / "artifacts" / "bench" / "BENCH_codec_h100.json"
    t = json.loads(path.read_text())
    assert t["kind"] == tbench.KIND and t["interpret"] is False and t["quick"] is False
    assert t["n_bytes"] == 4 * BUCKET_ELEMENTS
    dm = t["device_model"]
    assert "H100" in dm["card"] and " W" in dm["card"]
    assert dm["mem_bw"] == taddest.H100_MEM_BW
    assert dm["launch_overhead"] == taddest.H100_LAUNCH_OVERHEAD
    assert t["launch_probe_us"] * 1e-6 == pytest.approx(taddest.H100_LAUNCH_OVERHEAD, rel=0.25)
    assert set(tbench.kernel_codec_names()) <= set(t["codecs"])
    table = tcodec.load_codec_table(str(path))
    for spec, kind in (("int8", "int8"), ("ternary", "ternary"), ("topk:100", "topk")):
        c = dataclasses.replace(tcodec.get_codec(spec, table=table), mem_bw=taddest.H100_MEM_BW,
                                launch_overhead=taddest.H100_LAUNCH_OVERHEAD)
        assert c.encode_passes == t["codecs"][kind]["encode_passes"]
        assert c.decode_passes == t["codecs"][kind]["decode_passes"]
        # one pass over a 2.26 GB bucket at 3.35 TB/s is 1.35 ms
        assert c.encode_seconds(4.0 * BUCKET_ELEMENTS) == pytest.approx(
            c.encode_passes * 2 * 4.0 * BUCKET_ELEMENTS / 3.35e12)


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def test_from_layer_profile_matches():
    args = ("m", [4.0, 8.0, 16.0], [0.1, 0.2, 0.3], 1.5)
    assert dataclasses.asdict(ttimeline.from_layer_profile(*args)) == dataclasses.asdict(
        jtimeline.from_layer_profile(*args))
    assert ttimeline.BWD_FRACTION == jtimeline.BWD_FRACTION


def test_timeline_measure_matches_on_the_smoke_stablelm():
    cj, ct = jget("stablelm-3b").smoke(), tget("stablelm-3b").smoke()
    japi = jmodel(cj)
    params_j = japi.init(jax.random.key(0))
    # the top level in the JAX tree's own key order, as JAX's measure walks it
    params_t = params_from_jax({k: jax_tree_to_numpy(v) for k, v in params_j.items()}, ct)
    assert list(params_t) == list(params_j)
    assert [l[:2] for l in tbreakdown(params_t, ct)] == [l[:2] for l in jbreakdown(params_j, cj)]
    batch = JData(cj, JSHAPES["train_4k"].smoke(), seed=0).batch(0)
    tj = jtimeline.measure(japi, cj, {k: jax.numpy.asarray(v) for k, v in batch.items()},
                           repeats=1)
    tt = ttimeline.measure(tmodel(ct), ct, {k: torch.from_numpy(v) for k, v in batch.items()},
                           repeats=1, params=params_t)
    assert tt.name == tj.name == "stablelm-3b-smoke-measured"
    assert tt.sizes == tj.sizes
    assert tt.total_bytes == 4 * sum(int(p.numel()) for p in tree_leaves(params_t))
    for tl in (tt, tj):
        assert all(a < b for a, b in zip(tl.ready_times, tl.ready_times[1:]))
        assert 0 < tl.t_back < tl.t_batch
        assert tl.t_back == pytest.approx(tl.t_batch * ttimeline.BWD_FRACTION)
    # the params' leaves are left as they were found
    assert not any(p.requires_grad for p in tree_leaves(params_t))


def test_timeline_measure_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ct = tget("stablelm-3b").smoke()
    with pytest.raises(RuntimeError):
        ttimeline.measure(tmodel(ct), ct, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})
