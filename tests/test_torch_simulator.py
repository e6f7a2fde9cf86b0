"""The port's own copy of the what-if simulator against the JAX package's:
``cnn_profiles``, ``timeline.from_cnn``, ``fuse_buckets`` and ``simulate``
over a grid of the paper's three timelines, worker counts, bandwidths,
transports, schedulers and codecs, with one case each for the fault, fabric,
lossy-link and jitter axes and one ``simulate_contention`` call, so that
every copied module (``events``, ``schedule``, ``transport``,
``network_model``, ``fabric``, ``faults``, ``simulator``) runs.

Both packages run the same path (the columnar fast path unless
``REPRO_SIM_FASTPATH=0``), and every ``SimResult`` field agrees at 1e-9
relative.  Last, ``examples/torch_measured_whatif.py`` on the CPU at a
tiny width: its tables are the reference simulator's at the time it
measured."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.base import CommConfig as JComm
from repro.core import cnn_profiles as jprof
from repro.core import simulator as jsim
from repro.core import timeline as jtl
from repro.core.transport import GBPS as JGBPS
from repro_torch.configs import CommConfig
from repro_torch.core import cnn_profiles as tprof
from repro_torch.core import simulator as tsim
from repro_torch.core import timeline as ttl
from repro_torch.core.transport import GBPS

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))                                   # examples/

from examples import torch_measured_whatif as whatif  # noqa: E402

NAMES = ["vgg16", "resnet50", "resnet101"]


def _same_value(a, b, where):
    if isinstance(a, float) and isinstance(b, float):
        if math.isfinite(b) and b != 0.0:
            assert abs(a - b) <= 1e-9 * abs(b), (where, a, b)
        else:
            assert a == b, (where, a, b)
    else:
        assert a == b, (where, a, b)


def _same_result(rt, rj):
    assert type(rt).__name__ == type(rj).__name__ == "SimResult"
    for f in dataclasses.fields(rj):
        a, b = getattr(rt, f.name), getattr(rj, f.name)
        if f.name == "buckets":
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                for g in dataclasses.fields(y):
                    _same_value(getattr(x, g.name), getattr(y, g.name), f"bucket {i}.{g.name}")
        else:
            _same_value(a, b, f.name)


@pytest.mark.parametrize("name", NAMES)
def test_profiles_and_from_cnn_are_the_reference(name):
    pt, pj = tprof.get_profile(name), jprof.get_profile(name)
    assert [dataclasses.astuple(l) for l in pt.layers] == [dataclasses.astuple(l) for l in pj.layers]
    assert (pt.name, pt.t_batch_v100, pt.total_params, pt.total_bytes, pt.size_mib) == \
        (pj.name, pj.t_batch_v100, pj.total_params, pj.total_bytes, pj.size_mib)
    assert GBPS == JGBPS
    for t_batch in (None, 0.0123, pj.t_batch_v100 / 8):
        for grad_bytes in (4, 2):
            a = ttl.from_cnn(name, t_batch=t_batch, grad_dtype_bytes=grad_bytes)
            b = jtl.from_cnn(name, t_batch=t_batch, grad_dtype_bytes=grad_bytes)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)       # bit for bit
    for fusion_mb, timeout_ms in ((64.0, 5.0), (25.0, 1.0)):
        bt = tsim.fuse_buckets(ttl.from_cnn(name), CommConfig(fusion_buffer_mb=fusion_mb,
                                                              timeout_ms=timeout_ms))
        bj = jsim.fuse_buckets(jtl.from_cnn(name), JComm(fusion_buffer_mb=fusion_mb,
                                                         timeout_ms=timeout_ms))
        assert [dataclasses.astuple(b) for b in bt] == [dataclasses.astuple(b) for b in bj]


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("scheduler", ["fifo", "priority", "chunked"])
@pytest.mark.parametrize("transport", ["ideal", "horovod_tcp"])
@pytest.mark.parametrize("name", NAMES)
def test_simulate_grid_matches_reference(name, transport, scheduler, codec):
    # the V100's batch time and an eighth of it (a card that computes 8x faster)
    for t_batch in (None, jprof.get_profile(name).t_batch_v100 / 8):
        tl_t, tl_j = ttl.from_cnn(name, t_batch=t_batch), jtl.from_cnn(name, t_batch=t_batch)
        for n_workers in (8, 64):
            for gbps in (10, 25, 100):
                kw = dict(n_workers=n_workers, bandwidth=gbps * GBPS, transport=transport,
                          scheduler=scheduler, codec=codec)
                _same_result(tsim.simulate(tl_t, **kw), jsim.simulate(tl_j, **kw))


@pytest.mark.parametrize("case", [
    {"fault_model": "slowdown:2:0.5", "churn_rate": 1.5, "worker_bw_skew": 0.3, "fault_seed": 4},
    {"fabric": "clos", "oversubscription": 4.0},
    {"link_profile": "wan:loss=0.01,rtt=20"},
    {"jitter": 2e-3, "jitter_seed": 5},
    {"n_rails": 2, "rail_policy": "size-balanced", "scheduler": "chunked"},
    {"codec": "size-adaptive:topk:0.01", "error_feedback": True, "scheduler": "priority"},
    {"topology": "hierarchical", "n_pods": 2, "dcn_bandwidth": 5 * GBPS},
], ids=["faults", "fabric", "link_profile", "jitter", "rails", "size_adaptive_ef", "pods"])
@pytest.mark.parametrize("fastpath", ["1", "0"], ids=["columnar", "tuple"])
def test_simulate_axes_match_reference(case, fastpath, monkeypatch):
    monkeypatch.setenv("REPRO_SIM_FASTPATH", fastpath)
    moved = False
    for name in NAMES:
        base = dict(n_workers=64, bandwidth=25 * GBPS, transport="horovod_tcp")
        got = tsim.simulate(ttl.from_cnn(name, t_batch=0.03), **base, **case)
        _same_result(got, jsim.simulate(jtl.from_cnn(name, t_batch=0.03), **base, **case))
        plain = tsim.simulate(ttl.from_cnn(name, t_batch=0.03), **base)
        moved |= (got.t_sync, got.codec_compute_s) != (plain.t_sync, plain.codec_compute_s)
    assert moved, "the axis changed no result: its module did not run"


@pytest.mark.parametrize("scheduler", ["fifo", "priority"])
def test_simulate_contention_matches_reference(scheduler):
    kw = dict(n_workers=16, bandwidth=25 * GBPS, transport="horovod_tcp", scheduler=scheduler,
              jitter=1e-3, codec="int8")
    rt = tsim.simulate_contention([ttl.from_cnn(n) for n in NAMES], **kw)
    rj = jsim.simulate_contention([jtl.from_cnn(n) for n in NAMES], **kw)
    assert len(rt) == len(rj) == 3
    for a, b in zip(rt, rj):
        _same_result(a, b)


TINY = ["--device", "cpu", "--width", "0.0625", "--batch", "2", "--classes", "10",
        "--repeats", "1", "--warmup", "1"]


def test_measure_step_times_a_cpu_step():
    t = whatif.measure_step("resnet50", 0.0625, 2, repeats=2, device="cpu", num_classes=10,
                            warmup=1, hw=64)
    assert 0.0 < t < 60.0


@pytest.mark.parametrize("model", ["vgg16", "resnet50"])
def test_example_main_prints_the_reference_tables(model, capsys):
    res = whatif.main(TINY + ["--model", model])
    out = capsys.readouterr().out
    assert "scaling factor" in out and "scheduler x bandwidth" in out
    assert res["device"] == "cpu" and "t_batch_tf32" not in res
    for label, t_batch in (("paper-V100", None), ("this-device", res["t_batch_f32"])):
        tl = jtl.from_cnn(model, t_batch=t_batch)
        for bw in (10, 25, 100):
            want = jsim.simulate(tl, n_workers=64, bandwidth=bw * JGBPS, transport="ideal")
            assert res["scaling"][label][bw] == want.scaling_factor
            for sched in ("fifo", "priority", "chunked"):
                want = jsim.simulate(tl, n_workers=64, bandwidth=bw * JGBPS,
                                     transport="horovod_tcp", scheduler=sched)
                assert res["schedulers"][label][sched][bw] == want.scaling_factor


def test_example_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        whatif.main(["--width", "0.0625"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        whatif.measure_step("vgg16", 0.0625, 2, repeats=1, device="cuda")
