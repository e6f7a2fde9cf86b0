"""The program's tracer (``repro_torch.utils.trace``): what a training step
records, where each span hangs, its counters, and its clock against
``torch.profiler``'s."""
import importlib.util
import sys
import threading
from pathlib import Path

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import CommConfig, InputShape, get_config
from repro_torch.data.pipeline import SyntheticLM, device_put_batch
from repro_torch.kernels import ops as kops
from repro_torch.launch.train import make_train_step
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.optim.schedule import get_schedule
from repro_torch.parallel.collectives import InProcessWorld
from repro_torch.parallel.grad_sync import make_plan
from repro_torch.utils import trace

REPO = Path(__file__).resolve().parents[1]
PHASES = ("sync.pack", "sync.encode", "sync.gather", "sync.decode", "sync.add", "sync.unpack")
FUSION_MB = 0.25            # several buckets at the smoke size


def _step_profile_module():
    spec = importlib.util.spec_from_file_location("torch_step_profile",
                                                  REPO / "benchmarks" / "torch_step_profile.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    trace.reset_counts()
    yield
    trace.clear()


def _smoke(remat=True, use_pallas="always", mode="explicit"):
    """(step, params, opt state, batch, plan) of a stablelm-3b smoke step at
    S 128, where attention takes ``_FlashKernelFn`` (the kernel's plain
    version on the CPU)."""
    cfg = get_config("stablelm-3b").smoke().replace(remat=remat, use_pallas=use_pallas)
    api, opt = get_model(cfg), get_optimizer("adamw")
    params = api.init(torch.Generator().manual_seed(0))
    comm = CommConfig(mode=mode, compression="int8", fusion_buffer_mb=FUSION_MB)
    step = make_train_step(api, opt, InProcessWorld(1), comm, get_schedule("constant", 3e-4, 0, 0),
                           clip_norm=1.0)
    batch = device_put_batch(SyntheticLM(cfg, InputShape("t", 128, 2, "train"), seed=0).batch(0),
                             "cpu")
    return step, params, opt.init(params), batch, make_plan(params, FUSION_MB)[0]


def test_nothing_recording_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    step, params, state, batch, _ = _smoke()
    assert not trace.is_recording() and trace.span("step.forward", a=1) is trace.NULL
    step(params, state, batch)
    assert trace.records() == [] and opened == []
    assert trace.counts()["sync.bytes_packed"] > 0          # counters always count


def test_the_profiler_switches_recording_on():
    """The flag the tracer reads is the one ``torch.profiler`` sets."""
    assert autograd_profiler._is_profiler_enabled is False and not trace.is_recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True and trace.is_recording()
    assert not trace.is_recording()
    with trace.recording():
        assert trace.is_recording()
    assert not trace.is_recording()


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_a_step_records_the_tree_of_spans(how):
    step, params, state, batch, plan = _smoke()
    ctx = trace.recording() if how == "recording" else profile(activities=[ProfilerActivity.CPU])
    with ctx:
        step(params, state, batch)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    named = lambda name: [r for r in recs if r.name == name]  # noqa: E731
    (top,) = named("step")
    assert top.parent is None and top.attrs["index"] == 0
    assert sorted(r.name for r in recs if r.parent == top.id) == sorted(
        ["step.forward", "step.backward", "step.sync", "step.clip", "step.update"])
    assert all(r.step == top.id for r in recs) and not trace._open
    (backward,) = named("step.backward")
    (sync,) = named("step.sync")
    layers = get_config("stablelm-3b").smoke().num_layers
    recompute, attn = named("layer.recompute"), named("attn.backward")
    assert len(recompute) == len(attn) == layers
    assert all(r.parent == backward.id for r in recompute + attn)
    assert sorted(r.attrs["layer"] for r in recompute) == list(range(layers))
    assert plan.n_buckets > 2
    for name in PHASES:
        spans = named(name)
        assert all(r.parent == sync.id for r in spans)
        assert sorted(r.attrs["bucket"] for r in spans) == list(range(plan.n_buckets)), name
    for r in recs:
        assert r.start_ns <= r.end_ns and r.device_ms is None and r.ms == r.host_ms
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_the_step_holds_its_counters_change():
    step, params, state, batch, plan = _smoke()
    step(params, state, batch)                       # counted, not recorded
    with trace.recording():
        step(params, state, batch)
    (top,) = [r for r in trace.records() if r.name == "step"]
    rows = sum(kops.quantize_int8(torch.zeros(n))[0].shape[0] for n in plan.bucket_sizes)
    assert top.attrs["counts"]["sync.bytes_packed"] == 4 * sum(plan.bucket_sizes)
    assert top.attrs["counts"]["sync.bytes_gathered"] == rows * (256 + 4)
    assert trace.counts()["sync.bytes_packed"] == 2 * 4 * sum(plan.bucket_sizes)


def test_each_span_brackets_its_profiler_range():
    step, params, state, batch, _ = _smoke()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, state, batch)
    recs = trace.records()
    check = _step_profile_module().clock_check(prof, recs)
    assert check["unmatched"] == 0 and check["range_ns"] <= 1_000_000, check


def test_a_span_on_another_thread_takes_the_open_span_as_parent():
    got = {}

    def worker():
        with trace.span("attn.backward") as rec:
            got["rec"] = rec
            with trace.span("inner") as inner:
                got["inner"] = inner

    with trace.recording():
        with trace.span("step"):
            with trace.span("step.backward") as backward:
                t = threading.Thread(target=worker)
                t.start()
                t.join(timeout=30)
    assert not t.is_alive()
    assert got["rec"].parent == backward.id and got["inner"].parent == got["rec"].id
    assert got["rec"].step == backward.step is not None


def test_threads_neither_lose_counts_nor_records():
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(200):
                trace.count("stress")
                with trace.span("stress.span"):
                    pass

        with trace.recording():
            with trace.span("step") as top:
                threads = [threading.Thread(target=worker) for _ in range(16)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert trace.counts()["stress"] == 16 * 200 and top.attrs["counts"] == {"stress": 3200}
    spans = [r for r in trace.records() if r.name == "stress.span"]
    assert len(spans) == 3200 and len({r.id for r in spans}) == 3200
    assert all(r.step == top.id for r in spans) and not trace._open


def test_a_span_closes_when_the_code_inside_raises():
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("boom"):
                    raise ValueError
        with trace.span("after") as after:
            pass
    recs = {r.name: r for r in trace.records()}
    assert set(recs) == {"outer", "boom", "after"} and not trace._open
    assert recs["boom"].end_ns >= recs["boom"].start_ns > 0 and after.parent is None


def test_self_time_is_less_the_children():
    recs = [trace.Record("a", 0, None, 0, {}, 0, device_ms=10.0),
            trace.Record("b", 1, 0, 0, {}, 0, device_ms=3.0),
            trace.Record("c", 2, 0, 0, {}, 0, device_ms=4.0),
            trace.Record("d", 3, 1, 0, {}, 0, device_ms=1.0)]
    assert [own for _, own in trace.self_ms(recs)] == [3.0, 2.0, 4.0, 1.0]


def test_the_codec_counts_as_before():
    """quantize -> dequantize -> fused add: on CPU tensors the plain versions,
    no launch; the registry keeps the launch and route names apart."""
    q, s, n = kops.quantize_int8(torch.randn(1000))
    kops.fused_add(kops.dequantize_int8(q, s, n).reshape(1, -1))
    assert trace.counts("launch") == {} and trace.counts("route") == {}
    trace.count("launch.quantize_int8_2d")
    trace.count("launch.wkv", 2)
    trace.count("route.wkv_chunked")
    assert trace.counts("launch") == {"quantize_int8_2d": 1, "wkv": 2}
    assert trace.counts("route")["wkv_chunked"] == 1 and trace.counts("launch")["ssm_scan"] == 0
    trace.reset_counts("launch")
    assert trace.counts("launch") == {} and trace.counts() == {"route.wkv_chunked": 1}
