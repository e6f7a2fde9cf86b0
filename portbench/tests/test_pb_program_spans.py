"""The six metrics that read the program's own spans and counters
(``portbench/harness/program_spans.py``), on the CPU at a smoke size."""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from portbench.counts import buckets
from portbench.harness import program_spans, spec

READERS = ("forward_ms.train", "backward_ms.train", "recompute_ms.train", "attn_bwd_ms.train",
           "sync_copy_ms.train", "sync_wire_mib.train")
FUSION_MB = 0.25
STEPS = 2


def _ctx():
    return SimpleNamespace(trace=SimpleNamespace(steps=STEPS))


def _record_steps(n, remat=True, use_pallas="always", mode="explicit", record=True):
    """``n`` stablelm-3b smoke steps at S 128, recorded by the program's tracer."""
    from repro_torch.configs import CommConfig, InputShape, get_config
    from repro_torch.data.pipeline import SyntheticLM, device_put_batch
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizers import get_optimizer
    from repro_torch.optim.schedule import get_schedule
    from repro_torch.parallel.collectives import InProcessWorld
    from repro_torch.utils import trace
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("stablelm-3b").smoke().replace(remat=remat, use_pallas=use_pallas)
    api, opt = get_model(cfg), get_optimizer("adamw")
    params = api.init(torch.Generator().manual_seed(0))
    state = opt.init(params)
    step = make_train_step(api, opt, InProcessWorld(1),
                           CommConfig(mode=mode, compression="int8", fusion_buffer_mb=FUSION_MB),
                           get_schedule("constant", 3e-4, 0, 0), clip_norm=1.0)
    data = SyntheticLM(cfg, InputShape("t", 128, 2, "train"), seed=0)
    trace.clear()
    with trace.recording() if record else contextlib.nullcontext():
        for i in range(n):
            params, state, _ = step(params, state, device_put_batch(data.batch(i), "cpu"))
    return [t.numel() for t in tree_leaves(params)]


@pytest.fixture(scope="module")
def smoke_run():
    from repro_torch.utils import trace

    sizes = _record_steps(STEPS + 1)
    return sizes, trace.records()


@pytest.fixture
def smoke_sizes(smoke_run):
    """The smoke run's leaf sizes, its records put back in the tracer."""
    from repro_torch.utils import trace

    trace.clear()
    trace._records.extend(smoke_run[1])
    return smoke_run[0]


def test_the_helper_keeps_the_first_steps_and_drops_the_last(smoke_sizes):
    from repro_torch.utils import trace

    every = sorted((r for r in trace.records() if r.name == "step"), key=lambda r: r.id)
    assert len(every) == STEPS + 1
    kept, inside = program_spans.steps(_ctx())
    assert kept == every[:STEPS]
    assert inside and {r.step for r in inside} == {r.id for r in kept}
    assert not any(r.step == every[-1].id for r in inside)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_smoke_run(smoke_sizes, name):
    value = spec.reader(name)(_ctx())
    assert isinstance(value, float) and value > 0


def test_the_wire_bytes_are_the_frozen_plans_rows(smoke_sizes):
    rows = sum(r for _, r in buckets.bucket_elements(smoke_sizes, 4, FUSION_MB))
    assert spec.reader("sync_wire_mib.train")(_ctx()) == rows * 260 / 2 ** 20


@pytest.mark.parametrize("name, run", [
    ("forward_ms.train", dict(record=False)),
    ("backward_ms.train", dict(record=False)),
    ("recompute_ms.train", dict(remat=False)),
    ("attn_bwd_ms.train", dict(use_pallas="never")),
    ("sync_copy_ms.train", dict(mode="auto")),
    ("sync_wire_mib.train", dict(mode="auto")),
])
def test_a_reader_reads_nothing_where_its_span_is_absent(name, run):
    _record_steps(STEPS + 1, **run)
    assert spec.reader(name)(_ctx()) is None


def test_too_few_steps_read_nothing():
    _record_steps(1)
    assert program_spans.steps(_ctx()) is None
    assert all(spec.reader(name)(_ctx()) is None for name in READERS)
