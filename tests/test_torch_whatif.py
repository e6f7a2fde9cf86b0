"""The port's analytic FLOP model, ``timeline.from_transformer``, the figure
builders of ``core/whatif.py`` and ``h100_whatif`` against the JAX
package's.

- ``flops``: every count of every architecture the reference registers (all
  ten are the port's own configs, each equal to the reference's rebuilt
  field by field as the port's ``ModelConfig``; the MoE, MLA,
  encoder-decoder and VLM branches run) equal the reference's: integers
  exactly, FLOPs within 1e-12;
- ``from_transformer`` at the H100's rate against the reference's at the
  same rate, within 1e-12;
- ``h100_whatif`` against the reference's ``simulate`` fed the reference's
  ``from_transformer`` at the same constants, every ``SimResult`` field
  within 1e-9, on one node (ring) and across nodes (hierarchical);
- every ``fig*`` builder, ``transmission_table`` and the one-cell what-ifs
  equal the reference's;
- ``examples/torch_quickstart.py`` and ``examples/torch_whatif_h100.py``.
"""
import contextlib
import dataclasses
import io
import math
import sys
from pathlib import Path

import pytest

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs.archs import ALL_ARCHS as JALL_ARCHS
from repro.core import flops as jflops
from repro.core import simulator as jsim
from repro.core import timeline as jtl
from repro.core import whatif as jwhatif
from repro.core.addest import AddEst as JAddEst
from repro.core.transport import GBPS as JGBPS
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config
from repro_torch.configs.archs import ALL_ARCHS
from repro_torch.core import flops as tflops
from repro_torch.core import timeline as ttl
from repro_torch.core import whatif as twhatif
from repro_torch.core.addest import AddEst

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))                                   # examples/

from examples import torch_quickstart, torch_whatif_h100  # noqa: E402

H100_FLOPS = 989e12
SHAPES = [("train_4k_b1", 4096, 1, "train"), ("train_4k", 4096, 256, "train"),
          ("prefill_32k", 32768, 32, "prefill"), ("decode_32k", 32768, 128, "decode")]


def _port_config(jcfg):
    """A reference ``ModelConfig`` rebuilt field by field as the port's."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            cls = getattr(tbase, type(v).__name__)
            v = cls(**{g.name: getattr(v, g.name) for g in dataclasses.fields(v)})
        kw[f.name] = v
    return tbase.ModelConfig(**kw)


def _close(a, b, rel, where):
    if isinstance(a, int) and isinstance(b, int):
        assert a == b, (where, a, b)
    else:
        assert abs(a - b) <= rel * max(abs(b), 1e-300) or a == b, (where, a, b)


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def test_the_port_configs_are_the_reference_configs():
    for arch in ALL_ARCHS:
        assert get_config(arch) == _port_config(jget_config(arch)), arch


@pytest.mark.parametrize("arch", JALL_ARCHS)
def test_flops_equal_the_reference(arch):
    jcfg = jget_config(arch)
    cfg = get_config(arch)                       # every reference arch is registered in the port
    assert cfg == _port_config(jcfg)
    assert tflops.param_count(cfg) == jflops.param_count(jcfg)
    assert tflops.active_param_count(cfg) == jflops.active_param_count(jcfg)
    assert tflops._decoder_layer_kinds(cfg) == jflops._decoder_layer_kinds(jcfg)
    for fn in ("attn_params", "mlp_params", "norm_params"):
        assert getattr(tflops, fn)(cfg) == getattr(jflops, fn)(jcfg), fn
    if cfg.moe is not None:
        for active in (False, True):
            assert tflops.moe_params(cfg, active) == jflops.moe_params(jcfg, active)
    if cfg.ssm is not None and cfg.family == "hybrid":
        assert tflops.mamba_params(cfg) == jflops.mamba_params(jcfg)
    if cfg.family == "ssm":
        assert tflops.rwkv_params(cfg) == jflops.rwkv_params(jcfg)
    for s in SHAPES:
        shape, jshape = tbase.InputShape(*s), jbase.InputShape(*s)
        ours, ref = tflops.layer_breakdown(cfg, shape), jflops.layer_breakdown(jcfg, jshape)
        assert len(ours) == len(ref)
        for (n, p, f), (jn, jp, jf) in zip(ours, ref):
            assert (n, p) == (jn, jp)
            _close(f, jf, 1e-12, (arch, s[0], n))
        _close(tflops.model_flops(cfg, shape), jflops.model_flops(jcfg, jshape), 1e-12, arch)
        _close(tflops.total_fwd_flops(cfg, shape), jflops.total_fwd_flops(jcfg, jshape),
               1e-12, arch)


def test_the_rebuilt_configs_reach_every_branch():
    families = {jget_config(a).family for a in JALL_ARCHS}
    assert {"dense", "moe", "hybrid", "ssm", "encdec", "vlm"} <= families
    assert any(jget_config(a).attention == "mla" for a in JALL_ARCHS)


# ---------------------------------------------------------------------------
# from_transformer
# ---------------------------------------------------------------------------

def test_from_transformer_defaults_to_the_h100_rate():
    assert ttl.H100_BF16_FLOPS == H100_FLOPS
    cfg, shape = get_config("stablelm-3b"), tbase.InputShape(*SHAPES[0])
    assert ttl.from_transformer(cfg, shape) == \
        ttl.from_transformer(cfg, shape, chip_flops=H100_FLOPS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
@pytest.mark.parametrize("mfu,mp", [(0.4, 1), (0.048, 1), (0.4, 4)])
def test_from_transformer_equals_the_reference(arch, mfu, mp):
    for s in SHAPES[:2]:
        ours = ttl.from_transformer(get_config(arch), tbase.InputShape(*s), mfu=mfu,
                                    n_chips_compute=mp)
        ref = jtl.from_transformer(jget_config(arch), jbase.InputShape(*s), mfu=mfu,
                                   chip_flops=H100_FLOPS, n_chips_compute=mp)
        assert ours.name == ref.name and ours.sizes == ref.sizes
        assert len(ours.ready_times) == len(ref.ready_times)
        for a, b in zip(ours.ready_times, ref.ready_times):
            _close(a, b, 1e-12, (arch, s[0]))
        _close(ours.t_back, ref.t_back, 1e-12, arch)
        _close(ours.t_batch, ref.t_batch, 1e-12, arch)


# ---------------------------------------------------------------------------
# h100_whatif
# ---------------------------------------------------------------------------

def _same_value(a, b, where):
    if isinstance(a, float) and isinstance(b, float) and math.isfinite(b) and b != 0.0:
        assert abs(a - b) <= 1e-9 * abs(b), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _same_result(rt, rj):
    for f in dataclasses.fields(rj):
        a, b = getattr(rt, f.name), getattr(rj, f.name)
        if f.name == "buckets":
            assert len(a) == len(b)
            for i, (x, y) in enumerate(zip(a, b)):
                for g in dataclasses.fields(y):
                    _same_value(getattr(x, g.name), getattr(y, g.name), f"bucket {i}.{g.name}")
        else:
            _same_value(a, b, f.name)


def _reference_h100(arch, s, *, n_gpus, ib_gbps=400.0, mfu=0.4, ratio=1.0, dp=None,
                    transport="ideal"):
    """The reference's building blocks at the H100 constants."""
    dp = dp or n_gpus
    mp = max(n_gpus // dp, 1)
    tl = jtl.from_transformer(jget_config(arch), jbase.InputShape(*s), mfu=mfu,
                              chip_flops=H100_FLOPS, n_chips_compute=mp, grad_dtype_bytes=2)
    tl = jtl.GradTimeline(tl.name, tl.ready_times, tuple(x / mp for x in tl.sizes),
                          tl.t_back, tl.t_batch)
    return jsim.simulate(tl, n_workers=dp, bandwidth=3600.0 * JGBPS, transport=transport,
                         addest=JAddEst.from_bandwidth(3.35e12, 2.3e-6),
                         compression_ratio=ratio,
                         topology="hierarchical" if n_gpus > 8 else "ring",
                         n_pods=max(n_gpus // 8, 1), dcn_bandwidth=ib_gbps * JGBPS)


@pytest.mark.parametrize("case", [
    dict(arch="stablelm-3b", n_gpus=8),
    dict(arch="stablelm-3b", n_gpus=64),
    dict(arch="stablelm-3b", n_gpus=256, ib_gbps=100.0),
    dict(arch="stablelm-3b", n_gpus=64, mfu=0.048, ratio=4.0),
    dict(arch="stablelm-3b", n_gpus=64, dp=16),
    dict(arch="rwkv6-1.6b", n_gpus=64, transport="horovod_tcp"),
    dict(arch="jamba-v0.1-52b", n_gpus=256, ratio=4.0),
], ids=lambda c: "-".join(f"{v}" for v in c.values()))
def test_h100_whatif_equals_the_reference_building_blocks(case):
    case = dict(case)
    arch = case.pop("arch")
    ref = _reference_h100(arch, SHAPES[0], **case)
    kw = {"n_gpus": case["n_gpus"], "ib_gbps": case.get("ib_gbps", 400.0),
          "mfu": case.get("mfu", 0.4), "compression_ratio": case.get("ratio", 1.0),
          "data_parallel": case.get("dp"), "transport": case.get("transport", "ideal")}
    ours = twhatif.h100_whatif(get_config(arch), tbase.InputShape(*SHAPES[0]), **kw)
    _same_result(ours, ref)
    assert 0.0 < ours.scaling_factor <= 1.0


def _hand_layout_h100(arch, s, *, n_gpus, dp, ib_gbps=400.0):
    """A model-parallel group of n_gpus / dp >= 8 GPUs fills one node or
    more, so the all-reduce has one rank in each of dp node groups: dp
    workers, dp pods of one GPU, the cross-pod stage on InfiniBand."""
    mp = n_gpus // dp
    tl = jtl.from_transformer(jget_config(arch), jbase.InputShape(*s), mfu=0.4,
                              chip_flops=H100_FLOPS, n_chips_compute=mp, grad_dtype_bytes=2)
    tl = jtl.GradTimeline(tl.name, tl.ready_times, tuple(x / mp for x in tl.sizes),
                          tl.t_back, tl.t_batch)
    return jsim.simulate(tl, n_workers=dp, bandwidth=3600.0 * JGBPS, transport="ideal",
                         addest=JAddEst.from_bandwidth(3.35e12, 2.3e-6),
                         topology="hierarchical", n_pods=dp, dcn_bandwidth=ib_gbps * JGBPS)


@pytest.mark.parametrize("n_gpus,dp", [(64, 4), (256, 16), (64, 8)])
def test_h100_whatif_model_parallel_across_nodes_sees_dp_ranks(n_gpus, dp):
    """mp = n_gpus / dp >= gpus_per_node: each dp rank is a node group of
    its own, as the reference's tpu_whatif lays out n_workers = dp x n_pods
    (mp 16 with dp 4 priced 0.6389 against this layout's 0.7184 before)."""
    shape = tbase.InputShape(*SHAPES[0])
    ours = twhatif.h100_whatif(get_config("command-r-35b"), shape, n_gpus=n_gpus,
                               data_parallel=dp)
    _same_result(ours, _hand_layout_h100("command-r-35b", SHAPES[0], n_gpus=n_gpus, dp=dp))
    assert 0.0 < ours.scaling_factor <= 1.0


def test_h100_whatif_defaults_are_the_data_sheet_platform():
    cfg, shape = get_config("stablelm-3b"), tbase.InputShape(*SHAPES[0])
    base = twhatif.h100_whatif(cfg, shape)
    same = twhatif.h100_whatif(cfg, shape, n_gpus=64, gpus_per_node=8, nvlink_gbps=3600.0,
                               ib_gbps=400.0, mfu=0.4, addest=AddEst.h100())
    assert base == same


def test_h100_whatif_near_linear_on_nvlink():
    """Inside one node NVLink keeps the sync of the port's dense LLMs
    near-invisible (the paper's conclusion, asked of an H100 node)."""
    shape = tbase.InputShape(*SHAPES[0])
    for arch in ("stablelm-3b", "rwkv6-1.6b"):
        r = twhatif.h100_whatif(get_config(arch), shape, n_gpus=8)
        assert r.scaling_factor > 0.95, (arch, r.scaling_factor)


def test_h100_whatif_more_nodes_never_cheaper():
    cfg, shape = get_config("stablelm-3b"), tbase.InputShape(*SHAPES[0])
    for ib in (100.0, 400.0):
        runs = [twhatif.h100_whatif(cfg, shape, n_gpus=n, ib_gbps=ib) for n in (8, 64, 256)]
        for a, b in zip(runs, runs[1:]):
            assert b.t_overhead >= a.t_overhead - 1e-9
            assert b.scaling_factor <= a.scaling_factor + 1e-12


def test_h100_whatif_compression_never_worse():
    shape = tbase.InputShape(*SHAPES[0])
    for arch in ALL_ARCHS:
        for n in (8, 64, 256):
            plain = twhatif.h100_whatif(get_config(arch), shape, n_gpus=n, ib_gbps=100.0)
            comp = twhatif.h100_whatif(get_config(arch), shape, n_gpus=n, ib_gbps=100.0,
                                       compression_ratio=4.0)
            assert comp.scaling_factor >= plain.scaling_factor - 1e-9, (arch, n)


def test_h100_whatif_takes_a_measured_addest():
    cfg, shape = get_config("stablelm-3b"), tbase.InputShape(*SHAPES[0])
    slow = AddEst.from_bandwidth(1e11, 1e-4)
    r = twhatif.h100_whatif(cfg, shape, n_gpus=64, addest=slow)
    assert r.t_sync > twhatif.h100_whatif(cfg, shape, n_gpus=64).t_sync


# ---------------------------------------------------------------------------
# figure builders
# ---------------------------------------------------------------------------

FIGS = ["fig1_scaling_vs_servers", "fig3_scaling_vs_bandwidth", "fig4_utilization",
        "fig6_sim_vs_measured", "fig7_scaling_vs_workers", "fig8_compression",
        "fig9_other_systems", "fig10_schedulers", "fig11_multirail", "fig12_stragglers",
        "fig13_compression_regimes", "fig14_unreliable_workers",
        "fig15_fabric_oversubscription", "fig16_wan_loss_regimes"]


def test_every_figure_builder_is_ported():
    ref = {n for n in dir(jwhatif) if n.startswith("fig")}
    assert ref == set(FIGS)
    assert twhatif.PAPER_MODELS == jwhatif.PAPER_MODELS
    assert twhatif.GPUS_PER_SERVER == jwhatif.GPUS_PER_SERVER
    assert not hasattr(twhatif, "tpu_whatif")


@pytest.mark.parametrize("fig", FIGS)
def test_figure_builder_equals_the_reference(fig):
    ours, ref = getattr(twhatif, fig)(), getattr(jwhatif, fig)()
    assert len(ours) == len(ref) > 0
    assert ours == ref


@pytest.mark.parametrize("fig,kw", [
    ("fig3_scaling_vs_bandwidth", dict(model="vgg16", servers=(2,), bws=(5, 40))),
    ("fig8_compression", dict(models=("resnet50",), ratios=(3.0,), bws=(10,))),
    ("fig13_compression_regimes", dict(models=("vgg16",), bws=(25,), codecs=("int8",))),
])
def test_figure_builder_with_a_custom_sweep_equals_the_reference(fig, kw):
    assert getattr(twhatif, fig)(**kw) == getattr(jwhatif, fig)(**kw)


@pytest.mark.parametrize("bw", [10.0, 100.0])
def test_transmission_table_equals_the_reference(bw):
    assert twhatif.transmission_table(bw) == jwhatif.transmission_table(bw)


def test_one_cell_whatifs_equal_the_reference():
    assert twhatif.multirail_whatif() == jwhatif.multirail_whatif()
    assert twhatif.contention_whatif() == jwhatif.contention_whatif()
    assert twhatif.bytescheduler_whatif() == jwhatif.bytescheduler_whatif()
    for m in twhatif.PAPER_MODELS:
        _same_result(twhatif.sim_scaling(m, bandwidth_gbps=25.0, transport="horovod_tcp"),
                     jwhatif.sim_scaling(m, bandwidth_gbps=25.0, transport="horovod_tcp"))


# ---------------------------------------------------------------------------
# examples
# ---------------------------------------------------------------------------

def test_torch_quickstart_rows_are_the_reference_simulator():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = torch_quickstart.main()
    assert "scaling factor, 8 servers" in out.getvalue()
    assert got["transmission"] == jwhatif.transmission_table()
    for (model, bw), (meas, ideal) in got["scaling"].items():
        assert meas == jwhatif.sim_scaling(model, bandwidth_gbps=bw,
                                           transport="horovod_tcp").scaling_factor
        assert ideal == jwhatif.sim_scaling(model, bandwidth_gbps=bw,
                                            transport="ideal").scaling_factor
    for (model, r), f in got["compression"].items():
        assert f == jwhatif.sim_scaling(model, bandwidth_gbps=10, transport="ideal",
                                        compression_ratio=r).scaling_factor
    assert len(got["scaling"]) == 9 and len(got["compression"]) == 12


def test_torch_whatif_h100_table():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = torch_whatif_h100.main()
    assert "jamba-v0.1-52b" in out.getvalue()
    assert len(ALL_ARCHS) == len(JALL_ARCHS) == 10
    assert len(rows) == len(ALL_ARCHS) * 3 * 2
    assert {r["arch"] for r in rows} == set(JALL_ARCHS)
    for r in rows:
        assert 0.0 < r["scaling"] <= 1.0
        want = twhatif.h100_whatif(get_config(r["arch"]), torch_whatif_h100.TRAIN_SHAPE,
                                   n_gpus=r["n_gpus"], compression_ratio=r["ratio"])
        assert r["scaling"] == want.scaling_factor
