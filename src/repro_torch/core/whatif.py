"""Top-level what-if analysis API — one entry point per paper figure.

Each function returns plain dict/list data (the benchmark scripts print the
CSV); nothing here touches a tensor, so the analysis runs anywhere.

Counterpart of ``repro/core/whatif.py``, copied with ``repro.`` ->
``repro_torch.``; ``h100_whatif`` takes the place of its ``tpu_whatif``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.configs.base import CommConfig
from repro_torch.core.addest import AddEst
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.timeline import GradTimeline, from_cnn
from repro_torch.core.transport import GBPS, get_transport

PAPER_MODELS = ("resnet50", "resnet101", "vgg16")
GPUS_PER_SERVER = 8          # p3dn.24xlarge


def paper_timeline(model: str) -> GradTimeline:
    return from_cnn(model)


def sim_scaling(model: str, *, n_servers: int = 8, bandwidth_gbps: float = 100.0,
                transport: str = "ideal", compression_ratio: float = 1.0,
                comm: Optional[CommConfig] = None) -> SimResult:
    tl = paper_timeline(model)
    return simulate(tl, n_workers=n_servers * GPUS_PER_SERVER,
                    bandwidth=bandwidth_gbps * GBPS, transport=transport,
                    compression_ratio=compression_ratio, comm=comm,
                    addest=AddEst.v100())


# ---------------------------------------------------------------------------
# figure reproductions — thin spec builders over the experiment engine
# (repro_torch.experiments); each returns the same row dicts as the historical
# per-figure loops, sourced from engine cells.
# ---------------------------------------------------------------------------

def _grid(name: str, **overrides):
    """The registered paper grid, with any swept axis overridden.

    Defaults come from ``repro_torch.experiments.grids`` — the single source of
    truth the golden artifact is built from — so these builders cannot
    drift from the committed sweep definitions.
    """
    import dataclasses

    from repro_torch.experiments import GRIDS
    if not overrides:
        return GRIDS[name]
    # a custom sweep is not the registered grid: rename it so the engine
    # doesn't apply the grid's paper-claim validators to a partial sweep
    return dataclasses.replace(GRIDS[name], name=f"{name}-custom",
                               **overrides)


def _cells(spec) -> Dict[tuple, Dict]:
    """Run a grid and index its cells by (model, servers, bw, transport,
    ratio, topology)."""
    from repro_torch.experiments import index_cells, run_spec
    return index_cells(run_spec(spec)["cells"])



def _k(model, servers, bw, transport, ratio=1.0, topo="ring", sched="fifo",
       n_jobs=1, n_rails=1, jitter_ms=0.0, codec="none", fault_model="none",
       churn_rate=0.0, worker_bw_skew=0.0, fabric="none",
       oversubscription=1.0, link_profile="none"):
    """An ``index_cells`` key in CELL_AXES order, with trailing-axis
    defaults — figure builders only name the axes their sweep varies."""
    return (model, servers, bw, transport, ratio, topo, sched, n_jobs,
            n_rails, jitter_ms, codec, fault_model, churn_rate,
            worker_bw_skew, fabric, oversubscription, link_profile)

def fig1_scaling_vs_servers(models: Optional[Sequence[str]] = None,
                            servers: Optional[Sequence[int]] = None,
                            bandwidth_gbps: Optional[float] = None) -> List[Dict]:
    """Measured-mode scaling factors (horovod_tcp transport)."""
    spec = _grid("paper-fig1",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if servers is None else dict(n_servers=tuple(servers))),
                 **({} if bandwidth_gbps is None
                    else dict(bandwidth_gbps=(float(bandwidth_gbps),))))
    ix = _cells(spec)
    bw = spec.bandwidth_gbps[0]
    return [dict(model=m, servers=n,
                 scaling=ix[_k(m, n, bw, "horovod_tcp")]
                 ["scaling_factor"])
            for m in spec.models for n in spec.n_servers]


def fig3_scaling_vs_bandwidth(model: Optional[str] = None,
                              servers: Optional[Sequence[int]] = None,
                              bws: Optional[Sequence[float]] = None,
                              transport: Optional[str] = None) -> List[Dict]:
    spec = _grid("paper-fig3",
                 **({} if model is None else dict(models=(model,))),
                 **({} if servers is None else dict(n_servers=tuple(servers))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if transport is None else dict(transport=(transport,))))
    ix = _cells(spec)
    tr = spec.transport[0]
    return [dict(model=spec.models[0], servers=n, bandwidth_gbps=bw,
                 scaling=ix[_k(spec.models[0], n, bw, tr)]
                 ["scaling_factor"])
            for n in spec.n_servers for bw in spec.bandwidth_gbps]


def fig4_utilization(models: Optional[Sequence[str]] = None,
                     bws: Optional[Sequence[float]] = None,
                     transport: Optional[str] = None) -> List[Dict]:
    spec = _grid("paper-fig4",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if transport is None else dict(transport=(transport,))))
    ix = _cells(spec)
    n, tr = spec.n_servers[0], spec.transport[0]
    return [dict(model=m, bandwidth_gbps=bw,
                 utilization=ix[_k(m, n, bw, tr)]
                 ["network_utilization"],
                 effective_gbps=ix[_k(m, n, bw, tr)]
                 ["effective_gbps"])
            for m in spec.models for bw in spec.bandwidth_gbps]


def fig6_sim_vs_measured(models: Optional[Sequence[str]] = None,
                         bws: Optional[Sequence[float]] = None,
                         n_servers: Optional[int] = None) -> List[Dict]:
    spec = _grid("paper-fig6",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if n_servers is None
                    else dict(n_servers=(n_servers,))))
    ix = _cells(spec)
    n = spec.n_servers[0]
    return [dict(model=m, bandwidth_gbps=bw,
                 simulated_full_util=ix[_k(m, n, bw, "ideal")]["scaling_factor"],
                 measured_mode=ix[_k(m, n, bw, "horovod_tcp")]["scaling_factor"])
            for m in spec.models for bw in spec.bandwidth_gbps]


def fig7_scaling_vs_workers(models: Optional[Sequence[str]] = None,
                            servers: Optional[Sequence[int]] = None,
                            bandwidth_gbps: Optional[float] = None) -> List[Dict]:
    spec = _grid("paper-fig7",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if servers is None else dict(n_servers=tuple(servers))),
                 **({} if bandwidth_gbps is None
                    else dict(bandwidth_gbps=(float(bandwidth_gbps),))))
    ix = _cells(spec)
    bw = spec.bandwidth_gbps[0]
    return [dict(model=m, servers=n, gpus=n * GPUS_PER_SERVER,
                 simulated=ix[_k(m, n, bw, "ideal")]
                 ["scaling_factor"],
                 measured_mode=ix[_k(m, n, bw, "horovod_tcp")]
                 ["scaling_factor"])
            for m in spec.models for n in spec.n_servers]


def fig8_compression(models: Optional[Sequence[str]] = None,
                     ratios: Optional[Sequence[float]] = None,
                     bws: Optional[Sequence[float]] = None,
                     n_servers: Optional[int] = None) -> List[Dict]:
    spec = _grid("paper-fig8",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if ratios is None
                    else dict(compression_ratio=tuple(float(r) for r in ratios))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if n_servers is None
                    else dict(n_servers=(n_servers,))))
    ix = _cells(spec)
    n = spec.n_servers[0]
    return [dict(model=m, bandwidth_gbps=bw, ratio=r,
                 scaling=ix[_k(m, n, bw, "ideal", r)]["scaling_factor"])
            for m in spec.models for bw in spec.bandwidth_gbps
            for r in spec.compression_ratio]


def transmission_table(bandwidth_gbps: float = 100.0) -> List[Dict]:
    """§4: time to transmit all parameters (paper: 7.8 / 13.6 / 42.2 ms)."""
    from repro_torch.core.cnn_profiles import get_profile
    bw = bandwidth_gbps * GBPS
    out = []
    for m in PAPER_MODELS:
        p = get_profile(m)
        out.append(dict(model=m, size_mb=p.total_bytes / 1e6,
                        time_ms=p.total_bytes / bw * 1e3))
    return out


def fig9_other_systems(models: Optional[Sequence[str]] = None,
                       bws: Optional[Sequence[float]] = None,
                       n_servers: Optional[int] = None) -> List[Dict]:
    """Paper §4 ("What-if analysis for other approaches"): apply the same
    full-utilization what-if to SwitchML-style in-network aggregation and a
    sharded parameter server, against ring all-reduce."""
    spec = _grid("paper-fig9",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if n_servers is None
                    else dict(n_servers=(n_servers,))))
    ix = _cells(spec)
    n = spec.n_servers[0]
    out = []
    for m in spec.models:
        for bw in spec.bandwidth_gbps:
            row = dict(model=m, bandwidth_gbps=bw)
            for topo in spec.topology:
                row[topo] = ix[_k(m, n, bw, "ideal", topo=topo)]["scaling_factor"]
            out.append(row)
    return out


def fig10_schedulers(models: Optional[Sequence[str]] = None,
                     bws: Optional[Sequence[float]] = None,
                     schedulers: Optional[Sequence[str]] = None,
                     transport: Optional[str] = None) -> List[Dict]:
    """The scheduling what-if the event engine opens: f_sim vs bandwidth per
    comm scheduler (fifo = Horovod baseline, priority = ByteScheduler-style,
    chunked = pipelined transmission+reduction).  Rows come from the
    registered ``scheduler-suite`` grid, the same sweep the
    ``scheduler_suite`` golden artifact gates in CI."""
    spec = _grid("scheduler-suite",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if schedulers is None
                    else dict(scheduler=tuple(schedulers))),
                 **({} if transport is None else dict(transport=(transport,))))
    ix = _cells(spec)
    n = spec.n_servers[0]
    out = []
    for m in spec.models:
        for tr in spec.transport:
            for bw in spec.bandwidth_gbps:
                row = dict(model=m, transport=tr, bandwidth_gbps=bw)
                for s in spec.scheduler:
                    c = ix[_k(m, n, bw, tr, sched=s)]
                    row[s] = c["scaling_factor"]
                    row[f"{s}_overhead_ms"] = c["t_overhead"] * 1e3
                out.append(row)
    return out


def fig11_multirail(models: Optional[Sequence[str]] = None,
                    bws: Optional[Sequence[float]] = None,
                    rails: Optional[Sequence[int]] = None,
                    schedulers: Optional[Sequence[str]] = None) -> List[Dict]:
    """Multi-rail what-if: f_sim/t_overhead per (scheduler, n_rails) at
    equal *aggregate* bandwidth — the multi-NIC scenario the paper's
    single-NIC testbed could not measure.  Rows come from the registered
    ``multirail`` grid, the sweep the ``scenario`` golden suite gates in
    CI (chunked stripes and is rails-invariant; serialized fifo gains on
    latency-bound models and loses on bandwidth-bound ones)."""
    spec = _grid("multirail",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if rails is None
                    else dict(n_rails=tuple(int(r) for r in rails))),
                 **({} if schedulers is None
                    else dict(scheduler=tuple(schedulers))))
    ix = _cells(spec)
    n, tr = spec.n_servers[0], spec.transport[0]
    out = []
    for m in spec.models:
        for bw in spec.bandwidth_gbps:
            row = dict(model=m, bandwidth_gbps=bw)
            for s in spec.scheduler:
                for r in spec.n_rails:
                    c = ix[_k(m, n, bw, tr, sched=s, n_rails=r)]
                    row[f"{s}_x{r}"] = c["scaling_factor"]
                    row[f"{s}_x{r}_overhead_ms"] = c["t_overhead"] * 1e3
            out.append(row)
    return out


def fig12_stragglers(models: Optional[Sequence[str]] = None,
                     bws: Optional[Sequence[float]] = None,
                     jitters_ms: Optional[Sequence[float]] = None,
                     schedulers: Optional[Sequence[str]] = None) -> List[Dict]:
    """Straggler what-if: overhead vs the seeded flush-jitter axis, per
    scheduler.  Rows come from the registered ``straggler`` grid (gated by
    the ``scenario`` golden suite): at full bandwidth the straggler tail
    lands in t_overhead; in the bandwidth-bound regime the transmission
    queue absorbs it."""
    spec = _grid("straggler",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if jitters_ms is None
                    else dict(jitter_ms=tuple(float(j) for j in jitters_ms))),
                 **({} if schedulers is None
                    else dict(scheduler=tuple(schedulers))))
    ix = _cells(spec)
    n, tr = spec.n_servers[0], spec.transport[0]
    out = []
    for m in spec.models:
        for s in spec.scheduler:
            for bw in spec.bandwidth_gbps:
                row = dict(model=m, scheduler=s, bandwidth_gbps=bw)
                for j in spec.jitter_ms:
                    c = ix[_k(m, n, bw, tr, sched=s, jitter_ms=j)]
                    row[f"jitter{j:g}ms"] = c["scaling_factor"]
                    row[f"jitter{j:g}ms_overhead_ms"] = c["t_overhead"] * 1e3
                out.append(row)
    return out


def fig13_compression_regimes(models: Optional[Sequence[str]] = None,
                              bws: Optional[Sequence[float]] = None,
                              codecs: Optional[Sequence[str]] = None,
                              schedulers: Optional[Sequence[str]] = None,
                              n_jobs: Optional[Sequence[int]] = None) -> List[Dict]:
    """Compression-regime what-if: each priced codec against its
    ``codec="none"`` twin, classified as wins / loses / pure-overhead /
    neutral by :func:`repro_torch.core.codec.classify_regime`.  Rows come from
    the registered ``compression`` grid, the sweep the
    ``compression_suite`` golden artifact gates in CI: at 10 Gbps the
    network is the bottleneck and int8 wins outright; at 100 Gbps the
    baseline overhead is already negligible and every codec is pure
    GPU-time overhead."""
    from repro_torch.core.codec import classify_regime
    spec = _grid("compression",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if codecs is None
                    else dict(codec=tuple(codecs) if "none" in codecs
                              else ("none",) + tuple(codecs))),
                 **({} if schedulers is None
                    else dict(scheduler=tuple(schedulers))),
                 **({} if n_jobs is None
                    else dict(n_jobs=tuple(int(j) for j in n_jobs))))
    ix = _cells(spec)
    n, tr = spec.n_servers[0], spec.transport[0]
    out = []
    for m in spec.models:
        for bw in spec.bandwidth_gbps:
            for s in spec.scheduler:
                for j in spec.n_jobs:
                    base = ix[_k(m, n, bw, tr, sched=s, n_jobs=j)]
                    for cd in spec.codec:
                        if cd == "none":
                            continue
                        c = ix[_k(m, n, bw, tr, sched=s, n_jobs=j, codec=cd)]
                        out.append(dict(
                            model=m, bandwidth_gbps=bw, scheduler=s,
                            n_jobs=j, codec=cd,
                            scaling=c["scaling_factor"],
                            baseline=base["scaling_factor"],
                            overhead_ms=c["t_overhead"] * 1e3,
                            baseline_overhead_ms=base["t_overhead"] * 1e3,
                            codec_compute_ms=c["codec_compute_s"] * 1e3,
                            regime=classify_regime(
                                c["t_overhead"], base["t_overhead"],
                                base["t_batch"], c["codec_compute_s"])))
    return out


# 8 servers x 8 GPUs: the churn grid's fleet size, the W in fig14's
# churn_rate = W * (1 - p) conversion
CHURN_FLEET = 8 * GPUS_PER_SERVER


def fig14_unreliable_workers(models: Optional[Sequence[str]] = None,
                             bws: Optional[Sequence[float]] = None,
                             nines: Sequence[int] = (1, 2, 3, 4),
                             target: float = 0.95) -> List[Dict]:
    """Unreliable-world what-if: how many nines of per-worker reliability
    does each bandwidth tier need to *retain* >= ``target`` of its
    churn-free scaling factor?

    A fleet of ``W`` workers where each is up with probability
    ``p = 1 - 10**-nines`` per iteration sees an expected ``W * (1 - p)``
    dropout events per iteration — the engine's ``churn_rate`` axis.
    Each row sweeps the nines at one (model, bandwidth) point of the
    registered ``churn`` grid (fifo, one rail, no slowdown/skew: churn
    isolated), reporting per nines count the retention
    ``f_churn / f_churn_free`` and the smallest count that clears
    ``target`` (None when even the most reliable swept fleet does not).
    Retention, not absolute scaling, is the right yardstick: the
    measured-transport baseline tops out well below 0.95 at every
    bandwidth, so an absolute target would only restate the paper's
    transport-bound story, not the churn cost."""
    spec = _grid("churn",
                 models=tuple(models) if models is not None
                 else ("resnet50", "vgg16"),
                 bandwidth_gbps=tuple(float(b) for b in bws)
                 if bws is not None else (5.0, 10.0, 25.0, 100.0),
                 scheduler=("fifo",), n_rails=(1,),
                 fault_model=("none",), worker_bw_skew=(0.0,),
                 churn_rate=(0.0,) + tuple(CHURN_FLEET * (10.0 ** -k)
                                           for k in nines))
    ix = _cells(spec)
    n = spec.n_servers[0]
    tr = spec.transport[0]
    out = []
    for m in spec.models:
        for bw in spec.bandwidth_gbps:
            base = ix[_k(m, n, bw, tr)]["scaling_factor"]
            row = dict(model=m, bandwidth_gbps=bw, churn_free=base,
                       nines_needed=None)
            ret = []
            for k, cr in zip(nines, spec.churn_rate[1:]):
                f = ix[_k(m, n, bw, tr, churn_rate=cr)]["scaling_factor"]
                row[f"nines{k}_retention"] = f / base
                ret.append((k, f / base))
            # smallest count that clears the target *and keeps it cleared*
            # at every higher count — a violent-churn fluke (drops cancel
            # enough pending wire work to beat the baseline) must not
            # report a 1-nines fleet as sufficient
            for i, (k, r) in enumerate(ret):
                if all(rj >= target for _, rj in ret[i:]):
                    row["nines_needed"] = k
                    break
            out.append(row)
    return out


def fig15_fabric_oversubscription(models: Optional[Sequence[str]] = None,
                                  bws: Optional[Sequence[float]] = None,
                                  oversubs: Optional[Sequence[float]] = None,
                                  topologies: Optional[Sequence[str]] = None
                                  ) -> List[Dict]:
    """Fabric what-if: the same collectives priced on a Clos fabric with
    oversubscribed ToR uplinks instead of one flat link.  Rows come from
    the registered ``fabric`` grid, the sweep the ``fabric_suite`` golden
    artifact gates in CI.  Per (model, bandwidth, topology) the row holds
    the scaling factor at each oversubscription ratio plus the retention
    of the 1:1 (bitwise-flat) baseline — the striped ring and tree pay
    the full 1/oversub rate cut, while hierarchical's rack-local
    reduction keeps only the leader on the spine and retains ~100 %."""
    spec = _grid("fabric",
                 **({} if models is None else dict(models=tuple(models))),
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if oversubs is None
                    else dict(oversubscription=tuple(float(o)
                                                     for o in oversubs))),
                 **({} if topologies is None
                    else dict(topology=tuple(topologies))))
    ix = _cells(spec)
    n, tr = spec.n_servers[0], spec.transport[0]
    out = []
    for m in spec.models:
        for bw in spec.bandwidth_gbps:
            for topo in spec.topology:
                base = ix[_k(m, n, bw, tr, topo=topo, fabric="clos",
                             oversubscription=spec.oversubscription[0])]
                row = dict(model=m, bandwidth_gbps=bw, topology=topo)
                for ov in spec.oversubscription:
                    c = ix[_k(m, n, bw, tr, topo=topo, fabric="clos",
                              oversubscription=ov)]
                    row[f"oversub{ov:g}"] = c["scaling_factor"]
                    row[f"oversub{ov:g}_retention"] = (
                        c["scaling_factor"] / base["scaling_factor"])
                out.append(row)
    return out


def fig16_wan_loss_regimes(bws: Optional[Sequence[float]] = None,
                           schedulers: Optional[Sequence[str]] = None
                           ) -> List[Dict]:
    """Lossy-transport what-if: the paper's compression verdict re-derived
    under WAN loss.  Fig 8 concludes 2x-5x compression suffices at
    datacenter bandwidths — but its clean fluid link is exactly what the
    follow-up literature (Agarwal et al., Han et al.) shows is decisive:
    the utility judgment flips with the transport regime.  Rows come from
    the registered ``wan`` grid (the sweep the ``wan_suite`` golden
    artifact gates in CI): per (bandwidth, scheduler, loss profile) the
    int8 codec's t_sync against its codec=none twin.  On a lossy link
    every saved wire byte is saved ``1/(1-loss)`` times *and* shrinks the
    retransmission-stall exposure, so the compression-wins region only
    widens as loss grows — the regime boundary the grid's
    ``compression_wins_region_widens_with_loss`` validator pins."""
    spec = _grid("wan",
                 **({} if bws is None
                    else dict(bandwidth_gbps=tuple(float(b) for b in bws))),
                 **({} if schedulers is None
                    else dict(scheduler=tuple(schedulers))))
    ix = _cells(spec)
    n, tr, m = spec.n_servers[0], spec.transport[0], spec.models[0]
    # the loss ladder: clean link + the fixed-rtt profiles (the backoff
    # variants probe the stall model, not the compression regime)
    ladder = [p for p in spec.link_profile if "timeout" not in p]
    out = []
    for bw in spec.bandwidth_gbps:
        for s in spec.scheduler:
            for lp in ladder:
                base = ix[_k(m, n, bw, tr, sched=s, link_profile=lp)]
                comp = ix[_k(m, n, bw, tr, sched=s, codec="int8",
                             link_profile=lp)]
                out.append(dict(
                    model=m, bandwidth_gbps=bw, scheduler=s,
                    link_profile=lp,
                    t_sync_none=base["t_sync"],
                    t_sync_int8=comp["t_sync"],
                    int8_speedup=base["t_sync"] / max(comp["t_sync"], 1e-12),
                    compression_wins=comp["t_sync"] < base["t_sync"]))
    return out


def multirail_whatif(model: str = "resnet101", bandwidth_gbps: float = 100.0,
                     n_servers: int = 8, n_rails: int = 2,
                     scheduler: str = "fifo") -> Dict:
    """One-cell multi-rail comparison at equal aggregate bandwidth:
    ``n_rails`` rails of ``bandwidth/n_rails`` each versus one fat NIC.
    The direct-simulate twin of :func:`fig11_multirail` for exploration
    outside the registered grid."""
    n = n_servers * GPUS_PER_SERVER
    bw = bandwidth_gbps * GBPS
    tl = paper_timeline(model)
    one = simulate(tl, n_workers=n, bandwidth=bw, transport="horovod_tcp",
                   scheduler=scheduler)
    split = simulate(tl, n_workers=n, bandwidth=bw, transport="horovod_tcp",
                     scheduler=scheduler, n_rails=n_rails)
    return dict(model=model, bandwidth_gbps=bandwidth_gbps,
                scheduler=scheduler, n_rails=n_rails,
                one_nic=one.scaling_factor, multirail=split.scaling_factor,
                overhead_delta_ms=(split.t_overhead - one.t_overhead) * 1e3)


def contention_whatif(models: Sequence[str] = ("resnet50", "vgg16"),
                      bandwidth_gbps: float = 25.0, n_servers: int = 8,
                      scheduler: str = "fifo") -> List[Dict]:
    """Two training jobs sharing one link — the multi-tenant scenario the
    event engine's fair-share links make expressible.  Each job's scaling
    factor under contention vs running the link alone."""
    from repro_torch.core.simulator import simulate_contention
    n = n_servers * GPUS_PER_SERVER
    bw = bandwidth_gbps * GBPS
    tls = [paper_timeline(m) for m in models]
    shared = simulate_contention(tls, n_workers=n, bandwidth=bw,
                                 scheduler=scheduler)
    out = []
    for tl, r in zip(tls, shared):
        alone = simulate(tl, n_workers=n, bandwidth=bw, scheduler=scheduler)
        out.append(dict(model=tl.name, bandwidth_gbps=bandwidth_gbps,
                        scheduler=scheduler, alone=alone.scaling_factor,
                        contended=r.scaling_factor,
                        slowdown=alone.scaling_factor / max(r.scaling_factor,
                                                            1e-12)))
    return out


def bytescheduler_whatif(model: str = "vgg16", bandwidth_gbps: float = 10.0,
                         n_servers: int = 8) -> Dict:
    """ByteScheduler's insight: transmit *front* layers first so the next
    iteration's forward pass can start before the sync finishes.  In the
    simulator this bounds the overhead by the sync tail that extends past
    the point where the front layers are available again — we approximate
    the benefit as overlapping the next forward with the remaining sync
    (the upper bound the paper suggests evaluating)."""
    tl = paper_timeline(model)
    base = simulate(tl, n_workers=n_servers * GPUS_PER_SERVER,
                    bandwidth=bandwidth_gbps * GBPS, transport="ideal")
    t_fwd = tl.t_batch - tl.t_back
    overhead_sched = max(0.0, base.t_overhead - t_fwd)
    f_sched = tl.t_batch / (tl.t_batch + overhead_sched)
    return dict(model=model, bandwidth_gbps=bandwidth_gbps,
                baseline=base.scaling_factor, bytescheduler_bound=f_sched)


# ---------------------------------------------------------------------------
# beyond-paper: the same analysis for the port's LLMs on H100s
# ---------------------------------------------------------------------------

# Data-sheet rates of the NVIDIA H100 SXM platform (DGX H100 layout):
# NVLink 4 moves 900 GB/s per GPU in both directions together, so 450 GB/s =
# 3600 Gbps one way; across nodes each GPU has its own 400 Gb/s ConnectX-7
# NDR InfiniBand port.  ``HierarchicalAllReduce`` charges the cross-node
# stage as one GPU's shard (S / gpus_per_node) over ``dcn_bw``, with every
# GPU of a node moving its shard at once, so ``dcn_bw`` is priced per GPU:
# ``ib_gbps`` is one GPU's port, not a node's aggregate.
H100_NVLINK_GBPS = 3600.0
H100_IB_GBPS = 400.0


def h100_whatif(cfg, shape, *, n_gpus: int = 64, gpus_per_node: int = 8,
                nvlink_gbps: float = H100_NVLINK_GBPS,
                ib_gbps: float = H100_IB_GBPS, mfu: float = 0.4,
                compression_ratio: float = 1.0, transport: str = "ideal",
                data_parallel: Optional[int] = None,
                addest: Optional[AddEst] = None) -> SimResult:
    """Paper's analysis transplanted to an H100 cluster: is the network the
    bottleneck for data-parallel training of the port's LLMs?

    ``shape`` is what one replica computes in a step (the port's trainer:
    S = 4096, batch 1).  ``data_parallel``: size of the gradient all-reduce
    group (defaults to every GPU, since the port's trainer holds the whole
    model on each card); the model-parallel group of ``n_gpus //
    data_parallel`` GPUs accelerates per-layer compute instead and shards
    the gradients.  Compute is priced at ``mfu`` of the H100's dense bf16
    rate (``timeline.from_transformer``'s default), adds by ``addest``
    (``AddEst.h100()`` by default, or one measured on the card).  Inside
    one node the ring runs on NVLink; beyond it, the hierarchical
    all-reduce runs its cross-node stage on InfiniBand.  The simulator
    sees exactly the dp ranks of the all-reduce: a node holds
    ``gpus_per_node // mp`` of them, or, once the model-parallel group
    fills a node or spans several, each dp rank is a node group of its own
    (``tpu_whatif``'s ``n_workers = dp × n_pods``).
    """
    from repro_torch.core.timeline import from_transformer
    dp = data_parallel or n_gpus
    mp = max(n_gpus // dp, 1)
    tl = from_transformer(cfg, shape, mfu=mfu, n_chips_compute=mp,
                          grad_dtype_bytes=2)
    # per-replica gradient shard: model-parallel shards gradients mp-ways
    tl = GradTimeline(tl.name, tl.ready_times,
                      tuple(s / mp for s in tl.sizes), tl.t_back, tl.t_batch)
    n_nodes = dp if mp >= gpus_per_node else max(n_gpus // gpus_per_node, 1)
    return simulate(tl, n_workers=dp, bandwidth=nvlink_gbps * GBPS,
                    transport=transport, addest=addest or AddEst.h100(),
                    compression_ratio=compression_ratio,
                    topology="hierarchical" if n_gpus > gpus_per_node
                    else "ring",
                    n_pods=n_nodes, dcn_bandwidth=ib_gbps * GBPS)
