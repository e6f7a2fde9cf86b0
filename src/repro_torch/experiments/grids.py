"""Named sweep grids — one per paper figure, plus suite aliases.

These are the declarative replacements for the old imperative loops in
``repro_torch.core.whatif``: each grid is exactly the figure's sweep, and the
``paper`` suite is what the committed golden artifact (and the CI
sim-regression job) runs.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.experiments.spec import ExperimentSpec

PAPER_MODELS = ("resnet50", "resnet101", "vgg16")

GRIDS: Dict[str, ExperimentSpec] = {}


def _register(spec: ExperimentSpec) -> ExperimentSpec:
    GRIDS[spec.name] = spec
    return spec


# Fig 1: measured-mode scaling factor vs number of servers at 100 Gbps.
_register(ExperimentSpec(
    name="paper-fig1", models=PAPER_MODELS, n_servers=(2, 4, 8),
    bandwidth_gbps=(100.0,), transport=("horovod_tcp",)))

# Fig 3: ResNet-50 scaling vs bandwidth, per server count (measured mode).
_register(ExperimentSpec(
    name="paper-fig3", models=("resnet50",), n_servers=(2, 4, 8),
    bandwidth_gbps=(1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 75.0, 100.0),
    transport=("horovod_tcp",)))

# Fig 4: network utilization during the communication phase, 8 servers.
_register(ExperimentSpec(
    name="paper-fig4", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(1.0, 10.0, 25.0, 50.0, 100.0),
    transport=("horovod_tcp",)))

# Fig 6: simulated-full-utilization vs measured-mode lines, 8 servers.
_register(ExperimentSpec(
    name="paper-fig6", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(1.0, 10.0, 25.0, 50.0, 100.0),
    transport=("ideal", "horovod_tcp")))

# Fig 7: scaling vs worker count at 100 Gbps, both transports.
_register(ExperimentSpec(
    name="paper-fig7", models=PAPER_MODELS, n_servers=(1, 2, 4, 8),
    bandwidth_gbps=(100.0,), transport=("ideal", "horovod_tcp")))

# Fig 8: gradient compression under full utilization.
_register(ExperimentSpec(
    name="paper-fig8", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(10.0, 100.0), transport=("ideal",),
    compression_ratio=(1.0, 2.0, 5.0, 10.0, 100.0)))

# §4 other systems: ring vs SwitchML vs sharded parameter server (what-if).
_register(ExperimentSpec(
    name="paper-fig9", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(10.0, 25.0, 100.0), transport=("ideal",),
    topology=("ring", "switchml", "param_server")))

# Scheduler axis (tentpole of the event-engine refactor): the paper grid's
# interesting bandwidths under each comm schedule.  fifo is the measured
# Horovod baseline; priority (ByteScheduler-style first-layer-first) and
# chunked (pipelined transmission+reduction) must never add overhead —
# the `scheduler_suite` golden artifact gates exactly that in CI.
_register(ExperimentSpec(
    name="scheduler-suite", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(5.0, 10.0, 25.0, 100.0),
    transport=("ideal", "horovod_tcp"),
    scheduler=("fifo", "priority", "chunked")))

# paper-xl (the event-engine rewrite's payoff): the scenario space the
# follow-up papers show is needed before the interesting conclusions emerge
# — a dense bandwidth axis, deep chunking, and a multi-job contention axis.
# Only tractable with the indexed engine + process-pool runner: the xl-sched
# grid alone lowers to ~10^3 flows per cell at sched_chunks=64.

# Dense bandwidth sweep: every server count x a 14-point bandwidth axis,
# both transports (fig3/fig6 were 8 and 5 points on one model each).
_register(ExperimentSpec(
    name="xl-bandwidth", models=PAPER_MODELS, n_servers=(2, 4, 8),
    bandwidth_gbps=(1.0, 2.0, 5.0, 7.5, 10.0, 15.0, 20.0, 25.0, 40.0, 50.0,
                    75.0, 100.0, 200.0, 400.0),
    transport=("ideal", "horovod_tcp")))

# Deep chunking: the pipelined schedulers at 64 chunks/bucket, where the
# chunk pipeline saturates and the t_overhead <= fifo claim is sharpest.
_register(ExperimentSpec(
    name="xl-sched", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(5.0, 10.0, 25.0, 50.0, 100.0),
    transport=("ideal", "horovod_tcp"),
    scheduler=("fifo", "priority", "chunked"), sched_chunks=64))

# Contention: 1/2/4/8 copies of the same training job fair-sharing one
# link (simulate_contention), under fifo and the chunked pipeline.
_register(ExperimentSpec(
    name="xl-contention", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(10.0, 25.0, 100.0), transport=("horovod_tcp",),
    scheduler=("fifo", "chunked"), n_jobs=(1, 2, 4, 8), sched_chunks=32))

# xxl-contention (the heap-mode bulk-commit payoff): the large, contended,
# scheduler-sensitive regime the gradient-compression follow-up identifies
# as where scheduling actually matters — priority *and* chunked pipelines
# at 64 chunks/bucket, up to 16 co-located jobs, with and without flush
# jitter.  The 16-job VGG16 cells lower to >18k flows each (>10k/cell is
# the grid's defining scale), which is only sweepable because heap-mode
# (priority) jobs ride the same numpy bulk-commit fast path as pointer
# mode.  Gated by artifacts/golden/xxl_contention_suite.json in CI.
_register(ExperimentSpec(
    name="xxl-contention", models=("resnet50", "vgg16"), n_servers=(8,),
    bandwidth_gbps=(10.0, 25.0), transport=("horovod_tcp",),
    scheduler=("priority", "chunked"), n_jobs=(1, 4, 16), sched_chunks=64,
    jitter_ms=(0.0, 2.0), jitter_seed=2026))

# Scenario axes (the follow-up literature's territory — what the paper's
# single-NIC, no-straggler testbed could not measure).

# Multi-rail hosts: the cell's bandwidth is the *aggregate*; n_rails splits
# it into equal rails and assign_rails deals the plan's ops across them
# (round-robin).  The claims the golden suite gates: the chunked pipeline
# stripes, so rails leave its overhead unchanged up to the tail-bucket
# negotiation skew; the serialized fifo stream cannot stripe, so rails
# *help* latency-bound models (parallel reductions) and *hurt*
# bandwidth-bound ones (a whole bucket is stuck on one slower rail).
_register(ExperimentSpec(
    name="multirail", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(10.0, 25.0, 100.0), transport=("horovod_tcp",),
    scheduler=("fifo", "chunked"), sched_chunks=8, n_rails=(1, 2, 4)))

# Stragglers: each flow's flush is delayed by an exponential draw with
# mean jitter_ms (seeded, so the grid is reproducible bit-for-bit).  The
# gated claims: overhead is monotone in jitter; at full bandwidth the
# straggler tail passes straight into t_overhead, while in the
# bandwidth-bound regime the transmission queue absorbs it.
_register(ExperimentSpec(
    name="straggler", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(10.0, 100.0), transport=("horovod_tcp",),
    scheduler=("fifo", "chunked"), sched_chunks=8,
    jitter_ms=(0.0, 2.0, 10.0), jitter_seed=2020))

# Compression as a priced axis (the Agarwal et al. critique of fig 8's
# free byte divisor): every codec carries kernel-calibrated encode/decode
# compute, so each cell answers "does this codec win, lose, or just burn
# GPU time here?" against its codec=none twin.  Ideal transport isolates
# the wire-vs-compute tradeoff (under horovod_tcp the transport cap, not
# the network, dominates at 100 Gbps): at 10 Gbps the network is the
# bottleneck and compression wins; at 100 Gbps the baseline overhead is
# already negligible and any codec is pure overhead.  Gated by
# artifacts/golden/compression_suite.json in CI (fig13 renders it).
_register(ExperimentSpec(
    name="compression", models=PAPER_MODELS, n_servers=(8,),
    bandwidth_gbps=(1.0, 10.0, 100.0), transport=("ideal",),
    scheduler=("fifo", "chunked"), sched_chunks=8, n_jobs=(1, 4),
    codec=("none", "int8", "ternary", "topk:8", "size-adaptive")))

# Unreliable-world axes (the Hivemind / flaky-fleet territory): worker-
# correlated slowdowns, dropout/rejoin churn with a priced re-bucketing
# stall, and asymmetric per-worker bandwidth — all seeded via core.faults
# and composed with the scheduler and rails axes.  The gated claims:
# fault_model="none" x churn_rate=0 x skew=0 cells are *bitwise* identical
# to plain simulate (the null model never touches a flow); fifo overhead
# is monotone in the slowdown scale at fixed seed (shared exponential
# draws, linear scaling); priority never loses to fifo on t_overhead
# under churn (the engine re-admits survivors in IR order either way).
# Gated by artifacts/golden/churn_suite.json in CI.
_register(ExperimentSpec(
    name="churn", models=("resnet50", "vgg16"), n_servers=(8,),
    bandwidth_gbps=(10.0, 100.0), transport=("horovod_tcp",),
    scheduler=("fifo", "priority"), sched_chunks=8, n_rails=(1, 2),
    fault_model=("none", "slowdown:1", "slowdown:5"),
    churn_rate=(0.0, 0.64), worker_bw_skew=(0.0, 0.5), fault_seed=2027))

# Fabric axes (the tentpole of the multi-link max-min engine): the same
# collectives priced on a Clos fabric with oversubscribed ToR uplinks
# instead of one flat link.  Striped ring/tree collectives push all
# hosts_per_tor NICs of a rack through the uplink at once, so their solo
# rate is min(1, 1/oversubscription); hierarchical reduces rack-locally
# and only a leader crosses the spine, riding out oversubscription.  The
# gated claims: 1:1 cells are *bitwise* the flat topology (the uplink is
# elided from the path, so the original engine runs verbatim); scaling is
# monotone non-increasing in oversubscription; hierarchical never loses
# to the flat ring at 4:1.  Gated by artifacts/golden/fabric_suite.json.
_register(ExperimentSpec(
    name="fabric", models=("resnet50", "vgg16"), n_servers=(8,),
    bandwidth_gbps=(10.0, 100.0), transport=("ideal",),
    topology=("ring", "tree", "hierarchical"),
    fabric=("clos",), oversubscription=(1.0, 2.0, 4.0)))

# WAN / lossy-link axes (the tentpole of the lossy-transport engine): the
# transport-regime territory the Agarwal et al. and Han et al. follow-ups
# show flips end-to-end utility judgments.  link_profile prices Bernoulli
# segment loss two ways: deterministically (wire work inflates by
# 1/(1-loss), RTT joins the post-wire latency) and stochastically (seeded
# RTO stalls of timeout * backoff^k riding the _RETX calendar kind).  The
# gated claims: link_profile="none" cells are *bitwise* plain simulate
# (the null profile never touches a flow); t_sync is monotone
# non-decreasing in loss at fixed rtt (thinning keeps a loss-superset of
# the same timed events); stalls are monotone in the backoff multiplier
# at fixed timeout; and the compression-wins region (int8 beating its
# codec=none twin on t_sync) only widens as loss grows — lost bytes are
# retransmitted bytes, so compression pays double under loss.  Gated by
# artifacts/golden/wan_suite.json in CI (fig16 renders the regime map).
_register(ExperimentSpec(
    name="wan", models=("resnet50",), n_servers=(8,),
    bandwidth_gbps=(1.0, 10.0), transport=("horovod_tcp",),
    scheduler=("fifo", "priority"), sched_chunks=8,
    codec=("none", "int8"), fault_seed=2029,
    link_profile=("none",
                  "wan:loss=0.001,rtt=20",
                  "wan:loss=0.01,rtt=20",
                  "wan:loss=0.05,rtt=20",
                  "wan:loss=0.01,rtt=20:timeout=100,backoff=1",
                  "wan:loss=0.01,rtt=20:timeout=100,backoff=4")))

# Suites: ordered grid groups runnable/comparable as one artifact.
SUITES: Dict[str, Tuple[str, ...]] = {
    "paper": ("paper-fig1", "paper-fig3", "paper-fig4", "paper-fig6",
              "paper-fig7", "paper-fig8", "paper-fig9"),
    "scheduler": ("scheduler-suite",),
    "paper-xl": ("xl-bandwidth", "xl-sched", "xl-contention"),
    "scenario": ("multirail", "straggler"),
    "xxl": ("xxl-contention",),
    "compression": ("compression",),
    "churn": ("churn",),
    "fabric": ("fabric",),
    "wan": ("wan",),
}


def resolve(name: str) -> Tuple[ExperimentSpec, ...]:
    """A grid name resolves to one spec; a suite name to its ordered specs."""
    if name in SUITES:
        return tuple(GRIDS[g] for g in SUITES[name])
    if name in GRIDS:
        return (GRIDS[name],)
    known = sorted(GRIDS) + sorted(SUITES)
    raise KeyError(f"unknown grid/suite {name!r}; known: {', '.join(known)}")
