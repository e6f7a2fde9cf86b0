"""Paper-claim checks, evaluated on experiment cells and stored in artifacts.

These are the section-1 validations that used to live inline in
``benchmarks/figures.py``; moving them into the engine means every artifact
carries its own pass/fail record and ``compare`` can flag a claim that a
refactor silently broke (a True that became False is a regression even if
no numeric tolerance trips).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

Check = Dict[str, bool]


def _by(cells: Sequence[Dict], *axes: str, value: str = "scaling_factor"):
    from repro_torch.experiments.spec import axis_value
    return {tuple(axis_value(c, a) for a in axes): c[value] for c in cells}


def _fig1(cells: Sequence[Dict]) -> Check:
    by = _by(cells, "model", "n_servers")
    # paper §2.2: RN50/RN101/VGG16 = 75/69/56 % @2 servers; none exceeds 76 %
    return {
        "rn50_2srv_in_[0.6,0.9]": 0.60 <= by[("resnet50", 2)] <= 0.90,
        "vgg16_worst": by[("vgg16", 2)] < by[("resnet50", 2)],
        "no_linear_scaling": max(by.values()) < 0.85,
    }


def _fig3(cells: Sequence[Dict]) -> Check:
    by = _by(cells, "n_servers", "bandwidth_gbps")
    # paper: 2-server RN50 grows 13 % -> ~68 % from 1 to 10 Gbps, then
    # plateaus after 25 Gbps (measured transport)
    return {
        "low_bw_poor": by[(2, 1.0)] < 0.25,
        "grows_to_10g": by[(2, 10.0)] > 3 * by[(2, 1.0)],
        "plateau_after_25g": (by[(2, 100.0)] - by[(2, 25.0)]) < 0.15,
    }


def _fig4(cells: Sequence[Dict]) -> Check:
    util = _by(cells, "model", "bandwidth_gbps", value="network_utilization")
    eff = _by(cells, "model", "bandwidth_gbps", value="effective_gbps")
    return {
        "full_util_at_1g": util[("resnet50", 1.0)] > 0.9,
        "low_util_at_100g": eff[("resnet50", 100.0)] < 32.0,
    }


def _fig6(cells: Sequence[Dict]) -> Check:
    by = _by(cells, "model", "bandwidth_gbps", "transport")
    low_bw_agree, high_bw_diverge = True, False
    for (m, bw, t), f in by.items():
        if t != "ideal":
            continue
        meas = by[(m, bw, "horovod_tcp")]
        if bw <= 10 and abs(f - meas) > 0.08:
            low_bw_agree = False       # Fig 6: the lines coincide at low bw
        if bw == 100 and f - meas > 0.15:
            high_bw_diverge = True     # ...and split at 100 Gbps
    return {"low_bw_agree": low_bw_agree, "high_bw_diverge": high_bw_diverge}


def _fig7(cells: Sequence[Dict]) -> Check:
    # paper: full-util scaling ~100 % even at 64 GPUs
    worst = min(c["scaling_factor"] for c in cells
                if c["transport"] == "ideal")
    return {"full_util_near_1_even_64gpus": worst > 0.97}


def _fig8(cells: Sequence[Dict]) -> Check:
    by = _by(cells, "model", "bandwidth_gbps", "compression_ratio")
    # paper: 2-5x suffices at 10 Gbps for ResNets; ~10x for VGG16;
    # compression unnecessary at 100 Gbps
    return {
        "rn50_5x_10g": by[("resnet50", 10.0, 5.0)] > 0.95,
        "vgg16_10x_10g": by[("vgg16", 10.0, 10.0)] > 0.95,
        "no_need_at_100g": by[("vgg16", 100.0, 1.0)] > 0.97,
        "100x_overkill": (by[("resnet50", 10.0, 100.0)]
                          - by[("resnet50", 10.0, 10.0)]) < 0.02,
    }


def _fig9(cells: Sequence[Dict]) -> Check:
    by = _by(cells, "model", "bandwidth_gbps", "topology")
    ok = all(by[(m, bw, "switchml")] >= by[(m, bw, "ring")] - 1e-9
             for (m, bw, topo) in by if topo == "ring")
    return {"switchml_never_worse": ok}


def _scheduler_suite(cells: Sequence[Dict]) -> Check:
    """The tentpole's acceptance claim: a better schedule never *adds*
    overhead.  priority and chunked reorder/pipeline the same wire work a
    work-conserving link serves, so per cell their t_overhead must be <=
    fifo's (tiny epsilon for float re-association)."""
    over = _by(cells, "model", "bandwidth_gbps", "transport", "scheduler",
               value="t_overhead")
    eps = 1e-12
    pri_ok = all(over[(m, bw, t, "priority")] <= f + eps
                 for (m, bw, t, s), f in over.items() if s == "fifo")
    chk_ok = all(over[(m, bw, t, "chunked")] <= f + eps
                 for (m, bw, t, s), f in over.items() if s == "fifo")
    # pipelining matters most where the link is the bottleneck: at 5 Gbps
    # measured-mode VGG16 the chunked schedule must show a real win
    gain = (over[("vgg16", 5.0, "horovod_tcp", "fifo")]
            - over[("vgg16", 5.0, "horovod_tcp", "chunked")])
    return {
        "priority_overhead_le_fifo": pri_ok,
        "chunked_overhead_le_fifo": chk_ok,
        "chunked_helps_vgg16_at_5g": gain > 0.0,
    }


def _xl_bandwidth(cells: Sequence[Dict]) -> Check:
    """The dense sweep must reproduce the paper's shape everywhere: scaling
    monotone in bandwidth per (model, servers, transport), ideal transport
    never below measured mode, and the measured plateau past 25 Gbps."""
    by = _by(cells, "model", "n_servers", "transport", "bandwidth_gbps")
    bws = sorted({bw for (_, _, _, bw) in by})
    mono = all(by[(m, n, t, a)] <= by[(m, n, t, b)] + 1e-9
               for (m, n, t, _) in by for a, b in zip(bws, bws[1:]))
    ideal_ge = all(f <= by[(m, n, "ideal", bw)] + 1e-9
                   for (m, n, t, bw), f in by.items() if t == "horovod_tcp")
    plateau = all(by[(m, n, "horovod_tcp", 400.0)]
                  - by[(m, n, "horovod_tcp", 25.0)] < 0.15
                  for (m, n, t, _) in by if t == "horovod_tcp")
    return {"monotone_in_bandwidth": mono, "ideal_bounds_measured": ideal_ge,
            "measured_plateau_past_25g": plateau}


def _xl_sched(cells: Sequence[Dict]) -> Check:
    """Deep chunking (64 chunks/bucket) must sharpen, not break, the
    scheduler claims: pipelined schedules never add overhead over fifo."""
    over = _by(cells, "model", "bandwidth_gbps", "transport", "scheduler",
               value="t_overhead")
    eps = 1e-12
    fifo = {k[:3]: v for k, v in over.items() if k[3] == "fifo"}
    pri_ok = all(v <= fifo[k[:3]] + eps
                 for k, v in over.items() if k[3] == "priority")
    chk_ok = all(v <= fifo[k[:3]] + eps
                 for k, v in over.items() if k[3] == "chunked")
    # at 64 chunks the pipeline must show a strict win on the bandwidth-
    # bound measured VGG16 cell
    gain = (over[("vgg16", 5.0, "horovod_tcp", "fifo")]
            - over[("vgg16", 5.0, "horovod_tcp", "chunked")])
    return {"priority64_overhead_le_fifo": pri_ok,
            "chunked64_overhead_le_fifo": chk_ok,
            "chunked64_helps_vgg16_at_5g": gain > 0.0}


def _xl_contention(cells: Sequence[Dict]) -> Check:
    """Fair-share contention semantics at sweep scale: co-located jobs can
    only hurt, monotonically in the number of jobs, and a solo 'contention'
    cell must agree with the plain simulate path bit-for-bit (the engine's
    closed forms make the degenerate case exact, not just close)."""
    by = _by(cells, "model", "bandwidth_gbps", "scheduler", "n_jobs")
    jobs = sorted({j for (_, _, _, j) in by})
    mono = all(by[(m, bw, s, b)] <= by[(m, bw, s, a)] + 1e-9
               for (m, bw, s, _) in by for a, b in zip(jobs, jobs[1:]))
    hurts = all(by[(m, bw, s, 8)] < by[(m, bw, s, 1)] - 1e-6
                for (m, bw, s, j) in by if j == 1 and bw <= 25.0)
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    solo = [c for c in cells if c.get("n_jobs", 1) == 1
            and c["model"] == "vgg16" and c["scheduler"] == "fifo"]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"],
                         scheduler=c["scheduler"]).t_sync == c["t_sync"]
                for c in solo)
    return {"monotone_in_n_jobs": mono, "contention_hurts_at_low_bw": hurts,
            "solo_cell_matches_simulate_bitwise": exact}


def _xxl_contention(cells: Sequence[Dict]) -> Check:
    """The 10k-flow priority/contention regime the heap-mode bulk commit
    opens up.  Gated claims:

    - fair-share contention only hurts, monotonically in ``n_jobs``, at
      every (model, bandwidth, scheduler, jitter) point — including the
      18k-flow 16-job VGG16 cells;
    - at 64 chunks/bucket the priority schedule never *adds* overhead
      over the chunked pipeline (same chunking, reordered): solo it may
      win slightly, and under saturation the work-conserving link makes
      them coincide up to the final-tail reordering;
    - flush jitter is monotone for a *solo* job (the straggler-grid
      claim at 64-chunk scale).  Under contention independent job
      streams can delay competitors and *help* job 0, so monotonicity
      is deliberately not claimed for n_jobs > 1;
    - a solo unjittered cell is bit-exact with plain ``simulate`` — the
      degenerate contention path stays on the engine's closed forms.
    """
    from repro_torch.experiments.spec import axis_value
    by = {(c["model"], c["bandwidth_gbps"], c["scheduler"],
           axis_value(c, "n_jobs"), axis_value(c, "jitter_ms")): c
          for c in cells}
    jobs = sorted({k[3] for k in by})
    over = {k: c["t_overhead"] for k, c in by.items()}
    mono_jobs = all(over[(m, bw, s, a, jm)] <= over[(m, bw, s, b, jm)] + 1e-9
                    for (m, bw, s, _, jm) in by
                    for a, b in zip(jobs, jobs[1:]))
    hurts = all(by[(m, bw, s, jobs[-1], jm)]["scaling_factor"]
                < by[(m, bw, s, 1, jm)]["scaling_factor"] - 1e-6
                for (m, bw, s, j, jm) in by if j == 1)
    pri_le_chk = all(over[(m, bw, "priority", j, jm)]
                     <= over[(m, bw, "chunked", j, jm)] + 1e-4
                     for (m, bw, s, j, jm) in by if s == "chunked")
    jits = sorted({k[4] for k in by})
    solo_jit = all(over[(m, bw, s, 1, a)] <= over[(m, bw, s, 1, b)] + 1e-9
                   for (m, bw, s, j, _) in by if j == 1
                   for a, b in zip(jits, jits[1:]))
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    solo = [c for c in cells if axis_value(c, "n_jobs") == 1
            and axis_value(c, "jitter_ms") == 0.0]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"], scheduler=c["scheduler"],
                         n_chunks=64).t_sync == c["t_sync"]
                for c in solo)
    return {"overhead_monotone_in_n_jobs": mono_jobs,
            "contention_hurts_at_16_jobs": hurts,
            "priority64_overhead_le_chunked64": pri_le_chk,
            "solo_overhead_monotone_in_jitter": solo_jit,
            "solo_cell_matches_simulate_bitwise": exact}


def _multirail(cells: Sequence[Dict]) -> Check:
    """The multi-rail claims the scenario golden suite gates.

    At *equal aggregate bandwidth*: the chunked pipeline stripes every
    bucket across rails, so splitting the link never costs more than the
    tail-bucket negotiation skew (the negotiation-carrying chunk's wire
    runs at 1/n rate — an absolute, sub-millisecond effect); the
    serialized fifo stream cannot stripe, so rails strictly *help*
    latency-bound models (lanes run reductions in parallel) and strictly
    *hurt* the bandwidth-bound VGG16 (whole buckets sit on a slower rail).
    A fifo cell on one rail must be bit-exact with a ``simulate`` call
    that never heard of the axis.
    """
    over = _by(cells, "model", "bandwidth_gbps", "scheduler", "n_rails",
               value="t_overhead")
    skew = 1e-3                      # seconds; see docstring
    chunked_ok = all(v <= over[(m, bw, s, 1)] + skew
                     for (m, bw, s, r), v in over.items()
                     if s == "chunked" and r > 1)
    fifo_helps = all(over[(m, bw, "fifo", 2)] < over[(m, bw, "fifo", 1)]
                     for m in ("resnet50", "resnet101")
                     for bw in (25.0, 100.0))
    fifo_hurts = all(over[("vgg16", bw, "fifo", 2)]
                     > over[("vgg16", bw, "fifo", 1)]
                     for bw in (10.0, 25.0, 100.0))
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    from repro_torch.experiments.spec import axis_value
    solo = [c for c in cells if axis_value(c, "n_rails") == 1
            and c["scheduler"] == "fifo" and c["model"] == "vgg16"]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"], scheduler=c["scheduler"],
                         n_chunks=8).t_sync == c["t_sync"]
                for c in solo)
    return {"chunked_rails_never_slower_within_skew": chunked_ok,
            "fifo_rails2_help_latency_bound_models": fifo_helps,
            "fifo_rails2_hurt_bandwidth_bound_vgg16": fifo_hurts,
            "fifo_rails1_matches_simulate_bitwise": exact}


def _straggler(cells: Sequence[Dict]) -> Check:
    """The straggler claims the scenario golden suite gates.

    Delays are drawn once per (seed, flow) and scale linearly in the
    jitter axis, so overhead must be monotone in jitter everywhere.  At
    full bandwidth the straggler tail passes straight into t_overhead
    (the sync was ready-time-bound already); in the bandwidth-bound
    regime the transmission queue absorbs most of it — the overlap
    argument the gradient-compression follow-up turns on.  Zero-jitter
    cells must be bit-exact with a ``simulate`` that never saw the axis.
    """
    over = _by(cells, "model", "bandwidth_gbps", "scheduler", "jitter_ms",
               value="t_overhead")
    jits = sorted({k[3] for k in over})
    hi = jits[-1]
    mono = all(over[(m, bw, s, a)] <= over[(m, bw, s, b)] + 1e-9
               for (m, bw, s, _) in over for a, b in zip(jits, jits[1:]))
    tail = all(over[(m, 100.0, s, hi)] > over[(m, 100.0, s, 0.0)] + 1e-4
               for (m, bw, s, _) in over if bw == 100.0)
    damp = all(over[(m, 10.0, "chunked", hi)]
               - over[(m, 10.0, "chunked", 0.0)]
               < over[(m, 100.0, "chunked", hi)]
               - over[(m, 100.0, "chunked", 0.0)]
               for m in ("resnet50", "resnet101"))
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    from repro_torch.experiments.spec import axis_value
    base = [c for c in cells if axis_value(c, "jitter_ms") == 0.0
            and c["model"] == "vgg16"]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"], scheduler=c["scheduler"],
                         n_chunks=8).t_sync == c["t_sync"]
                for c in base)
    return {"overhead_monotone_in_jitter": mono,
            "jitter_tail_hits_full_bw_overhead": tail,
            "queue_absorbs_jitter_when_bw_bound": damp,
            "jitter0_matches_simulate_bitwise": exact}


def _compression(cells: Sequence[Dict]) -> Check:
    """The compression-regime claims the golden suite gates.

    Compression is priced (encode -> wire -> decode with kernel-calibrated
    compute), not a free byte divisor, so the gated claims are exactly the
    ones the divisor cannot express:

    - a ``codec=none`` cell is bit-exact with a ``simulate`` call that
      never heard of the axis (the codec path is a pass, not a rewrite);
    - wire bytes are monotone non-increasing in the codec's wire ratio
      (none >= int8 >= topk:8 >= ternary), per cell twin;
    - every real-codec cell spends strictly positive encode+decode GPU
      time (``codec_compute_s > 0``) — nothing is free;
    - the size-adaptive policy's wire bytes land between the none and
      int8 twins (it compresses only the large buckets);
    - the fig13 regimes come out as the paper + follow-ups predict:
      compression *wins* at 10 Gbps (network-bound) and is *pure
      overhead* at 100 Gbps (compute-bound baseline).
    """
    from repro_torch.core.codec import (REGIME_PURE_OVERHEAD, REGIME_WINS,
                                  classify_regime)
    from repro_torch.experiments.spec import axis_value
    by = {(c["model"], c["bandwidth_gbps"], c["scheduler"],
           axis_value(c, "n_jobs"), axis_value(c, "codec")): c
          for c in cells}
    # wire ratio order: none (1x) < int8 (~3.9x) < topk:8 (8x) < ternary
    order = ("none", "int8", "topk:8", "ternary")
    wire = {k: c["wire_bytes_per_worker"] for k, c in by.items()}
    mono = all(wire[(m, bw, s, j, a)] >= wire[(m, bw, s, j, b)] - 1e-9
               for (m, bw, s, j, cd) in by if cd == "none"
               for a, b in zip(order, order[1:]))
    compute_pos = all(c.get("codec_compute_s", 0.0) > 0.0
                      for k, c in by.items() if k[4] != "none")
    adaptive_between = all(
        wire[(m, bw, s, j, "int8")] - 1e-9
        <= wire[(m, bw, s, j, "size-adaptive")]
        <= wire[(m, bw, s, j, "none")] + 1e-9
        for (m, bw, s, j, cd) in by if cd == "size-adaptive")

    def regime(model: str, bw: float, codec: str) -> str:
        none = by[(model, bw, "fifo", 1, "none")]
        c = by[(model, bw, "fifo", 1, codec)]
        return classify_regime(c["t_overhead"], none["t_overhead"],
                               none["t_batch"], c["codec_compute_s"])

    wins_10g = all(regime(m, 10.0, "int8") == REGIME_WINS
                   for m in ("resnet50", "vgg16"))
    pure_100g = all(regime(m, 100.0, cd) == REGIME_PURE_OVERHEAD
                    for m in ("resnet50", "vgg16")
                    for cd in ("int8", "ternary"))

    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    base = [c for c in cells if axis_value(c, "codec") == "none"
            and axis_value(c, "n_jobs") == 1]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"], scheduler=c["scheduler"],
                         n_chunks=8).t_sync == c["t_sync"]
                for c in base)
    return {"codec_none_matches_simulate_bitwise": exact,
            "wire_bytes_monotone_in_ratio": mono,
            "codec_compute_strictly_positive": compute_pos,
            "size_adaptive_wire_between_none_and_int8": adaptive_between,
            "compression_wins_at_10g": wins_10g,
            "pure_overhead_at_100g": pure_100g}


def _churn(cells: Sequence[Dict]) -> Check:
    """The unreliable-world claims the churn golden suite gates.

    - a zero-fault cell (``fault_model="none"``, no churn, no skew) is
      bit-exact with a ``simulate`` call that never heard of the fault
      axes — the null model is a bypass, not a rewrite;
    - at fixed seed and no churn, overhead is monotone in the slowdown
      scale (``none <= slowdown:1 <= slowdown:5``): the exponential
      draws are shared across the sweep and scale linearly.  Under
      active churn the claim is deliberately *not* gated — the slowdown
      stretches the iteration horizon, which moves the churn draw times
      and can reorder which flows a dropout catches in flight;
    - bandwidth skew only adds wire work (factors are ``1 + skew *
      Exp(1) >= 1``), so at no churn overhead is monotone in the skew
      axis too;
    - churn never helps: every churned cell's t_sync is >= its
      churn-free twin's (drops cancel pending flows, but the re-bucket
      stalls and restarts dominate at the gated seed);
    - priority never loses to fifo on t_overhead, fault axes included —
      the engine re-admits survivors in IR order under either schedule;
    - a fully-faulted cell replays bit-exact through a direct
      ``simulate`` call with the same fault kwargs (the determinism
      contract: draws depend only on ``(fault_seed, stream, n)``).
    """
    from repro_torch.experiments.spec import axis_value
    by = {(c["model"], c["bandwidth_gbps"], axis_value(c, "scheduler"),
           axis_value(c, "n_rails"), axis_value(c, "fault_model"),
           axis_value(c, "churn_rate"), axis_value(c, "worker_bw_skew")): c
          for c in cells}
    over = {k: c["t_overhead"] for k, c in by.items()}
    fms = ("none", "slowdown:1", "slowdown:5")
    mono_slow = all(
        over[(m, bw, s, r, a, 0.0, sk)] <= over[(m, bw, s, r, b, 0.0, sk)]
        + 1e-9
        for (m, bw, s, r, fm, cr, sk) in by if fm == "none" and cr == 0.0
        for a, b in zip(fms, fms[1:]))
    mono_skew = all(
        over[(m, bw, s, r, fm, 0.0, 0.0)] <= over[(m, bw, s, r, fm, 0.0, 0.5)]
        + 1e-9
        for (m, bw, s, r, fm, cr, sk) in by if sk == 0.0 and cr == 0.0)
    churn_hurts = all(
        by[(m, bw, s, r, fm, 0.64, sk)]["t_sync"]
        >= by[(m, bw, s, r, fm, 0.0, sk)]["t_sync"] - 1e-9
        for (m, bw, s, r, fm, cr, sk) in by if cr == 0.0)
    pri_ok = all(over[(m, bw, "priority", r, fm, cr, sk)]
                 <= over[(m, bw, "fifo", r, fm, cr, sk)] + 1e-9
                 for (m, bw, s, r, fm, cr, sk) in by if s == "fifo")
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    base = [c for c in cells if axis_value(c, "fault_model") == "none"
            and axis_value(c, "churn_rate") == 0.0
            and axis_value(c, "worker_bw_skew") == 0.0
            and c["model"] == "vgg16"]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"],
                         scheduler=axis_value(c, "scheduler"), n_chunks=8,
                         n_rails=axis_value(c, "n_rails")).t_sync
                == c["t_sync"]
                for c in base)
    # fault_seed=2027 is the registered churn grid's seed (grids.py), same
    # convention as the other validators hardcoding their grid's n_chunks
    hot = by[("vgg16", 10.0, "priority", 2, "slowdown:5", 0.64, 0.5)]
    replay = simulate(from_cnn("vgg16"), n_workers=hot["n_workers"],
                      bandwidth=hot["bandwidth_gbps"] * GBPS,
                      transport=hot["transport"], scheduler="priority",
                      n_chunks=8, n_rails=2, fault_model="slowdown:5",
                      churn_rate=0.64, worker_bw_skew=0.5,
                      fault_seed=2027).t_sync == hot["t_sync"]
    return {"zero_fault_matches_simulate_bitwise": exact,
            "overhead_monotone_in_slowdown_no_churn": mono_slow,
            "overhead_monotone_in_bw_skew_no_churn": mono_skew,
            "churn_never_helps_t_sync": churn_hurts,
            "priority_overhead_le_fifo_under_faults": pri_ok,
            "faulted_cell_replays_bitwise": replay}


def _fabric(cells: Sequence[Dict]) -> Check:
    """The fabric-lowering claims the fabric golden suite gates.

    - a 1:1 cell is *bitwise* identical to a ``simulate`` call that never
      heard of the fabric axes — at 1:1 the uplink can never bind, so
      :meth:`repro_torch.core.fabric.Fabric.path` elides it and the original
      single-link engine runs verbatim (the elision contract);
    - scaling is monotone non-increasing in oversubscription at every
      (model, bandwidth, topology) point: a thinner uplink can only slow
      the collective down;
    - hierarchical never loses to the flat ring at 4:1 — rack-local
      reduction puts only the leader on the spine (uplink multiplicity
      1 <= capacity 1 at 4:1 with 4 hosts/ToR), so it dodges the
      oversubscription the striped ring pays 4x for.
    """
    from repro_torch.experiments.spec import axis_value
    by = {(c["model"], c["bandwidth_gbps"], c["topology"],
           axis_value(c, "oversubscription")): c for c in cells}
    ovs = sorted({k[3] for k in by})
    sf = {k: c["scaling_factor"] for k, c in by.items()}
    mono = all(sf[(m, bw, t, b)] <= sf[(m, bw, t, a)] + 1e-9
               for (m, bw, t, _) in by for a, b in zip(ovs, ovs[1:]))
    hier_ok = all(by[(m, bw, "hierarchical", 4.0)]["t_overhead"]
                  <= by[(m, bw, "ring", 4.0)]["t_overhead"] + 1e-9
                  for (m, bw, t, ov) in by if t == "ring" and ov == 4.0)
    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    flat = [c for c in cells if axis_value(c, "oversubscription") == 1.0]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"],
                         topology=c["topology"]).t_sync == c["t_sync"]
                for c in flat)
    return {"oversub1_matches_flat_simulate_bitwise": exact,
            "scaling_monotone_nonincreasing_in_oversub": mono,
            "hierarchical_overhead_le_ring_at_4to1": hier_ok}


def _wan(cells: Sequence[Dict]) -> Check:
    """The lossy-transport claims the wan golden suite gates.

    - a ``link_profile="none"`` cell is *bitwise* identical to a
      ``simulate`` call that never heard of the axis — the null profile
      returns the untouched flow objects and draws no retx events;
    - t_sync is monotone non-decreasing in the loss axis at fixed rtt:
      the deterministic wire inflation 1/(1-loss) grows with loss, and
      the retx thinning gate keeps a loss-*superset* of the same timed
      candidate events (see :func:`repro_torch.core.transport.retx_events`);
    - stalls are monotone in the backoff multiplier at fixed timeout
      (``backoff=1 <= backoff=4``): the event set is identical, only
      ``timeout * backoff**k`` scales;
    - the compression-wins region only *widens* with loss: lost bytes
      are retransmitted bytes, so every wire byte a codec saves is
      saved ``1/(1-loss)`` times — the count of (bandwidth, scheduler)
      points where int8 beats its codec=none twin on t_sync is
      non-decreasing along the loss ladder;
    - the lossiest cell replays bit-exact through a direct ``simulate``
      call with the same ``link_profile``/``fault_seed`` (the
      determinism contract: draws depend only on ``(seed, stream, n)``).
    """
    from repro_torch.experiments.spec import axis_value
    by = {(c["model"], c["bandwidth_gbps"], c["scheduler"],
           axis_value(c, "codec"), axis_value(c, "link_profile")): c
          for c in cells}
    ts = {k: c["t_sync"] for k, c in by.items()}
    # the loss ladder at fixed rtt, clean link first
    ladder = ("none",
              "wan:loss=0.001,rtt=20",
              "wan:loss=0.01,rtt=20",
              "wan:loss=0.05,rtt=20")
    mono_loss = all(
        ts[(m, bw, s, cd, a)] <= ts[(m, bw, s, cd, b)] + 1e-9
        for (m, bw, s, cd, lp) in by if lp == "none"
        for a, b in zip(ladder, ladder[1:]))
    b1 = "wan:loss=0.01,rtt=20:timeout=100,backoff=1"
    b4 = "wan:loss=0.01,rtt=20:timeout=100,backoff=4"
    mono_backoff = all(
        ts[(m, bw, s, cd, b1)] <= ts[(m, bw, s, cd, b4)] + 1e-9
        for (m, bw, s, cd, lp) in by if lp == b1)

    def wins(profile: str) -> int:
        return sum(1 for (m, bw, s, cd, lp) in by
                   if cd == "none" and lp == profile
                   and ts[(m, bw, s, "int8", lp)]
                   < ts[(m, bw, s, "none", lp)] - 1e-12)

    w = [wins(p) for p in ladder]
    wins_widen = all(a <= b for a, b in zip(w, w[1:]))

    from repro_torch.core.simulator import simulate
    from repro_torch.core.timeline import from_cnn
    from repro_torch.core.transport import GBPS
    clean = [c for c in cells if axis_value(c, "link_profile") == "none"
             and axis_value(c, "codec") == "none"]
    exact = all(simulate(from_cnn(c["model"]), n_workers=c["n_workers"],
                         bandwidth=c["bandwidth_gbps"] * GBPS,
                         transport=c["transport"], scheduler=c["scheduler"],
                         n_chunks=8).t_sync == c["t_sync"]
                for c in clean)
    # fault_seed=2029 is the registered wan grid's seed (grids.py), same
    # convention as _churn hardcoding its grid's seed and n_chunks
    hot = by[("resnet50", 10.0, "priority", "int8",
              "wan:loss=0.05,rtt=20")]
    replay = simulate(from_cnn("resnet50"), n_workers=hot["n_workers"],
                      bandwidth=hot["bandwidth_gbps"] * GBPS,
                      transport=hot["transport"], scheduler="priority",
                      n_chunks=8, codec="int8", fault_seed=2029,
                      link_profile="wan:loss=0.05,rtt=20"
                      ).t_sync == hot["t_sync"]
    return {"zero_loss_matches_simulate_bitwise": exact,
            "t_sync_monotone_in_loss": mono_loss,
            "stalls_monotone_in_backoff": mono_backoff,
            "compression_wins_region_widens_with_loss": wins_widen,
            "lossiest_cell_replays_bitwise": replay}


VALIDATORS: Dict[str, Callable[[Sequence[Dict]], Check]] = {
    "paper-fig1": _fig1,
    "paper-fig3": _fig3,
    "paper-fig4": _fig4,
    "paper-fig6": _fig6,
    "paper-fig7": _fig7,
    "paper-fig8": _fig8,
    "paper-fig9": _fig9,
    "scheduler-suite": _scheduler_suite,
    "xl-bandwidth": _xl_bandwidth,
    "xl-sched": _xl_sched,
    "xl-contention": _xl_contention,
    "xxl-contention": _xxl_contention,
    "multirail": _multirail,
    "straggler": _straggler,
    "compression": _compression,
    "churn": _churn,
    "fabric": _fabric,
    "wan": _wan,
}


def validate(grid_name: str, cells: Sequence[Dict]) -> Check:
    # a hardened sweep records retry-exhausted cells as {"failed": true,
    # ...} instead of aborting; validators see only the completed cells,
    # and the degradation itself lands as an always-False check so compare
    # flags the artifact rather than trusting partial claims.  Complete
    # sweeps (every golden) never hit this branch, so their validation
    # dicts — and hashes — are untouched.
    ok = [c for c in cells if not c.get("failed")]
    fn = VALIDATORS.get(grid_name)
    degraded = len(ok) != len(cells)
    try:
        # bool() strips numpy bool scalars, which are not JSON serializable
        out = {k: bool(v) for k, v in fn(ok).items()} if fn else {}
    except Exception:
        # a validator indexing a twin cell that failed: only tolerable on
        # a degraded sweep — on a complete one it is a real bug
        if not degraded:
            raise
        out = {"validator_completed": False}
    if degraded:
        out["no_failed_cells"] = False
    return out
