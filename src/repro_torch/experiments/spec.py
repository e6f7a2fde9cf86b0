"""Declarative experiment specs — the paper's sweep methodology as data.

An :class:`ExperimentSpec` names a cartesian grid over the simulator's axes
(model x servers x bandwidth x transport x compression x topology); the
runner fans the expanded cells out over ``repro_torch.core.simulator.simulate``.
Specs are canonically serializable (sorted-key JSON) and content-addressed
via :meth:`ExperimentSpec.spec_hash`, so an artifact records exactly which
grid produced it and ``compare`` can refuse to diff mismatched sweeps.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field, fields
from itertools import product
from typing import Dict, Sequence, Tuple

SPEC_VERSION = 1

# axis order is part of the stable cell identity — never reorder (new axes
# append at the end, with a default recorded in AXIS_DEFAULTS so artifacts
# written before the axis existed still index consistently)
CELL_AXES = ("model", "n_servers", "bandwidth_gbps", "transport",
             "compression_ratio", "topology", "scheduler", "n_jobs",
             "n_rails", "jitter_ms", "codec", "fault_model", "churn_rate",
             "worker_bw_skew", "fabric", "oversubscription", "link_profile")

AXIS_DEFAULTS = {"scheduler": "fifo", "n_jobs": 1, "n_rails": 1,
                 "jitter_ms": 0.0, "codec": "none", "fault_model": "none",
                 "churn_rate": 0.0, "worker_bw_skew": 0.0,
                 "fabric": "none", "oversubscription": 1.0,
                 "link_profile": "none"}

# axes added after the first golden artifacts shipped: omitted from
# serialized cells/specs while at their default, so pre-axis artifacts stay
# byte-identical and spec hashes (the CI regression gate) never drift for
# grids that do not sweep them
_ELIDED_AT_DEFAULT = {"n_jobs": 1, "n_rails": 1, "jitter_ms": 0.0,
                      "codec": "none", "fault_model": "none",
                      "churn_rate": 0.0, "worker_bw_skew": 0.0,
                      "fabric": "none", "oversubscription": 1.0,
                      "link_profile": "none"}


def axis_value(cell: Dict, axis: str):
    """Read ``axis`` from a serialized cell, defaulting elided/new axes.

    The one sanctioned way to index recorded cells: axes appended after an
    artifact was written (or elided at their default) fall back to
    ``AXIS_DEFAULTS`` instead of raising."""
    if axis in AXIS_DEFAULTS:
        return cell.get(axis, AXIS_DEFAULTS[axis])
    return cell[axis]


@dataclass(frozen=True)
class Cell:
    """One point of an expanded grid (the arguments of a single simulate)."""

    model: str
    n_servers: int
    bandwidth_gbps: float
    transport: str
    compression_ratio: float
    topology: str
    scheduler: str = "fifo"
    n_jobs: int = 1                 # co-located jobs contending for the link
    n_rails: int = 1                # rails splitting the aggregate bandwidth
    jitter_ms: float = 0.0          # mean per-flow flush delay (stragglers)
    codec: str = "none"             # gradient-compression codec (core.codec)
    fault_model: str = "none"       # worker-correlated slowdown (core.faults)
    churn_rate: float = 0.0         # expected dropout events per iteration
    worker_bw_skew: float = 0.0     # per-worker bandwidth asymmetry scale
    fabric: str = "none"            # datacenter fabric (core.fabric)
    oversubscription: float = 1.0   # ToR uplink oversubscription ratio
    link_profile: str = "none"      # lossy-link regime (core.transport)

    def key(self) -> Tuple:
        return tuple(getattr(self, a) for a in CELL_AXES)

    @property
    def weight(self) -> int:
        """Scheduling weight: a contention cell runs ``n_jobs`` co-located
        jobs through one engine call, so it costs roughly ``n_jobs`` plain
        cells.  The runner's auto-executor sums these instead of counting
        cells, so a small-by-count grid of 10k-flow contention cells still
        lands on the process pool."""
        return max(int(self.n_jobs), 1)

    def to_dict(self) -> Dict:
        return {a: getattr(self, a) for a in CELL_AXES
                if _ELIDED_AT_DEFAULT.get(a, ...) != getattr(self, a)}

    @staticmethod
    def from_dict(d: Dict) -> "Cell":
        return Cell(**{a: d.get(a, AXIS_DEFAULTS[a]) if a in AXIS_DEFAULTS
                       else d[a] for a in CELL_AXES})


@dataclass(frozen=True)
class ExperimentSpec:
    """A named sweep grid plus the fixed simulator context.

    Axis fields hold the *values to sweep* (tuples); the remaining fields
    (GPUs per server, add-estimator, fusion-buffer config) are held constant
    across the grid, matching the paper's setup (p3dn.24xlarge, V100).
    """

    name: str
    models: Tuple[str, ...] = ("resnet50", "resnet101", "vgg16")
    n_servers: Tuple[int, ...] = (8,)
    bandwidth_gbps: Tuple[float, ...] = (100.0,)
    transport: Tuple[str, ...] = ("ideal",)
    compression_ratio: Tuple[float, ...] = (1.0,)
    topology: Tuple[str, ...] = ("ring",)
    scheduler: Tuple[str, ...] = ("fifo",)
    n_jobs: Tuple[int, ...] = (1,)      # contention axis (fair-share link)
    n_rails: Tuple[int, ...] = (1,)     # multi-rail axis (aggregate bw split)
    jitter_ms: Tuple[float, ...] = (0.0,)   # straggler axis (mean flush delay)
    codec: Tuple[str, ...] = ("none",)  # compression-codec axis (core.codec)
    fault_model: Tuple[str, ...] = ("none",)    # fault axis (core.faults)
    churn_rate: Tuple[float, ...] = (0.0,)  # dropout/rejoin rate axis
    worker_bw_skew: Tuple[float, ...] = (0.0,)  # asymmetric-bw axis
    fabric: Tuple[str, ...] = ("none",)     # fabric axis (core.fabric)
    oversubscription: Tuple[float, ...] = (1.0,)    # ToR uplink oversub
    link_profile: Tuple[str, ...] = ("none",)   # lossy-link axis (transport)
    gpus_per_server: int = 8            # p3dn.24xlarge
    addest: str = "v100"                # v100 | h100
    fusion_buffer_mb: float = 64.0      # paper's fusion buffer
    timeout_ms: float = 5.0             # paper's fusion timeout
    sched_chunks: int = 4               # chunks/bucket for pipelined scheds
    rail_policy: str = "round-robin"    # CommOp -> rail assignment policy
    jitter_seed: int = 0                # seed of the straggler perturbation
    error_feedback: bool = False        # EF-SGD residual cost on lossy codecs
    fault_seed: int = 0                 # seed of the fault-model draws

    # spec fields added after the first golden artifacts shipped, elided
    # from canonical JSON at their default (same contract as the elided
    # axes: pre-existing spec hashes never drift)
    _ELIDED_FIELDS = (("n_jobs", (1,)), ("n_rails", (1,)),
                      ("jitter_ms", (0.0,)), ("rail_policy", "round-robin"),
                      ("jitter_seed", 0), ("codec", ("none",)),
                      ("error_feedback", False), ("fault_model", ("none",)),
                      ("churn_rate", (0.0,)), ("worker_bw_skew", (0.0,)),
                      ("fault_seed", 0), ("fabric", ("none",)),
                      ("oversubscription", (1.0,)),
                      ("link_profile", ("none",)))

    def __post_init__(self):
        # tolerate lists (e.g. straight from JSON) by freezing to tuples
        for f in ("models", "n_servers", "bandwidth_gbps", "transport",
                  "compression_ratio", "topology", "scheduler", "n_jobs",
                  "n_rails", "jitter_ms", "codec", "fault_model",
                  "churn_rate", "worker_bw_skew", "fabric",
                  "oversubscription", "link_profile"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))

    # -- grid expansion ------------------------------------------------------

    def expand(self) -> Tuple[Cell, ...]:
        """Cartesian product in stable axis order (model outermost)."""
        return tuple(Cell(m, int(n), float(bw), t, float(r), topo, s, int(j),
                          int(nr), float(jm), cd, fml, float(cr), float(sk),
                          fb, float(ov), lp)
                     for m, n, bw, t, r, topo, s, j, nr, jm, cd, fml, cr, sk,
                     fb, ov, lp
                     in product(
                         self.models, self.n_servers, self.bandwidth_gbps,
                         self.transport, self.compression_ratio,
                         self.topology, self.scheduler, self.n_jobs,
                         self.n_rails, self.jitter_ms, self.codec,
                         self.fault_model, self.churn_rate,
                         self.worker_bw_skew, self.fabric,
                         self.oversubscription, self.link_profile))

    @property
    def n_cells(self) -> int:
        return (len(self.models) * len(self.n_servers)
                * len(self.bandwidth_gbps) * len(self.transport)
                * len(self.compression_ratio) * len(self.topology)
                * len(self.scheduler) * len(self.n_jobs)
                * len(self.n_rails) * len(self.jitter_ms)
                * len(self.codec) * len(self.fault_model)
                * len(self.churn_rate) * len(self.worker_bw_skew)
                * len(self.fabric) * len(self.oversubscription)
                * len(self.link_profile))

    @property
    def workload_units(self) -> int:
        """Sum of :attr:`Cell.weight` over the grid, without expanding it.

        The executor-dispatch measure: every axis combination repeats once
        per ``n_jobs`` value, so the sum factors into (combinations
        without the contention axis) x (sum of per-value weights)."""
        per_combo = sum(max(int(j), 1) for j in self.n_jobs)
        return (self.n_cells // max(len(self.n_jobs), 1)) * per_combo

    # -- serialization -------------------------------------------------------

    def to_dict(self) -> Dict:
        d = asdict(self)
        for f, default in self._ELIDED_FIELDS:
            # elided while at its default: specs written before the axis
            # (or knob) existed keep their canonical JSON — and hence spec
            # hash, the golden-artifact gate — unchanged
            if getattr(self, f) == default:
                del d[f]
        d["spec_version"] = SPEC_VERSION
        return d

    @staticmethod
    def from_dict(d: Dict) -> "ExperimentSpec":
        d = dict(d)
        d.pop("spec_version", None)
        known = {f.name for f in fields(ExperimentSpec)}
        return ExperimentSpec(**{k: v for k, v in d.items() if k in known})

    def canonical_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def spec_hash(self) -> str:
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()[:16]
