"""Network-transport models: how much of the physical bandwidth the
communication phase actually achieves.

This is the paper's central object of study — measured Horovod-over-TCP
leaves a 100 Gbps NIC at <32 Gbps utilization, and the what-if analysis
asks what happens at 100 %.  We model a transport as an *effective
bandwidth curve* ``effective(bw) -> bytes/s``:

- ``ideal``        full utilization (the paper's what-if),
- ``horovod_tcp``  calibrated to the paper's Fig. 3/4 measurements:
                   full utilization up to ~3 Gbps, a soft knee, and a hard
                   ~32 Gbps ceiling at 100 Gbps NICs,
- ``tpu_ici``      near-ideal with a small per-hop protocol overhead
                   (XLA-driven ICI achieves ~95 % of peak in practice).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Union

GBPS = 1e9 / 8.0  # bytes/s per Gbps


@dataclass(frozen=True)
class Transport:
    name: str
    curve: Callable[[float], float]
    per_tensor_overhead: float = 0.0   # coordination latency per gradient tensor

    def effective(self, bw: float) -> float:
        return self.curve(bw)

    def utilization(self, bw: float) -> float:
        return self.effective(bw) / bw if bw > 0 else 0.0


def _ideal(bw: float) -> float:
    return bw


# Calibration targets from the paper:
#   Fig. 4 — 1 Gbps (and 10 Gbps) fully utilized; a 100 Gbps NIC peaks below
#            32 Gbps during the communication phase.
#   Fig. 3 — scaling plateaus after 25 Gbps.
#   Fig. 1 — 2-server scaling 75 / 69 / 56 % (RN50 / RN101 / VGG16).
# Sharp-knee saturating cap:  eff = bw*cap / (bw^k + cap^k)^(1/k), k=4 —
# ~bw below the cap, ~cap above it.  On top of the bandwidth ceiling,
# Horovod's tensor negotiation costs ~250 us per gradient tensor (this is
# why ResNet101, with ~2x the tensors of ResNet50, measures *worse* despite
# a mid-sized model).
_HOROVOD_CAP = 30.0 * GBPS
_KNEE = 4.0


def _horovod_tcp(bw: float) -> float:
    return bw * _HOROVOD_CAP / (bw ** _KNEE + _HOROVOD_CAP ** _KNEE) ** (1.0 / _KNEE)


def _tpu_ici(bw: float) -> float:
    return 0.95 * bw


TRANSPORTS: Dict[str, Transport] = {
    "ideal": Transport("ideal", _ideal),
    "horovod_tcp": Transport("horovod_tcp", _horovod_tcp,
                             per_tensor_overhead=250e-6),
    "tpu_ici": Transport("tpu_ici", _tpu_ici, per_tensor_overhead=0.0),
}


def get_transport(name: str) -> Transport:
    return TRANSPORTS[name]


# ---------------------------------------------------------------------------
# lossy links: loss / retransmission / backoff as a priced, seeded axis
# ---------------------------------------------------------------------------
#
# The transport curves above say how much of the NIC a *clean* datacenter
# link yields; a LinkProfile says what happens when the link itself is not
# clean (WAN hops, congested uplinks).  It prices two effects:
#
# - deterministically, in the lowering (`schedule.plan_to_flows` /
#   `plan_to_flow_batch`): every flow's wire work inflates by the expected
#   retransmission factor 1/(1-loss), and the propagation RTT joins the
#   fixed post-wire latency — the fluid-model mean of the loss process;
# - stochastically, in the engine: seeded retransmission-timeout events
#   (`retx_events`) stall the owning job for `timeout * backoff^k` and pull
#   its in-flight flow back, riding the `_RETX` calendar kind in
#   `core.events` (same fence machinery as `_FAULT`, so bulk commit stays
#   bit-identical).
#
# The null profile (loss=0, rtt=0) must bypass both bitwise — the contract
# every pre-WAN golden artifact rides on.

@dataclass(frozen=True)
class LinkProfile:
    """A lossy-link regime: propagation delay + Bernoulli segment loss.

    ``loss`` is the per-segment loss probability, ``rtt`` the round-trip
    propagation delay in *seconds*, ``timeout`` the retransmission timeout
    (seconds), ``backoff`` the exponential-backoff multiplier applied per
    consecutive loss of the same segment, ``segment`` the wire segment
    size in bytes (the unit the Bernoulli process draws over).
    """

    loss: float = 0.0
    rtt: float = 0.0
    timeout: float = 0.2
    backoff: float = 2.0
    segment: float = 64e3

    @property
    def is_null(self) -> bool:
        return self.loss <= 0.0 and self.rtt <= 0.0


NULL_LINK = LinkProfile()

# share of lost segments whose recovery needs a full RTO stall rather than
# an in-window fast retransmit (those are already priced by the 1/(1-loss)
# wire inflation); keeps the event count physical instead of per-segment
RTO_SHARE = 0.05
# fixed candidate-event pool per (seed, stream): a thinning gate keeps a
# loss-monotone *subset* of the same draws, so raising the loss axis only
# adds events (never reshuffles them) — what the monotonicity validators
# gate on
_RETX_POOL = 256
_RETX_MAX_BACKOFF = 6
# RTO episodes come from *burst* loss: the congestion that dropped the
# first segment persists across its retransmission, so the conditional
# loss of a retry is far above the marginal rate.  We model the retry
# loss as loss**_RETRY_LOSS_EXP (0.01 marginal -> ~0.32 conditional),
# which keeps the backoff depth monotone in the loss axis while giving
# the backoff multiplier a real lever to act on.
_RETRY_LOSS_EXP = 0.25


def parse_link_profile(spec: Union[str, LinkProfile, None]) -> LinkProfile:
    """``"none"`` | ``"wan:loss=p,rtt=ms[:timeout=ms,backoff=x]"``.

    ``loss`` is a probability, ``rtt``/``timeout`` are milliseconds,
    ``backoff`` a multiplier, ``segment`` bytes.  Sections after ``wan``
    are ``key=value`` pairs separated by ``,`` (the ``:`` between sections
    is cosmetic — any pair may appear in any section).  Mirrors
    :func:`repro_torch.core.faults.parse_fault_model`: unknown names raise.
    """
    if isinstance(spec, LinkProfile):
        return spec
    if spec is None or spec == "" or spec == "none":
        return NULL_LINK
    head, _, rest = spec.partition(":")
    if head != "wan" or not rest:
        raise ValueError(f"unknown link profile {spec!r} "
                         "(expected 'none' or 'wan:loss=p,rtt=ms[...]')")
    kw: Dict[str, float] = {}
    for section in rest.split(":"):
        for pair in section.split(","):
            if not pair:
                continue
            key, eq, val = pair.partition("=")
            if not eq:
                raise ValueError(
                    f"link profile field {pair!r} is not key=value")
            try:
                kw[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"link profile field {key!r} has non-numeric "
                    f"value {val!r}") from None
    unknown = set(kw) - {"loss", "rtt", "timeout", "backoff", "segment"}
    if unknown:
        raise ValueError(
            f"unknown link profile field(s) {sorted(unknown)} in {spec!r}")
    loss = kw.get("loss", 0.0)
    if not 0.0 <= loss < 1.0:
        raise ValueError(f"loss must be in [0, 1), got {loss}")
    return LinkProfile(
        loss=loss,
        rtt=kw.get("rtt", 0.0) / 1e3,
        timeout=kw.get("timeout", 200.0) / 1e3,
        backoff=kw.get("backoff", 2.0),
        segment=kw.get("segment", 64e3))


def retx_events(lp: LinkProfile, total_bytes: float, horizon: float,
                seed: int = 0, stream: int = 0, *,
                job: str = "job0") -> List:
    """Seeded retransmission-timeout stalls over one iteration.

    Returns :class:`repro_torch.core.events.ChurnEvent` entries of kind
    ``"retx"`` (pull-back + stall, no worker cancellation), drawn from
    substream ``(4,)`` of the engine-wide fault RNG so draws depend only
    on ``(seed, stream)`` — the determinism contract shared with
    :mod:`repro_torch.core.faults`.

    Monotonicity by construction (what the ``wan`` validators gate):

    - arrival times come from a fixed :data:`_RETX_POOL`-slot candidate
      pool; a thinning gate keeps slot ``i`` iff ``gate_i < rate/POOL``,
      so a higher loss keeps a *superset* of the same timed slots;
    - the backoff depth inverts a geometric CDF at a pooled uniform:
      ``k = floor(log(u)/log(p_retry))`` with the burst-correlated retry
      loss ``p_retry = loss**_RETRY_LOSS_EXP`` is non-decreasing in
      ``loss`` for a fixed ``u``, and the stall ``timeout * backoff**k``
      is analytic in ``timeout``/``backoff`` — sweeping the backoff axis
      scales stalls without touching the event set.
    """
    from repro_torch.core.events import ChurnEvent, _jitter_stream

    if lp.loss <= 0.0 or total_bytes <= 0.0 or horizon <= 0.0:
        return []
    rng = _jitter_stream(seed, stream, 4)
    times = horizon * rng.random(_RETX_POOL)
    gate = rng.random(_RETX_POOL)
    depth_u = rng.random(_RETX_POOL)
    rate = lp.loss * (total_bytes / lp.segment) * RTO_SHARE
    thin = min(1.0, rate / _RETX_POOL)
    log_retry = _RETRY_LOSS_EXP * math.log(lp.loss)
    out = []
    for i in range(_RETX_POOL):
        if gate[i] >= thin:
            continue
        k = int(min(math.log(max(float(depth_u[i]), 1e-300)) / log_retry,
                    float(_RETX_MAX_BACKOFF)))
        out.append(ChurnEvent(float(times[i]), job, "retx", -1,
                              lp.timeout * lp.backoff ** k))
    out.sort()
    return out
