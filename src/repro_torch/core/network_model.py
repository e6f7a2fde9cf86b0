"""All-reduce cost models (the paper's §3.1 transmission/reduction model,
plus TPU-topology extensions).

Paper model (flat ring, reduce-scatter + all-gather):
    transmission(S, N, bw) = (2 * S * (N - 1) / N) / bw
    reduction(S, N)        = (N - 1) * AddEst(S / N)

Sizes in bytes, bandwidth in bytes/s, times in seconds.

``compression_ratio`` on these models is the paper's §3.2 free byte
divisor — it scales transmission with zero encode/decode cost.  It is
kept for the legacy figures (fig8) and stays bit-identical, but new work
should prefer the priced codec axis (``repro_torch.core.codec``): the
simulator routes ``compression_ratio`` through the parametric ratio
codec (``get_codec("none", compression_ratio=r)``), which reproduces
this divisor exactly while making the zero-compute assumption explicit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.addest import AddEst


def ring_transmission_time(size: int, n: int, bw: float) -> float:
    """Paper's transmission term for a flat N-worker ring all-reduce."""
    if n <= 1:
        return 0.0
    return (2.0 * size * (n - 1) / n) / bw


def ring_reduction_time(size: int, n: int, addest: AddEst) -> float:
    """Paper's vector-add term: (N-1) adds of S/N-sized chunks."""
    if n <= 1:
        return 0.0
    return (n - 1) * addest(size / n)


# Vectorized twins over a float64 size column.  Exactness contract (all the
# ``*_v``/``time_v`` functions below): elementwise numpy float64 arithmetic
# performs the scalar expressions' operations in the scalar expressions'
# order, so ``f_v(sizes)[i]`` is bit-identical to ``f(sizes[i])`` — the
# columnar lowering (:func:`repro_torch.core.schedule.plan_to_flow_batch`)
# produces the same float values as the per-op loop, not approximations.

def ring_transmission_time_v(sizes: np.ndarray, n: int,
                             bw: float) -> np.ndarray:
    if n <= 1:
        return np.zeros_like(sizes)
    return (2.0 * sizes * (n - 1) / n) / bw


def ring_reduction_time_v(sizes: np.ndarray, n: int,
                          addest: AddEst) -> np.ndarray:
    if n <= 1:
        return np.zeros_like(sizes)
    return (n - 1) * addest.batch(sizes / n)


@dataclass(frozen=True)
class RingAllReduce:
    """The paper's cost model: flat ring over ``n`` workers at ``bw`` B/s."""

    n: int
    bw: float
    addest: AddEst
    # paper §3.2: divides transmission only.  Deprecated in favor of the
    # priced codec axis (repro_torch.core.codec) — see the module docstring.
    compression_ratio: float = 1.0
    compress_reduction: bool = False # extended mode: also scales vector-adds

    def time(self, size: int) -> float:
        t = ring_transmission_time(size, self.n, self.bw) / self.compression_ratio
        red = ring_reduction_time(size, self.n, self.addest)
        if self.compress_reduction:
            red /= self.compression_ratio
        return t + red

    def wire_time(self, size: int) -> float:
        """Transmission share of :meth:`time` — scales under link sharing."""
        return ring_transmission_time(size, self.n, self.bw) / self.compression_ratio

    def time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`time`, bit-identical per element."""
        t = ring_transmission_time_v(sizes, self.n, self.bw) \
            / self.compression_ratio
        red = ring_reduction_time_v(sizes, self.n, self.addest)
        if self.compress_reduction:
            red = red / self.compression_ratio
        return t + red

    def wire_time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`wire_time`, bit-identical per element."""
        return ring_transmission_time_v(sizes, self.n, self.bw) \
            / self.compression_ratio

    def wire_bytes(self, size: int) -> float:
        """Bytes each worker actually moves on its NIC for one all-reduce."""
        return (ring_transmission_time(size, self.n, 1.0)
                / max(self.compression_ratio, 1e-9))


@dataclass(frozen=True)
class HierarchicalAllReduce:
    """TPU multi-pod extension: reduce-scatter inside the pod on ICI,
    all-reduce across pods on DCN, all-gather inside the pod.

    in-pod RS:   S*(nd-1)/nd / ici
    cross-pod AR: 2*(S/nd)*(np-1)/np / dcn
    in-pod AG:   S*(nd-1)/nd / ici
    adds: (nd-1) chunk adds in RS + (np-1) adds of S/nd across pods.
    """

    n_pod_devices: int               # chips participating per pod (data axis)
    n_pods: int
    ici_bw: float
    dcn_bw: float
    addest: AddEst
    compression_ratio: float = 1.0   # applied to the cross-pod (DCN) stage

    def time(self, size: int) -> float:
        nd, np_ = self.n_pod_devices, self.n_pods
        t = 0.0
        if nd > 1:
            t += 2.0 * size * (nd - 1) / nd / self.ici_bw
            t += (nd - 1) * self.addest(size / nd)
        if np_ > 1:
            shard = size / max(nd, 1)
            t += (2.0 * shard * (np_ - 1) / np_ / self.dcn_bw) / self.compression_ratio
            t += (np_ - 1) * self.addest(shard / np_)
        return t

    def wire_time(self, size: int) -> float:
        nd, np_ = self.n_pod_devices, self.n_pods
        t = 0.0
        if nd > 1:
            t += 2.0 * size * (nd - 1) / nd / self.ici_bw
        if np_ > 1:
            shard = size / max(nd, 1)
            t += (2.0 * shard * (np_ - 1) / np_ / self.dcn_bw) / self.compression_ratio
        return t

    def time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`time`, bit-identical per element (the
        accumulation adds the same stage terms in the same order)."""
        nd, np_ = self.n_pod_devices, self.n_pods
        t = np.zeros_like(sizes)
        if nd > 1:
            t = t + 2.0 * sizes * (nd - 1) / nd / self.ici_bw
            t = t + (nd - 1) * self.addest.batch(sizes / nd)
        if np_ > 1:
            shard = sizes / max(nd, 1)
            t = t + (2.0 * shard * (np_ - 1) / np_ / self.dcn_bw) \
                / self.compression_ratio
            t = t + (np_ - 1) * self.addest.batch(shard / np_)
        return t

    def wire_time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`wire_time`, bit-identical per element."""
        nd, np_ = self.n_pod_devices, self.n_pods
        t = np.zeros_like(sizes)
        if nd > 1:
            t = t + 2.0 * sizes * (nd - 1) / nd / self.ici_bw
        if np_ > 1:
            shard = sizes / max(nd, 1)
            t = t + (2.0 * shard * (np_ - 1) / np_ / self.dcn_bw) \
                / self.compression_ratio
        return t

    def wire_bytes(self, size: int) -> float:
        """Bytes on the *ICI* link (the bandwidth under study); the DCN stage
        moves the 1/nd shard and is reported via :meth:`wire_bytes_dcn`."""
        nd, np_ = self.n_pod_devices, self.n_pods
        if nd > 1:
            return 2.0 * size * (nd - 1) / nd
        return self.wire_bytes_dcn(size)

    def wire_bytes_dcn(self, size: int) -> float:
        nd, np_ = self.n_pod_devices, self.n_pods
        if np_ <= 1:
            return 0.0
        shard = size / max(nd, 1)
        return (2.0 * shard * (np_ - 1) / np_
                / max(self.compression_ratio, 1e-9))


@dataclass(frozen=True)
class TreeAllReduce:
    """Binomial-tree all-reduce: reduce up the tree, broadcast back down.

    ``ceil(log2 N)`` sequential reduce steps each move the full S bytes
    over one link and add full-size vectors at the receiving node, then
    the same number of broadcast steps move S back — wire time
    ``2 * ceil(log2 N) * S / bw`` and ``ceil(log2 N)`` full-size adds.
    Latency-optimal but bandwidth-poor versus the ring's ``2S(N-1)/N``
    (the classical trade-off); it earns its place on the fabric axis
    because its edges cross racks just like the ring's, so it pays the
    same oversubscription penalty from a worse baseline.
    """

    n: int
    bw: float
    addest: AddEst
    compression_ratio: float = 1.0   # free §3.2 divisor, transmission only

    @property
    def _steps(self) -> int:
        return int(math.ceil(math.log2(self.n))) if self.n > 1 else 0

    def time(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        steps = self._steps
        t = (2.0 * steps * size / self.bw) / self.compression_ratio
        return t + steps * self.addest(size)

    def wire_time(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        return (2.0 * self._steps * size / self.bw) / self.compression_ratio

    def time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`time`, bit-identical per element."""
        if self.n <= 1:
            return np.zeros_like(sizes)
        steps = self._steps
        t = (2.0 * steps * sizes / self.bw) / self.compression_ratio
        return t + steps * self.addest.batch(sizes)

    def wire_time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`wire_time`, bit-identical per element."""
        if self.n <= 1:
            return np.zeros_like(sizes)
        return (2.0 * self._steps * sizes / self.bw) / self.compression_ratio

    def wire_bytes(self, size: int) -> float:
        """Bytes a tree node moves: S up (reduce) + S down (broadcast),
        once per level it participates in; the root-adjacent links carry
        the full ``2 * steps * S`` stream that bounds the wire time."""
        if self.n <= 1:
            return 0.0
        return 2.0 * self._steps * size / max(self.compression_ratio, 1e-9)


@dataclass(frozen=True)
class SwitchMLAllReduce:
    """Paper §4 what-if: in-network aggregation (SwitchML).

    The programmable switch sums gradient chunks in flight: each worker
    streams its S bytes up while receiving aggregated bytes back on the
    full-duplex link — wire time ~S/bw independent of N (the ~2x over ring
    the SwitchML paper reports) — and the vector adds happen in the switch
    pipeline (no worker-side AddEst term).
    """

    n: int
    bw: float
    addest: AddEst                    # unused; kept for interface parity
    compression_ratio: float = 1.0

    def time(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        return (size / self.bw) / self.compression_ratio

    def wire_time(self, size: int) -> float:
        return self.time(size)        # all wire, no worker-side adds

    def time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`time`, bit-identical per element."""
        if self.n <= 1:
            return np.zeros_like(sizes)
        return (sizes / self.bw) / self.compression_ratio

    def wire_time_v(self, sizes: np.ndarray) -> np.ndarray:
        return self.time_v(sizes)     # all wire, no worker-side adds

    def wire_bytes(self, size: int) -> float:
        """In-network aggregation streams ~S per worker (full duplex),
        independent of N — the point of SwitchML."""
        if self.n <= 1:
            return 0.0
        return float(size) / max(self.compression_ratio, 1e-9)


@dataclass(frozen=True)
class TwoTierParamServer:
    """Paper §4 what-if: parameter-server strategy.

    Each worker pushes S bytes to (sharded) servers and pulls S back:
    2*S/bw on the worker link, but the *server* ingests N shards — with
    servers co-located on the N workers (sharded PS), per-server ingest is
    S/N * N = S, so the bottleneck link carries 2*S*(N-1)/N plus the
    worker-side adds on its 1/N shard, matching ring cost asymptotically
    (the paper's reason for treating all-reduce as representative).
    """

    n: int
    bw: float
    addest: AddEst
    compression_ratio: float = 1.0

    def time(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        wire = (2.0 * size * (self.n - 1) / self.n / self.bw)
        return wire / self.compression_ratio + self.addest(size / self.n) * (self.n - 1)

    def wire_time(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        return (2.0 * size * (self.n - 1) / self.n / self.bw) / self.compression_ratio

    def time_v(self, sizes: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`time`, bit-identical per element."""
        if self.n <= 1:
            return np.zeros_like(sizes)
        wire = (2.0 * sizes * (self.n - 1) / self.n / self.bw)
        return wire / self.compression_ratio \
            + self.addest.batch(sizes / self.n) * (self.n - 1)

    def wire_time_v(self, sizes: np.ndarray) -> np.ndarray:
        if self.n <= 1:
            return np.zeros_like(sizes)
        return (2.0 * sizes * (self.n - 1) / self.n / self.bw) \
            / self.compression_ratio

    def wire_bytes(self, size: int) -> float:
        if self.n <= 1:
            return 0.0
        return (2.0 * size * (self.n - 1) / self.n
                / max(self.compression_ratio, 1e-9))


def make_cost_model(n: int, bw: float, addest: AddEst, *,
                    topology: str = "ring", n_pods: int = 1,
                    dcn_bw: Optional[float] = None,
                    compression_ratio: float = 1.0,
                    compress_reduction: bool = False):
    if topology == "ring":
        return RingAllReduce(n, bw, addest, compression_ratio, compress_reduction)
    if topology == "tree":
        return TreeAllReduce(n, bw, addest, compression_ratio)
    if topology == "hierarchical":
        return HierarchicalAllReduce(n // n_pods, n_pods, bw,
                                     dcn_bw or bw / 2, addest,
                                     compression_ratio)
    if topology == "switchml":
        return SwitchMLAllReduce(n, bw, addest, compression_ratio)
    if topology == "param_server":
        return TwoTierParamServer(n, bw, addest, compression_ratio)
    raise ValueError(topology)
