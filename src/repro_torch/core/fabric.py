"""Datacenter fabric topology: hosts, racks, and oversubscribed uplinks.

The engine's links were born as one shared NIC per job mix; this module
describes the resource a real fleet contends for — a Clos-style fabric
where every host's NIC feeds a top-of-rack (ToR) switch whose uplink into
the spine is *oversubscribed*: ``hosts_per_tor`` NICs share an uplink
provisioned for ``hosts_per_tor / oversubscription`` of their aggregate
rate.  A collective's flows are lowered onto *paths* through that fabric
(:attr:`repro_torch.core.events.FlowSpec.path`), and the engine prices them at
the bottleneck max-min fair share across every link crossed
(:func:`repro_torch.core.events.maxmin_rates`).

Units follow the engine's convention: link capacities are NIC-relative
(the host NIC is 1.0), and a path link repeated ``m`` times encodes
demand multiplicity — the flow consumes ``m`` units of that link's
capacity per unit of rate.

**How collectives map onto the fabric.**  The simulator's representative
flow stands for one host's share of the collective, so the path is the
representative host's route and the multiplicities are how much of each
shared resource the *whole rack* pushes through it while the collective
runs:

- ``ring`` / ``tree``: workers are striped round-robin across racks, so
  every ring edge (or tree edge) crosses racks and all ``hosts_per_tor``
  hosts of the representative rack drive the uplink simultaneously —
  uplink multiplicity ``hosts_per_tor``, hence a lone collective runs at
  ``min(1, 1 / oversubscription)``.
- ``hierarchical``: the rack reduces locally over NICs first and only a
  leader crosses the spine — uplink multiplicity 1, so rack-local
  reduction rides out oversubscription until it exceeds
  ``hosts_per_tor``.

**The elision contract.**  Every flow crosses the NIC with multiplicity
1, so an uplink whose capacity/multiplicity ratio is at least the NIC's
(``uplink_capacity >= demand``) can never be the binding constraint — any
load pattern hits the NIC at least as hard.  :meth:`Fabric.path` drops
such uplinks, collapsing the path to ``(nic,)``; the engine then
normalizes the one-element path into a plain single-link flow and runs
the original code bit-for-bit.  A 1:1 fabric is therefore *bitwise*
identical to the flat topology, which is both the compatibility contract
and the ``fabric`` golden suite's 1:1-vs-flat validator.
"""
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["Fabric", "resolve_fabric", "FABRICS", "DEFAULT_HOSTS_PER_TOR"]

#: Registered fabric names: ``none`` (flat single link — today's model)
#: and ``clos`` (racks of ``hosts_per_tor`` hosts behind oversubscribed
#: ToR uplinks).
FABRICS = ("none", "clos")

DEFAULT_HOSTS_PER_TOR = 4

_NIC_LINK = "nic"
_UPLINK = "up0"


@dataclass(frozen=True)
class Fabric:
    """A symmetric Clos pod: racks of hosts behind oversubscribed uplinks.

    Symmetry means one representative rack suffices: all racks see the
    same load, so the engine models a single NIC link (capacity 1.0, the
    existing default link) plus a single uplink ``up0`` of capacity
    ``hosts_per_tor / oversubscription``.  Co-scheduled jobs striped over
    the same racks share both, which is exactly the contention the
    max-min solve arbitrates.
    """

    hosts_per_tor: int = DEFAULT_HOSTS_PER_TOR
    oversubscription: float = 1.0
    nic: str = _NIC_LINK
    uplink: str = _UPLINK

    def __post_init__(self):
        if self.hosts_per_tor < 1:
            raise ValueError(f"hosts_per_tor must be >= 1, "
                             f"got {self.hosts_per_tor}")
        if self.oversubscription <= 0.0:
            raise ValueError(f"oversubscription must be > 0, "
                             f"got {self.oversubscription}")

    @property
    def uplink_capacity(self) -> float:
        """ToR uplink capacity in NIC units."""
        return self.hosts_per_tor / self.oversubscription

    def demand(self, topology: str) -> int:
        """Uplink multiplicity of one collective on the representative rack."""
        if topology == "hierarchical":
            return 1                 # only the rack leader crosses the spine
        return self.hosts_per_tor    # striped ring/tree: every host does

    def path(self, topology: str) -> Tuple[str, ...]:
        """The representative flow's route, with never-binding links elided.

        Returns ``(nic,)`` when the uplink can never be the bottleneck
        (capacity >= multiplicity: see the elision contract in the module
        docstring) — the engine then runs the flat single-link code
        bit-for-bit — and ``(nic, up0 * multiplicity)`` otherwise.
        """
        d = self.demand(topology)
        if self.uplink_capacity >= d:
            return (self.nic,)
        return (self.nic,) + (self.uplink,) * d

    def capacities(self) -> Dict[str, float]:
        """Engine capacity overrides (the NIC keeps its default 1.0)."""
        return {self.uplink: self.uplink_capacity}


def resolve_fabric(name: str, oversubscription: float = 1.0,
                   hosts_per_tor: int = DEFAULT_HOSTS_PER_TOR
                   ) -> Optional[Fabric]:
    """Build the named fabric, or ``None`` for the flat topology.

    ``none`` rejects a non-default oversubscription rather than silently
    ignoring it — there is no uplink to oversubscribe.
    """
    if name == "none":
        if oversubscription != 1.0:
            raise ValueError(
                "oversubscription requires a fabric (fabric='none' has no "
                f"uplink to oversubscribe, got {oversubscription})")
        return None
    if name != "clos":
        raise ValueError(f"unknown fabric {name!r}; expected one of "
                         f"{FABRICS}")
    return Fabric(hosts_per_tor=hosts_per_tor,
                  oversubscription=float(oversubscription))
