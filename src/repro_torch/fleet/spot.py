"""Spot / preemptible capacity tiers: the market that evicts your warm pool.

A copy of ``repro.fleet.spot`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The paper prices the cost of keeping warm in resources; operators cut the
*dollar* bill with spot (preemptible) nodes at a 60-70% discount — but spot
capacity can be reclaimed by the provider with a short notice window, and
every reclaim is a forced eviction of warm instances whose demand comes
back as a cold-start storm ("Understanding Cost Dynamics of Serverless
Computing" / "Demystifying Serverless Costs on Public Platforms",
PAPERS.md).  This module is the discrete (oracle) half of that model:

* ``CapacityTier``  — a purchasing tier for a ``NodeType``: price
  multiplier vs on-demand, a Poisson preemption hazard (reclaims per
  node-hour), and the provider's reclaim-notice window.  Tiers live in a
  small registry so CLIs can list them and fail friendly on unknown names.
* ``SpotMarket``    — the seeded hazard process: per reconcile tick, each
  UP spot node is preempted with probability ``1 - exp(-hazard * dt)``.
  Deterministic given its seed (the parity/property tests pin this).
* ``SpotNodeFleet`` — ``NodeFleet`` with tier-split provisioning (a
  ``spot_fraction`` of the fleet is bought on the spot tier), market-driven
  evictions (an announced node drains immediately and is force-terminated
  at the notice deadline — ``repro_torch.core.eventsim`` re-queues its in-flight
  work as scale-up pressure), and per-tier billing
  (``spot_node_seconds`` ⊂ ``node_seconds``) so ``repro_torch.fleet.costs`` can
  bill mixed fleets correctly.

The fluid twin lives in ``repro_torch.core.simtorch`` (a traced hazard/eviction
flux in the chunked scan, driven by the ``spot_aware`` policy family's
``spot_fraction``/``hazard_per_hour`` axes); oracle-vs-fluid parity under
the ``spot_storm`` scenario is pinned in ``tests/test_spot.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.cluster import PROVISIONING, UP, Cluster, Node
from repro_torch.fleet.nodes import NodeFleet, NodeType
from repro_torch.fleet.policies import FleetPolicy


@dataclasses.dataclass(frozen=True)
class CapacityTier:
    """One purchasing tier of a node shape (see EXPERIMENTS.md, "Spot
    capacity tiers").  ``price_multiplier`` scales ``NodeType.
    price_per_hour``; ``hazard_per_hour`` is the Poisson reclaim rate per
    node; ``reclaim_notice_s`` is the provider's eviction warning."""
    name: str
    price_multiplier: float = 1.0
    hazard_per_hour: float = 0.0
    reclaim_notice_s: float = 0.0

    @property
    def discount(self) -> float:
        """The ``PriceBook.spot_discount`` equivalent (0.65 -> pay 35%)."""
        return 1.0 - self.price_multiplier


_TIERS: dict[str, CapacityTier] = {}


def register_tier(tier: CapacityTier) -> CapacityTier:
    if not tier.name:
        raise ValueError("capacity tier needs a name")
    if tier.name in _TIERS:
        raise ValueError(f"duplicate capacity tier {tier.name!r}")
    _TIERS[tier.name] = tier
    return tier


def get_tier(name: str) -> CapacityTier:
    try:
        return _TIERS[name]
    except KeyError:
        raise KeyError(f"unknown capacity tier {name!r}; "
                       f"registered: {sorted(_TIERS)}") from None


def list_tiers() -> list[str]:
    return sorted(_TIERS)


# On-demand is hazardless by definition.  The spot defaults follow the
# published reclaim statistics the calibration section of EXPERIMENTS.md
# cites: a ~65% discount, single-digit reclaims per node-hour under pool
# pressure (an accelerated rate — calm pools reclaim orders of magnitude
# less often; simulations compress the pressured regime), and a
# two-minute warning (the AWS/GCE notice).
ON_DEMAND = register_tier(CapacityTier("on_demand"))
SPOT_DEFAULT = register_tier(CapacityTier(
    "spot", price_multiplier=0.35, hazard_per_hour=8.0,
    reclaim_notice_s=120.0))


class SpotMarket:
    """Seeded Bernoulli thinning of the tier's Poisson preemption process.

    Each poll covers the interval since the previous one; every candidate
    node is reclaimed independently with ``1 - exp(-hazard * dt)`` — the
    exact discretization of the hazard the fluid twin integrates, so the
    two engines agree in expectation.  Identical seeds replay identical
    eviction schedules against identical node sequences."""

    def __init__(self, tier: CapacityTier = SPOT_DEFAULT, seed: int = 0):
        self.tier = tier
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._last_poll: Optional[float] = None

    def preempted(self, t: float, nodes: list[Node]) -> list[Node]:
        dt = 0.0 if self._last_poll is None else max(t - self._last_poll, 0.0)
        self._last_poll = t
        if dt <= 0.0 or self.tier.hazard_per_hour <= 0.0 or not nodes:
            return []
        p = -math.expm1(-self.tier.hazard_per_hour / 3600.0 * dt)
        return [n for n in nodes if self.rng.uniform() < p]


class SpotNodeFleet(NodeFleet):
    """A ``NodeFleet`` buying a ``spot_fraction`` of its capacity on the
    spot tier.  Provisioning keeps the UP+PROVISIONING mix at the target
    fraction; the market preempts UP spot nodes (the announced node starts
    draining at once — no new placements — and the simulator force-evicts
    whatever is still running at the notice deadline); billing meters the
    spot tier separately so the bill can discount only spot node-hours."""

    def __init__(self, policy: FleetPolicy | None = None,
                 node_type: NodeType = NodeType(),
                 cooldown_s: float = 120.0,
                 spot_fraction: float = 0.0,
                 market: Optional[SpotMarket] = None):
        super().__init__(policy, node_type=node_type, cooldown_s=cooldown_s)
        if not 0.0 <= spot_fraction <= 1.0:
            raise ValueError(f"spot_fraction must be in [0, 1], got "
                             f"{spot_fraction!r}")
        self.spot_fraction = spot_fraction
        self.market = market or SpotMarket()
        self._evict_deadlines: list[tuple[Node, float]] = []

    # -- tier-split provisioning -------------------------------------------

    def _provision(self, cluster: Cluster, count: int) -> list[Node]:
        have = cluster.nodes_in(UP, PROVISIONING)
        n_spot = sum(1 for n in have if n.spot)
        target = int(round(self.spot_fraction * (len(have) + count)))
        add_spot = min(max(target - n_spot, 0), count)
        out = []
        for i in range(count):
            node = cluster.add_node(self.node_type.memory_mb)
            node.spot = i < add_spot
            out.append(node)
        return out

    # -- market-driven evictions -------------------------------------------

    def reconcile(self, t: float, cluster: Cluster):
        provisioned, draining = super().reconcile(t, cluster)
        announced = self.market.preempted(
            t, [n for n in cluster.nodes_in(UP) if n.spot])
        for node in announced:
            cluster.start_drain(node)
            self.evictions += 1
            self.announced_ids.add(node.node_id)
            self._evict_deadlines.append(
                (node, t + self.market.tier.reclaim_notice_s))
        return provisioned, draining + announced

    def pop_evictions(self) -> list[tuple[Node, float]]:
        out, self._evict_deadlines = self._evict_deadlines, []
        return out

    def force_evict(self, node: Node, cluster: Cluster) -> None:
        """The reclaim notice ran out: the provider takes the node back,
        whatever is still running on it (the simulator has already
        re-queued the in-flight work)."""
        if node.alive:
            cluster.terminate(node)
        self.announced_ids.discard(node.node_id)

    # -- per-tier billing ---------------------------------------------------

    def bill(self, cluster: Cluster, dt_s: float) -> int:
        n = super().bill(cluster, dt_s)
        self.spot_node_seconds += sum(
            1 for nd in cluster.nodes if nd.billable and nd.spot) * dt_s
        return n
