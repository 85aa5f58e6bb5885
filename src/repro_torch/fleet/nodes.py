"""Node lifecycle management under a fleet policy (the EventSim-side manager).

A copy of ``repro.fleet.nodes`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

``NodeFleet`` owns the elastic half of a ``Cluster``: it provisions nodes
(with a provision latency an order of magnitude above a container cold
start), drains before terminating (in-flight instances finish; the node is
reclaimed only once empty), gates scale-down behind a cooldown, and meters
billable node-seconds for the cost model.

The simulator drives it:

* ``reconcile(t, cluster)``     — once per tick; returns nodes that just
  entered ``provisioning`` (the caller schedules their ready events) and
  nodes that just started draining (the caller tears down their idle
  instances).
* ``note_pressure(mb)``         — a placement just failed for ``mb``; the
  next reconcile counts that memory as demand, so placement failures turn
  into node scale-up rather than request drops.
* ``node_ready(node)``          — provision latency elapsed.
* ``maybe_reclaim(cluster)``    — terminate any empty draining node.
* ``bill(tick_s)``              — accumulate node-seconds while measuring.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.cluster import (DRAINING, PROVISIONING, UP, Cluster, Node)
from repro_torch.fleet.policies import FleetPolicy, UtilizationFleetPolicy


@dataclasses.dataclass(frozen=True)
class NodeType:
    """A purchasable node shape (see EXPERIMENTS.md for the pricing table)."""
    name: str = "standard-48"
    memory_mb: float = 192_000.0
    vcpus: float = 48.0
    price_per_hour: float = 1.88       # on-demand $/node-hour
    provision_s: float = 60.0          # boot + join + image pull >> cold start


class NodeFleet:
    def __init__(self, policy: FleetPolicy | None = None,
                 node_type: NodeType = NodeType(),
                 cooldown_s: float = 120.0):
        self.policy = policy or UtilizationFleetPolicy()
        self.node_type = node_type
        self.cooldown_s = cooldown_s
        # scale-down cooldown PER decision source: a policy that exposes
        # ``last_source`` (e.g. a reactive trigger name on a convergence
        # policy) gets its own clock, so two triggers with different
        # cooldowns never suppress each other; plain policies all key on
        # None and behave exactly as the old single-fleet timer did
        self._cooldown_until: dict = {}
        self._pressure_mb = 0.0
        self.provisions = 0
        self.terminations = 0
        self.node_seconds = 0.0
        # spot-tier accounting: an on-demand-only fleet never touches these;
        # repro_torch.fleet.spot.SpotNodeFleet drives them (the simulators read
        # them unconditionally, so they live on the base class)
        self.evictions = 0
        self.spot_node_seconds = 0.0
        # node_ids whose drain is a market reclaim in progress (announced
        # but not yet enforced) — teardowns there are eviction-storm work,
        # not ordinary churn (repro_torch.obs.ledger reads this via the sim)
        self.announced_ids: set[int] = set()

    # -- demand signals ---------------------------------------------------------

    def note_pressure(self, memory_mb: float) -> None:
        self._pressure_mb += memory_mb

    # -- reconciliation ---------------------------------------------------------

    def reconcile(self, t: float, cluster: Cluster) -> tuple[list[Node], list[Node]]:
        # demand = memory on the capacity we keep (up + provisioning) plus
        # unplaceable pressure; draining nodes are exiting, so their load
        # must not re-inflate desired capacity (it finishes or recreates on
        # kept nodes, where it is counted)
        have_nodes = cluster.nodes_in(UP, PROVISIONING)
        used = sum(n.used_mb for n in have_nodes) + self._pressure_mb
        self._pressure_mb = 0.0
        have = len(have_nodes)
        desired = self.policy.desired(t, used, self.node_type.memory_mb, have)

        provisioned: list[Node] = []
        draining: list[Node] = []
        if desired > have:
            provisioned = self._provision(cluster, desired - have)
            self.provisions += len(provisioned)
        else:
            key = getattr(self.policy, "last_source", None)
            if desired < have \
                    and t >= self._cooldown_until.get(key, -math.inf):
                # drain the emptiest up-nodes first so reclamation is fast
                up = sorted(cluster.nodes_in(UP), key=lambda n: n.used_mb)
                for node in up[:have - desired]:
                    cluster.start_drain(node)
                    draining.append(node)
                if draining:
                    cool = getattr(self.policy, "last_cooldown_s", None)
                    self._cooldown_until[key] = t + (cool if cool is not None
                                                     else self.cooldown_s)
        return provisioned, draining

    def _provision(self, cluster: Cluster, count: int) -> list[Node]:
        """Buy ``count`` nodes; the spot subclass overrides this to split
        the purchase across capacity tiers."""
        return [cluster.add_node(self.node_type.memory_mb)
                for _ in range(count)]

    def pop_evictions(self) -> list[tuple[Node, float]]:
        """(node, force-termination deadline) pairs announced since the
        last call — the reclaim notices the simulator must schedule.  An
        on-demand fleet never announces any."""
        return []

    def node_ready(self, node: Node) -> None:
        if node.state == PROVISIONING and node.alive:
            node.state = UP

    def maybe_reclaim(self, cluster: Cluster) -> list[Node]:
        """Terminate draining nodes whose instances have all finished."""
        done = [n for n in cluster.nodes_in(DRAINING) if n.used_mb <= 1e-9]
        for node in done:
            cluster.terminate(node)
            self.announced_ids.discard(node.node_id)
        self.terminations += len(done)
        return done

    # -- billing -----------------------------------------------------------------

    def bill(self, cluster: Cluster, dt_s: float) -> int:
        n = cluster.billable_count
        self.node_seconds += n * dt_s
        return n
