"""FleetManager: node capacity for the REAL control plane.

A copy of ``repro.fleet.manager`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The control plane's workers are backend objects (simulated or real JAX
replicas), not bin-packed ``Cluster`` nodes, so capacity is expressed as
*instance slots*: each node hosts ``instances_per_node`` live instances.
The manager

* caps instance creation at current node capacity (``can_create``) — a
  denied create is deferred by the control plane, not dropped,
* scales up when creates are denied or utilization exceeds the policy's
  target (placement pressure feeds the same policy math as the simulators),
* scales down behind a cooldown, never below what live instances occupy,
* meters billable node-seconds under whatever clock the control plane runs
  (virtual or wall), for the same ``repro_torch.fleet.costs`` bill.

Spot capacity (``spot_fraction`` + a ``repro_torch.fleet.spot.SpotMarket``): the
manager buys that share of its nodes on the spot tier, the market preempts
them (capacity vanishes immediately at this layer — backend instances are
not node-bound, so an eviction surfaces as denied creates / placement
pressure rather than killed work), scale-down sheds the spot tier first,
and spot node-seconds are metered separately for per-tier billing.
"""

from __future__ import annotations

import math
from typing import Optional

from repro_torch.fleet.nodes import NodeType
from repro_torch.fleet.policies import FleetPolicy, UtilizationFleetPolicy
from repro_torch.fleet.spot import SpotMarket


class FleetManager:
    def __init__(self, policy: FleetPolicy | None = None,
                 node_type: NodeType = NodeType(),
                 instances_per_node: int = 8,
                 cooldown_s: float = 120.0,
                 initial_nodes: int = 1,
                 spot_fraction: float = 0.0,
                 market: Optional[SpotMarket] = None):
        self.policy = policy or UtilizationFleetPolicy()
        self.node_type = node_type
        self.instances_per_node = instances_per_node
        self.cooldown_s = cooldown_s
        self.nodes_up = max(initial_nodes, self.policy.min_nodes)
        # (ready time, is_spot) per provisioning node
        self._pipeline: list[tuple[float, bool]] = []
        # per-decision-source scale-down cooldown (see NodeFleet): policies
        # exposing ``last_source`` get one clock per trigger; plain
        # policies key on None — identical to the old single timer
        self._cooldown_until: dict = {}
        self._pressure = 0                    # denied creates since last tick
        self._last_bill_t: float | None = None
        self.provisions = 0
        self.terminations = 0
        self.node_seconds = 0.0
        if not 0.0 <= spot_fraction <= 1.0:
            raise ValueError(f"spot_fraction must be in [0, 1], got "
                             f"{spot_fraction!r}")
        self.spot_fraction = spot_fraction
        self.market = market if market is not None \
            else (SpotMarket() if spot_fraction > 0.0 else None)
        self.nodes_up_spot = 0
        self.spot_node_seconds = 0.0
        self.evictions = 0

    # -- capacity ----------------------------------------------------------------

    @property
    def nodes_total(self) -> int:
        return self.nodes_up + len(self._pipeline)

    def capacity(self) -> int:
        return self.nodes_up * self.instances_per_node

    def can_create(self, live_instances: int) -> bool:
        if live_instances < self.capacity():
            return True
        self._pressure += 1
        return False

    # -- reconciliation ----------------------------------------------------------

    @property
    def _spot_total(self) -> int:
        return self.nodes_up_spot + sum(1 for _, sp in self._pipeline if sp)

    def tick(self, now: float, live_instances: int) -> None:
        # billing first, under the pre-tick fleet size
        if self._last_bill_t is not None:
            dt = max(0.0, now - self._last_bill_t)
            self.node_seconds += self.nodes_total * dt
            self.spot_node_seconds += self._spot_total * dt
        self._last_bill_t = now

        ready = [(t, sp) for t, sp in self._pipeline if t <= now]
        if ready:
            self._pipeline = [(t, sp) for t, sp in self._pipeline if t > now]
            self.nodes_up += len(ready)
            self.nodes_up_spot += sum(1 for _, sp in ready if sp)

        # spot preemptions: capacity vanishes now (instances are backend
        # objects, not node-bound — the shortage surfaces as denied
        # creates feeding placement pressure below).  Poll the market even
        # with zero spot nodes up: a skipped poll leaves _last_poll stale,
        # and the next one would apply the whole gap's hazard to a fresh
        # node.
        if self.market is not None:
            gone = len(self.market.preempted(
                now, list(range(self.nodes_up_spot))))
            if gone:
                self.nodes_up -= gone
                self.nodes_up_spot -= gone
                self.evictions += gone

        # express instance slots in the policy's memory units so the same
        # FleetPolicy drives simulators and the real control plane alike
        per_inst_mb = self.node_type.memory_mb / self.instances_per_node
        used_mb = (live_instances + self._pressure) * per_inst_mb
        self._pressure = 0
        desired = self.policy.desired(now, used_mb, self.node_type.memory_mb,
                                      self.nodes_total)
        if desired > self.nodes_total:
            for _ in range(desired - self.nodes_total):
                want_spot = int(round(self.spot_fraction
                                      * (self.nodes_total + 1)))
                is_spot = self._spot_total < want_spot
                self._pipeline.append((now + self.node_type.provision_s,
                                       is_spot))
                self.provisions += 1
        elif desired < self.nodes_total:
            key = getattr(self.policy, "last_source", None)
            if now >= self._cooldown_until.get(key, -math.inf):
                floor = math.ceil(live_instances / self.instances_per_node)
                down = min(self.nodes_total - desired,
                           max(self.nodes_up - floor, 0))
                if down > 0:
                    self.nodes_up -= down
                    # shed the preemptible tier first: it is the flexible
                    # share
                    shed_spot = min(down, self.nodes_up_spot)
                    self.nodes_up_spot -= shed_spot
                    self.terminations += down
                    cool = getattr(self.policy, "last_cooldown_s", None)
                    self._cooldown_until[key] = now + (
                        cool if cool is not None else self.cooldown_s)

    def snapshot(self) -> dict:
        return {
            "nodes_up": self.nodes_up,
            "nodes_provisioning": len(self._pipeline),
            "capacity_instances": self.capacity(),
            "node_seconds": self.node_seconds,
            "provisions": self.provisions,
            "terminations": self.terminations,
            "nodes_up_spot": self.nodes_up_spot,
            "spot_node_seconds": self.spot_node_seconds,
            "evictions": self.evictions,
        }
