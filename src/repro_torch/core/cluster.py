"""Cluster model: nodes, placement, failures, stragglers, elastic lifecycle.

A copy of ``repro.core.cluster`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Nodes hold instances (bin-packed by memory).  A failure kills a node: its
instances vanish and their in-flight requests are re-queued — the control
plane must recreate capacity (fault tolerance is exercised in tests and the
large-scale example).  Straggler nodes multiply execution latency.

A node moves through an elastic lifecycle when a fleet autoscaler
(``repro_torch.fleet``) is attached:

    provisioning --ready--> up --drain--> draining --empty--> gone

Only ``up`` nodes accept placements; ``draining`` nodes let in-flight work
finish and are terminated once their memory drains to zero.  The static
seed behavior (every node born ``up``, fleet never touched) is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

PROVISIONING, UP, DRAINING, GONE = "provisioning", "up", "draining", "gone"


@dataclasses.dataclass
class Node:
    node_id: int
    memory_mb: float
    slowdown: float = 1.0          # >1 = straggler
    alive: bool = True
    used_mb: float = 0.0
    state: str = UP                # provisioning | up | draining | gone
    spot: bool = False             # spot-tier node (repro_torch.fleet.spot)

    def fits(self, mb: float) -> bool:
        return self.alive and self.state == UP \
            and self.used_mb + mb <= self.memory_mb

    @property
    def billable(self) -> bool:
        """Cloud billing starts at launch and stops at termination."""
        return self.alive and self.state != GONE


class Cluster:
    def __init__(self, num_nodes: int, node_memory_mb: float = 192_000.0,
                 straggler_frac: float = 0.0, straggler_slowdown: float = 3.0,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.node_memory_mb = node_memory_mb
        self.nodes: list[Node] = []
        for i in range(num_nodes):
            slow = straggler_slowdown if rng.uniform() < straggler_frac else 1.0
            self.nodes.append(Node(i, node_memory_mb, slow))
        self._rr = 0

    def place(self, memory_mb: float) -> Optional[Node]:
        """Round-robin first-fit (spreads churn across workers, like the
        default kube-scheduler LeastAllocated behavior)."""
        n = len(self.nodes)
        for k in range(n):
            node = self.nodes[(self._rr + k) % n]
            if node.fits(memory_mb):
                self._rr = (self._rr + k + 1) % n
                node.used_mb += memory_mb
                return node
        return None

    def release(self, node: Node, memory_mb: float) -> None:
        node.used_mb = max(0.0, node.used_mb - memory_mb)

    def fail_node(self, node_id: int) -> Node:
        node = self.nodes[node_id]
        node.alive = False
        node.used_mb = 0.0
        return node

    def recover_node(self, node_id: int) -> None:
        self.nodes[node_id].alive = True

    # -- elastic lifecycle (driven by repro_torch.fleet) ------------------------------

    def add_node(self, memory_mb: Optional[float] = None, slowdown: float = 1.0,
                 state: str = PROVISIONING) -> Node:
        node = Node(len(self.nodes), memory_mb or self.node_memory_mb,
                    slowdown, state=state)
        self.nodes.append(node)
        return node

    def start_drain(self, node: Node) -> None:
        if node.state == UP:
            node.state = DRAINING

    def terminate(self, node: Node) -> None:
        node.state = GONE
        node.alive = False
        node.used_mb = 0.0

    def nodes_in(self, *states: str) -> list[Node]:
        return [n for n in self.nodes if n.alive and n.state in states]

    @property
    def billable_count(self) -> int:
        return sum(1 for n in self.nodes if n.billable)

    @property
    def total_memory_mb(self) -> float:
        return sum(n.memory_mb for n in self.nodes if n.alive)
