"""Node-fleet scaling policies (the otter/node-fleet layer of the stack).

A copy of ``repro.fleet.policies`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

These decide *how many worker nodes* the cluster should run, one level below
the per-function instance policies in ``repro_torch.core.policies``.  Three
families, mirroring rackerlabs/otter's policy taxonomy:

* ``UtilizationFleetPolicy`` — a reconciler: keep memory utilization of the
  fleet at a target, plus a warm-node pool for cold-start headroom.  This is
  the policy mirrored branchlessly inside the ``lax.scan`` simulator, so it
  is the one used for oracle/vectorized parity.
* ``ThresholdFleetPolicy``  — otter-style step policy: when utilization
  crosses a high/low watermark, add/remove a fixed ``change`` of nodes,
  gated by a per-policy cooldown.
* ``ScheduleFleetPolicy``   — otter's scheduled scaling: a piecewise-constant
  desired capacity over time (e.g. business-hours up, nights down).

All desired sizes are clamped to ``[min_nodes, max_nodes]`` (otter's
min/maxEntities).  Scale-*down* cooldown and draining are enforced by the
fleet manager, not here; ``ThresholdFleetPolicy`` additionally carries its
own trigger cooldown like otter's per-policy cooldown.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class FleetPolicy:
    """Base: a fixed-size fleet (desired == min_nodes == max_nodes)."""
    min_nodes: int = 1
    max_nodes: int = 64

    def clamp(self, n: float) -> int:
        return int(min(max(math.ceil(n - 1e-9), self.min_nodes), self.max_nodes))

    def desired(self, t: float, used_mb: float, node_memory_mb: float,
                nodes_now: int) -> int:
        return self.clamp(self.min_nodes)


@dataclasses.dataclass
class UtilizationFleetPolicy(FleetPolicy):
    """Reconcile node count so used memory sits at ``util_target`` of
    capacity, then add a warm pool of ``ceil(warm_frac * needed)`` spare
    nodes so placement bursts land on already-provisioned capacity."""
    util_target: float = 0.7
    warm_frac: float = 0.25

    def desired(self, t, used_mb, node_memory_mb, nodes_now):
        needed = math.ceil(used_mb / (self.util_target * node_memory_mb) - 1e-9)
        warm = math.ceil(self.warm_frac * max(needed, 1) - 1e-9)
        return self.clamp(needed + warm)


@dataclasses.dataclass
class ThresholdFleetPolicy(FleetPolicy):
    """Otter-style watermark policy: utilization above ``high`` adds
    ``change`` nodes, below ``low`` removes ``change``, at most once per
    ``cooldown_s`` (the per-policy cooldown in otter's schema)."""
    high: float = 0.8
    low: float = 0.3
    change: int = 1
    cooldown_s: float = 120.0
    _last_fired: float = dataclasses.field(default=-math.inf, repr=False)

    def desired(self, t, used_mb, node_memory_mb, nodes_now):
        if t - self._last_fired < self.cooldown_s:
            return self.clamp(nodes_now)
        util = used_mb / max(nodes_now * node_memory_mb, 1e-9)
        if util > self.high:
            self._last_fired = t
            return self.clamp(nodes_now + self.change)
        if util < self.low and nodes_now > self.min_nodes:
            self._last_fired = t
            return self.clamp(nodes_now - self.change)
        return self.clamp(nodes_now)


@dataclasses.dataclass
class ScheduleFleetPolicy(FleetPolicy):
    """Piecewise-constant desired capacity: ``entries`` is a sorted list of
    (start_time_s, desired_nodes); the last entry at or before ``t`` wins."""
    entries: tuple = ((0.0, 1),)

    def desired(self, t, used_mb, node_memory_mb, nodes_now):
        want = self.entries[0][1]
        for start, n in self.entries:
            if start <= t:
                want = n
            else:
                break
        # never scale below what current usage occupies
        floor = math.ceil(used_mb / node_memory_mb - 1e-9)
        return self.clamp(max(want, floor))
