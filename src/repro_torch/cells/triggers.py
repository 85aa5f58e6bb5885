"""Desired-state convergence: the trigger-driven fleet policy of a cell.

A copy of ``repro.cells.triggers``; it subclasses the port's own
``repro_torch.fleet.policies.FleetPolicy``.

``ConvergenceFleetPolicy`` is the oracle-side reconciler of the cells
trigger layer (otter-style): every tick it converges the cell's node count
toward the MAX of three desired-state sources —

* the utilization reconciler (bit-for-bit ``UtilizationFleetPolicy``
  arithmetic: ceil(used / (util_target * node_mem)) plus warm headroom),
* active *scheduled* floors (cron/at pre-provisioning windows, lowered
  from ``CellTopology.schedule_entries`` to absolute (start, end, floor)
  triples),
* held *reactive* floors (utilization-threshold triggers that latch
  ``nodes_now + change`` for ``hold_s`` and re-arm after ``cooldown_s``).

Whichever source binds is exported as ``last_source`` (with the trigger's
own ``last_cooldown_s`` when a reactive trigger binds), which
``repro_torch.fleet.nodes.NodeFleet`` keys its per-source scale-down cooldown
clocks on — two triggers with different cooldowns never suppress each
other's scale-downs.

The fluid twin integrates the same three sources as traced per-cell fleet
floors inside the chunked scan (``repro_torch.cells.fluid``); the parity tests
pin that both lowerings of one ``CellTopology`` agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.fleet.policies import FleetPolicy

from repro_torch.cells.topology import ReactiveTrigger


@dataclasses.dataclass
class ConvergenceFleetPolicy(FleetPolicy):
    util_target: float = 0.7
    warm_frac: float = 0.25
    #: absolute (start_s, end_s, floor) scheduled windows for THIS cell
    schedule: Tuple[Tuple[float, float, int], ...] = ()
    reactive: Tuple[ReactiveTrigger, ...] = ()
    #: which desired-state source bound last tick (None = utilization /
    #: schedule path) — the per-source scale-down cooldown key NodeFleet
    #: reads; a binding reactive trigger also exports its own cooldown
    last_source: Optional[str] = dataclasses.field(default=None, repr=False)
    last_cooldown_s: Optional[float] = dataclasses.field(default=None,
                                                         repr=False)
    # reactive trigger state: next allowed fire time and the held
    # (floor, expires_at) latch, both keyed by trigger name
    _rearm_at: dict = dataclasses.field(default_factory=dict, repr=False)
    _held: dict = dataclasses.field(default_factory=dict, repr=False)

    def desired(self, t: float, used_mb: float, node_memory_mb: float,
                nodes_now: int) -> int:
        # utilization reconciler: EXACTLY UtilizationFleetPolicy's math so
        # a trigger-free convergence policy is that policy bit-for-bit
        needed = math.ceil(used_mb / (self.util_target * node_memory_mb)
                           - 1e-9)
        warm = math.ceil(self.warm_frac * max(needed, 1) - 1e-9)
        want, source, cool = needed + warm, None, None
        for start_s, end_s, floor in self.schedule:
            if start_s <= t < end_s and floor > want:
                want, source, cool = floor, "schedule", None
        if self.reactive:
            util = used_mb / max(nodes_now * node_memory_mb, 1e-9)
            for trig in self.reactive:
                held = self._held.get(trig.name)
                if held is not None and t >= held[1]:
                    del self._held[trig.name]
                    held = None
                if util >= trig.util_high \
                        and t >= self._rearm_at.get(trig.name, -math.inf):
                    self._rearm_at[trig.name] = t + trig.cooldown_s
                    held = (nodes_now + trig.change, t + trig.hold_s)
                    self._held[trig.name] = held
                if held is not None and held[0] > want:
                    want, source, cool = held[0], trig.name, trig.cooldown_s
        # never scale below what current usage physically occupies
        want = max(want, math.ceil(used_mb / node_memory_mb - 1e-9))
        self.last_source, self.last_cooldown_s = source, cool
        return self.clamp(want)
