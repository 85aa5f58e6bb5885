"""The ``cells`` policy family: spot-aware scaling + the routing axes.

``CellsFamily`` extends ``SpotAwareFamily`` the same way that family
extends plain sync-keepalive: the per-function scaling DECISION is
inherited unchanged (keepalive expiry + spot headroom), while the new axes
are ENGINE-level knobs the multi-region machinery reads —

* ``cell_count``      — how many regional cells the workload splits into
  (structural: the sweep dispatcher groups points by its rounded value and
  rebuilds the per-cell traces per group);
* ``spill_threshold`` — the router's queue-per-warm-slot overflow level
  (traced: a sweepable batch axis of the fluid scan);
* ``route_skew``      — the origin-weight / failover-preference skew
  (traced likewise).

Declaring them as sweepable axes is what puts cell topology on the
frontier grid: ``repro.opt.space.sweepable_knobs()`` derives its whitelist
from the live registry, so ``evaluate_scenario(..., points)`` accepts
``cell_count`` / ``spill_threshold`` / ``route_skew`` the moment this
module is imported — no search-space surgery.

The port of ``repro.cells.family``: the same axes, registered in the port's
own registry.
"""

from __future__ import annotations

from repro_torch.core.policy_api import AxisSpec, SpotAwareFamily, register_family


class CellsFamily(SpotAwareFamily):
    name = "cells"
    kind = None

    axes = SpotAwareFamily.axes + (
        AxisSpec("cell_count", 1.0, 16.0,
                 doc="number of regional cells (rounded; structural — the "
                     "sweep groups points by it)"),
        AxisSpec("spill_threshold", 0.0, 64.0,
                 doc="queued-per-warm-slot level above which overflow "
                     "spills to warm siblings; 0 disables"),
        AxisSpec("route_skew", 0.0, 4.0,
                 doc="origin-weight and failover-preference skew "
                     "(w_c ~ exp(-skew * c))"),
    )

    # decide() and oracle_factory() are inherited: the cell axes never
    # change the per-function scaling decision — the engines read them the
    # way they read ``cc`` and the spot axes.


register_family(CellsFamily())
