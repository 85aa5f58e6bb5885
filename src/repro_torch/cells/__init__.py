"""Multi-region cells: routed traffic, triggers, failover storms.

The port of ``repro.cells``.  The plain-data modules (``topology``,
``triggers``, ``oracle``, and ``traffic.failover_dist_np``) are copies; the
router's traced functions (``traffic``) and the fluid leg (``fluid``) are
torch.

One ``CellTopology`` on a ``Scenario`` turns the single-cluster simulation
into N regional cells — each wrapping its own instance pool and node fleet
(spot tiers included) — behind a weighted/spill router and an otter-style
trigger layer (scheduled pre-provisioning + reactive thresholds,
reconciled by ``ConvergenceFleetPolicy``).  Both engines lower from the
same spec: the oracle steps per-cell ``EventSim`` replicas with cross-cell
failover re-queues (``repro_torch.cells.oracle``), the fluid engine grows a
leading cell axis in the chunked scan's carry with the router as a traced
flux matrix (``repro_torch.cells.fluid``) — so every cells scenario doubles as
an oracle-vs-fluid parity measurement.

Importing this package registers the ``cells`` policy family in the port's
registry (``repro_torch.core.policy_api``).  The engine modules are imported
lazily by the runner (they pull in the fluid engine, which this package's
plain-data layer does not need).
"""

from repro_torch.cells import family as _family  # noqa: F401  (registers "cells")
from repro_torch.cells.topology import (CellTopology, ReactiveTrigger,
                                        ScheduledTrigger, build_cell_traces)
from repro_torch.cells.triggers import ConvergenceFleetPolicy

__all__ = ["CellTopology", "ScheduledTrigger", "ReactiveTrigger",
           "ConvergenceFleetPolicy", "build_cell_traces"]
