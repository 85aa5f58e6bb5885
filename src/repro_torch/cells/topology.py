"""Multi-region cell topology: the declarative spec behind ``repro_torch.cells``.

A copy of ``repro.cells.topology`` (numpy only); the two must stay
identical in behaviour.

A ``CellTopology`` describes N regional cells sharing one function
population: how incoming traffic is weighted across them (``route_skew``),
when overflow spills to warm siblings (``spill_threshold``), how the
diurnal phase is staggered around the globe (``phase_spread`` — the
follow-the-sun offset applied to ``TimeWarp`` transforms per cell), an
optional deterministic regional failure (``fail_cell`` dies at
``fail_frac`` of the run and its traffic storms the survivors), the
cross-cell spot-reclaim correlation (``hazard_corr``), and the otter-style
trigger layer — scheduled (cron/at) pre-provisioning windows and reactive
utilization thresholds — that a per-cell desired-state convergence policy
(``repro_torch.cells.triggers.ConvergenceFleetPolicy``) reconciles.

Everything here is engine-neutral plain data: the discrete oracle
(``repro_torch.cells.oracle``) and the torch fluid engine
(``repro_torch.cells.fluid``) both lower from this one spec, so every cells scenario doubles
as an oracle-vs-fluid parity measurement, exactly like the single-cell
scenario family.

Positions (trigger windows, the failure time) are expressed as *fractions
of the trace duration* so the same topology survives
``Scenario.build_trace(scale=...)`` shrinking unchanged — the convention
``repro_torch.scenarios.transforms`` set.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.trace import Trace

# NOTE: repro_torch.scenarios.transforms is imported lazily inside the two
# functions that need it — the scenarios package imports this module (the
# Scenario.cells field and the registry), so a module-level import here
# would be circular whenever repro_torch.cells loads first.

# seed salt for the arrival->cell partition (independent of the transform
# stream's 0x5CE7A110 salt so routing never aliases transform randomness)
_ROUTE_SALT = 0xCE115EED


@dataclasses.dataclass(frozen=True)
class ScheduledTrigger:
    """A cron/at pre-provisioning window: hold ``cell``'s node floor at
    ``floor`` while run-fraction t is in [start_frac, end_frac) — the
    follow-the-sun "warm the region before its morning" policy."""
    cell: int
    start_frac: float
    end_frac: float
    floor: int

    def __post_init__(self):
        if not 0.0 <= self.start_frac < self.end_frac <= 1.0:
            raise ValueError(
                f"scheduled trigger window [{self.start_frac}, "
                f"{self.end_frac}) must satisfy 0 <= start < end <= 1")
        if self.cell < 0 or self.floor < 0:
            raise ValueError("scheduled trigger needs cell >= 0, floor >= 0")


@dataclasses.dataclass(frozen=True)
class ReactiveTrigger:
    """A threshold trigger: when a cell's memory utilization crosses
    ``util_high``, raise its node floor by ``change`` above the current
    count, hold it for ``hold_s``, and refuse to re-fire for
    ``cooldown_s`` (per trigger, per cell — the per-source cooldown split
    in ``repro_torch.fleet.nodes`` keys scale-down clocks on the trigger name)."""
    name: str
    util_high: float
    change: int
    hold_s: float = 120.0
    cooldown_s: float = 120.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("reactive trigger needs a name")
        if not 0.0 < self.util_high <= 10.0:
            raise ValueError(f"util_high must be in (0, 10], got "
                             f"{self.util_high!r}")
        if self.change < 0 or self.hold_s < 0 or self.cooldown_s < 0:
            raise ValueError("reactive trigger needs change/hold_s/"
                             "cooldown_s >= 0")


@dataclasses.dataclass(frozen=True)
class CellTopology:
    """N cells behind a weighted/spill router, plus failover + triggers."""
    cell_count: int = 1
    #: origin-weight skew: cell c receives a share proportional to
    #: exp(-route_skew * c).  0 = uniform.  The SAME skew orders failover
    #: and spill preference (surviving low-index cells absorb more).
    route_skew: float = 0.0
    #: queue-per-warm-slot level above which a cell's overflow arrivals
    #: spill to warm siblings (fluid router; 0 disables spill)
    spill_threshold: float = 0.0
    #: follow-the-sun: cell c's TimeWarp transforms are phase-shifted by
    #: 2*pi * phase_spread * c / cell_count (0 = all cells in phase)
    phase_spread: float = 0.0
    #: deterministic regional failure: fail_cell dies at fail_frac of the
    #: run (its queued + in-flight work re-queues on survivors, its later
    #: traffic redirects).  fail_cell < 0 disables.
    fail_cell: int = -1
    fail_frac: float = 0.6
    #: cross-cell spot-reclaim correlation in [0, 1]: this share of each
    #: cell's hazard comes from one shared storm process (all cells'
    #: markets reclaim together), the rest stays independent
    hazard_corr: float = 0.0
    scheduled: Tuple[ScheduledTrigger, ...] = ()
    reactive: Tuple[ReactiveTrigger, ...] = ()

    def __post_init__(self):
        if self.cell_count < 1:
            raise ValueError(f"cell_count must be >= 1, got "
                             f"{self.cell_count!r}")
        if self.route_skew < 0 or self.spill_threshold < 0:
            raise ValueError("route_skew / spill_threshold must be >= 0")
        if not 0.0 <= self.hazard_corr <= 1.0:
            raise ValueError(f"hazard_corr must be in [0, 1], got "
                             f"{self.hazard_corr!r}")
        if self.fail_cell >= self.cell_count:
            raise ValueError(f"fail_cell {self.fail_cell} out of range for "
                             f"{self.cell_count} cells")
        if self.fail_cell >= 0 and not 0.0 < self.fail_frac < 1.0:
            raise ValueError(f"fail_frac must be in (0, 1), got "
                             f"{self.fail_frac!r}")
        for tr in self.scheduled:
            if tr.cell >= self.cell_count:
                raise ValueError(f"scheduled trigger targets cell {tr.cell} "
                                 f"but there are {self.cell_count} cells")

    # -- derived routing data ----------------------------------------------

    def weights(self) -> np.ndarray:
        """(C,) normalized origin weights, w_c proportional to
        exp(-route_skew * c)."""
        w = np.exp(-self.route_skew * np.arange(self.cell_count, dtype=np.float64))
        return w / w.sum()

    @property
    def is_trivial(self) -> bool:
        """A topology the plain single-cell engines reproduce bit-for-bit:
        one cell, no failure, no triggers, no storm correlation.  The
        runner and sweep dispatchers use this to keep ``cells=None``
        behavior byte-identical for degenerate topologies."""
        return (self.cell_count == 1 and self.fail_cell < 0
                and not self.scheduled and not self.reactive
                and self.hazard_corr == 0.0)

    def fail_time(self, duration_s: float) -> Optional[float]:
        if self.fail_cell < 0:
            return None
        return self.fail_frac * duration_s

    def cell_nodes(self, num_nodes: int) -> np.ndarray:
        """(C,) static per-cell node counts for no-fleet scenarios: the
        scenario's ``num_nodes`` split by origin weight, at least 1 each."""
        return np.maximum(
            1, np.round(self.weights() * num_nodes)).astype(np.int64)

    # -- trigger lowering --------------------------------------------------

    def schedule_entries(self, cell: int, duration_s: float) -> tuple:
        """Absolute (start_s, end_s, floor) windows for one cell — the
        ``ConvergenceFleetPolicy.schedule`` input on the oracle side."""
        return tuple((tr.start_frac * duration_s, tr.end_frac * duration_s,
                      tr.floor)
                     for tr in self.scheduled if tr.cell == cell)

    def floor_schedule(self, n_ticks: int, dt: float,
                       duration_s: float) -> np.ndarray:
        """(T, C) float32 scheduled node floors per tick — the fluid
        engine's host-precomputed twin of ``schedule_entries`` (overlapping
        windows take the max floor; zero where no window is active)."""
        out = np.zeros((n_ticks, self.cell_count), np.float32)
        if not self.scheduled:
            return out
        t = (np.arange(n_ticks) + 0.5) * dt
        for tr in self.scheduled:
            live = (t >= tr.start_frac * duration_s) \
                & (t < tr.end_frac * duration_s)
            out[live, tr.cell] = np.maximum(out[live, tr.cell], tr.floor)
        return out


def _phase_shifted(tf, topo: CellTopology, cell: int):
    """Per-cell transform variant: TimeWarp gains the follow-the-sun phase
    offset; every other transform is shared verbatim."""
    from repro_torch.scenarios.transforms import TimeWarp
    if topo.phase_spread != 0.0 and isinstance(tf, TimeWarp):
        shift = 2.0 * math.pi * topo.phase_spread * cell / topo.cell_count
        return dataclasses.replace(tf, phase=tf.phase + shift)
    return tf


def build_cell_traces(sc, scale: float = 1.0) -> list:
    """Per-cell event traces for a cells scenario: partition FIRST, then
    transform per cell.

    The synthesized base trace is split across cells by a seeded
    categorical draw at the topology's origin weights — exact flow
    conservation (every invocation lands in exactly one cell, function ids
    keep the SHARED id space) — and each cell then applies the scenario's
    transform stack with its own phase offset, so follow-the-sun topologies
    see genuinely time-staggered diurnal waves of the same population.
    """
    from repro_torch.core.trace import synthesize
    from repro_torch.scenarios.transforms import apply_transforms
    topo: CellTopology = sc.cells
    if topo is None:
        raise ValueError(f"scenario {sc.name!r} has no cell topology")
    cfg = sc.scaled_config(scale)
    base = synthesize(cfg)
    c_count = topo.cell_count
    rng = np.random.default_rng(cfg.seed ^ _ROUTE_SALT)
    assign = rng.choice(c_count, size=len(base), p=topo.weights())
    out = []
    for c in range(c_count):
        keep = assign == c
        sub = Trace(base.t[keep], base.fn[keep].astype(np.int32),
                    base.dur[keep], base.profile, base.duration_s)
        tfs = tuple(_phase_shifted(tf, topo, c) for tf in sc.transforms)
        out.append(apply_transforms(sub, cfg, tfs, seed=cfg.seed + 17 * c))
    return out
