"""Joint (policy x fleet) search spaces over the traced simulator knobs.

A ``SearchSpace`` is two {knob: candidate values} grids — one over the
policy axes the registered families DECLARE sweepable
(``repro_torch.core.policy_api``: keepalive, utilization target, container
concurrency, hybrid pre-warm lead, ...) and one over the traced fleet axes
(``simtorch._PFLEET``) — whose cartesian product is the candidate set the
frontier engine sweeps through one batched chunked run per scenario.

Not every knob acts under every policy family (an async reconciler never
reads the keepalive; a sync policy never reads the utilization target), so
``active_knobs`` names the axes with effect per family — DERIVED from each
family's ``AxisSpec`` declarations, not a hand-written table; the engine
collapses inert axes before simulating and broadcasts results back,
turning e.g. a 96-point grid into 32 distinct simulations for a sync
scenario while keeping point ids comparable across scenarios — which is
what makes the cross-scenario robust frontier well-defined.

The port of ``repro.opt.space``: the same spaces and rules, read from the
port's own policy registry and fleet vector.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping, Sequence, Tuple, Union

from repro_torch.core.policy_api import get_family, sweepable_policy_axes
from repro_torch.core.simtorch import _PFLEET


def sweepable_knobs() -> set:
    """Every knob a ``SearchSpace`` may grid over: the union of all
    registered families' sweepable axes plus the fleet vector."""
    return sweepable_policy_axes() | set(_PFLEET)


# snapshot at import for cheap membership checks; families registered later
# are still honored by sweepable_knobs() / SearchSpace validation
SWEEPABLE = sweepable_knobs()


def active_knobs(family: Union[str, int]) -> Tuple[str, ...]:
    """The sweepable policy axes a family actually reads — straight from
    its ``AxisSpec`` declarations (accepts a registry name or the legacy
    integer kind)."""
    return get_family(family).sweepable_axes()


def grid_points(grid: Mapping[str, Sequence]) -> list[dict]:
    """Cartesian product of a {param: values} grid, as one dict per point."""
    keys = list(grid)
    return [dict(zip(keys, combo))
            for combo in itertools.product(*(grid[k] for k in keys))]


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """A {knob: candidates} grid split along the policy/fleet seam."""
    policy: Mapping[str, Sequence[float]] = dataclasses.field(
        default_factory=dict)
    fleet: Mapping[str, Sequence[float]] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        pol_axes = sweepable_policy_axes()
        bad = (set(self.policy) - pol_axes) | (set(self.fleet) - set(_PFLEET))
        if bad:
            raise ValueError(f"unsweepable knobs {sorted(bad)}; traced axes "
                             f"are {sorted(pol_axes | set(_PFLEET))}")
        for knob, vals in {**self.policy, **self.fleet}.items():
            if len(vals) == 0:
                raise ValueError(f"knob {knob!r} has no candidate values")
            for v in vals:
                if not math.isfinite(float(v)):
                    raise ValueError(f"knob {knob!r} has a non-finite "
                                     f"candidate {v!r}")

    def points(self) -> list[dict]:
        """The full candidate set; index order is the stable point id."""
        return grid_points({**self.policy, **self.fleet})

    def size(self) -> int:
        vals = list(self.policy.values()) + list(self.fleet.values())
        n = 1
        for v in vals:
            n *= len(v)
        return n


# The default joint space: the paper's keepalive ladder (Fig. 3-6) x the
# Knative utilization targets (Fig. 7-8) x the spot-tier purchase fraction
# (Fig. 12), crossed with the fleet's warm-pool and packing-headroom
# knobs.  96 raw points; inert-axis collapsing keeps a sync scenario at 16
# simulations and an async one at 12 (``spot_fraction`` only acts under
# the spot_aware family, so it collapses everywhere else).  ``cc`` and
# ``prewarm_s`` are fully traced axes and sweepable in custom spaces, but
# stay out of the DEFAULT grid: the fluid model's cc>1 creation/slowdown
# fidelity and the hybrid's pre-warm are outside the oracle-calibrated
# parity envelope (EXPERIMENTS.md, Frontier section), so their winners
# would only be demoted by the oracle spot-check.  ``hazard_per_hour``
# stays out too — it is the MARKET's reclaim rate, not an operator choice;
# sweep it in custom spaces (benchmarks/fig12_spot_frontier.py) to compare
# markets.
DEFAULT_SPACE = SearchSpace(
    policy={
        "keepalive_s": (60.0, 300.0, 600.0, 1200.0),
        "target": (0.5, 0.7, 1.0),
        "spot_fraction": (0.0, 0.6),
    },
    fleet={
        "util_target": (0.6, 0.8),
        "warm_frac": (0.0, 0.25),
    },
)
