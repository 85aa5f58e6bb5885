"""Declarative scenario specs: one object drives both simulation engines.

A ``Scenario`` names a base workload (``TraceConfig``), a stack of trace
transforms, an autoscaling policy, and the cluster/fleet shape.  The runner
(``repro_torch.scenarios.runner``) replays it through the discrete-event oracle
(``repro_torch.core.eventsim``) AND the chunked fluid simulator
(``repro_torch.core.simtorch``) from this one spec, so every scenario doubles as a
fidelity check of the fluid model — the paper's hybrid methodology.

``PolicySpec`` is the bridge: a plain-data policy description that lowers to
the oracle's stateful per-function ``Policy`` objects on one side and to the
fluid engine's ``JaxPolicy`` on the other (the port keeps the engine's
public names, so ``to_jax`` keeps its name too).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

from repro_torch.cells.topology import CellTopology
from repro_torch.core.policies import Policy
from repro_torch.core.policy_api import get_family
from repro_torch.core.simtorch import JaxFleet, JaxPolicy
from repro_torch.core.trace import (RateTrace, Trace, TraceConfig, synthesize,
                              synthesize_rates)
from repro_torch.fleet.billing import IDEAL, BillingProfile
from repro_torch.scenarios.transforms import Transform, apply_transforms


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Engine-neutral autoscaling-policy description.

    ``kind`` names a ``repro_torch.core.policy_api`` registry family ("sync",
    "async", "hybrid", "learned", ...); both lowering directions — the
    traced ``JaxPolicy`` and the oracle's per-function ``Policy`` factory —
    are delegated to that family, so a newly registered policy is runnable
    through every engine and scenario without touching this module.

    ``tick_s`` is the control-loop period used on BOTH sides (the oracle's
    reconcile tick and the fluid dt): comparing engines at different loop
    periods conflates policy behavior with sampling granularity — a coarser
    oracle tick accumulates larger queue spikes and inflates churn.
    """
    kind: str = "sync"
    keepalive_s: float = 600.0         # hybrid: the adaptive keepalive's cap
    window_s: float = 60.0
    target: float = 0.7
    container_concurrency: int = 1
    tick_s: float = 1.0
    prewarm_s: float = 0.0             # hybrid pre-warm lead (fluid side)
    theta: Any = None                  # learned-family weight pytree
    extra: Any = None                  # {axis: value} for novel family axes

    def family(self):
        try:
            return get_family(self.kind)
        except KeyError as e:
            raise ValueError(str(e)) from None

    def to_jax(self) -> JaxPolicy:
        return JaxPolicy(family=self.family().name,
                         keepalive_s=self.keepalive_s, window_s=self.window_s,
                         target=self.target, cc=self.container_concurrency,
                         prewarm_s=self.prewarm_s, theta=self.theta,
                         extra=self.extra)

    def factory(self) -> Callable[[int], Policy]:
        return self.family().oracle_factory(self)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One registered workload scenario (see ``repro_torch.scenarios.registry``)."""
    name: str
    description: str
    figure: str                        # which paper figure this extends
    base: TraceConfig
    transforms: Tuple[Transform, ...] = ()
    policy: PolicySpec = PolicySpec()
    num_nodes: int = 8                 # static cluster size (no fleet)
    fleet: Optional[JaxFleet] = None   # two-level autoscaling when set
    oracle_ok: bool = True             # discrete-event replay feasible at 1.0x
    chunk_ticks: int = 512             # fluid time-chunk length
    # the billing spec this scenario's rows are costed with (a spot
    # scenario carries its tier discount here so every consumer —
    # frontier, bench gate, CLIs — bills it identically by default).
    # Generalizes the old ``prices: PriceBook`` field: a BillingProfile
    # carries the PriceBook knobs PLUS the provider-side semantics
    # (rounding, fees, GB-s metering, warm tier — see repro_torch.fleet.billing)
    billing: BillingProfile = IDEAL
    # rate-based workload: synthesize per-tick Poisson COUNTS (RateTrace)
    # instead of a flat event stream — the planet-scale path, where a 50M
    # event sort would dwarf the simulation itself.  Rate-based scenarios
    # are fluid-only (no event stream for the oracle to replay) and cannot
    # stack event-level transforms.
    rate_trace: bool = False
    # multi-region cells: a non-trivial topology partitions the workload
    # across N routed cells with failover + trigger semantics; both engines
    # dispatch to repro_torch.cells (mutually exclusive with rate_trace and the
    # sharded-cluster path — the runner enforces this)
    cells: Optional[CellTopology] = None

    def scaled_config(self, scale: float = 1.0) -> TraceConfig:
        """Shrink the workload isotropically (functions, duration, load) for
        smoke runs; transforms are fraction-based, so they apply unchanged."""
        if scale == 1.0:
            return self.base
        return dataclasses.replace(
            self.base,
            num_functions=max(8, int(round(self.base.num_functions * scale))),
            duration_s=max(240.0, self.base.duration_s * scale),
            target_total_rps=max(0.5, self.base.target_total_rps * scale))

    def build_trace(self, scale: float = 1.0) -> Union[Trace, RateTrace]:
        cfg = self.scaled_config(scale)
        if self.rate_trace:
            if self.transforms:
                raise ValueError(
                    f"scenario {self.name!r}: rate_trace scenarios cannot "
                    f"apply event-stream transforms")
            return synthesize_rates(cfg, tick_s=self.policy.tick_s)
        return apply_transforms(synthesize(cfg), cfg, self.transforms,
                                seed=cfg.seed)
