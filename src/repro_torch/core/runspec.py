"""Unified run specification for the scenario / sweep / frontier entry points.

A copy of ``repro.core.runspec`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Seven PRs of feature threading left ``run_scenario`` / ``evaluate_scenario``
/ ``simulate_chunked`` / ``frontier`` each with a long tail of loose kwargs
(scale, engines, billing, telemetry, tier, obs, ...) declared slightly
differently at every layer.  ``RunSpec`` is the one frozen carrier for all
of them — including the planet-scale knobs (``devices`` for the
device-sharded scan, ``cluster`` for long-tail super-function bucketing) —
so new knobs land in exactly one place.

``spec=RunSpec(...)`` is the ONLY calling convention: the transitional
loose-kwarg shims (and their once-per-process deprecation machinery) were
removed after the soak period, so a stale ``run_scenario(scale=0.5)`` call
now fails with an ordinary ``TypeError`` instead of warning.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

__all__ = ["RunSpec"]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Everything a scenario run / sweep / frontier search needs beyond the
    scenario identity itself.

    scale        workload multiplier applied to the scenario's base trace
    engines      which engines to run ("eventsim" oracle, "simjax" fluid)
    billing      BillingProfile or registered profile name (None = ideal)
    telemetry    in-scan telemetry slots (0 = off, bit-for-bit baseline)
    tier         spot capacity tier (name or CapacityTier) to impose
    obs          SpanRecorder capturing oracle lifecycle spans
    force_oracle run the discrete-event oracle even where the scenario
                 marks it infeasible at this scale
    devices      shard the chunked scan over this many local devices
                 (0 = legacy unsharded dispatch; single runs shard the
                 function axis, fleet sweeps shard the point axis)
    cluster      bucket functions whose mean request rate is below this
                 many rps into weighted super-functions before the fluid
                 replay (0 = off; exact in the fluid limit, drops the
                 event-level oracle leg)
    """

    scale: float = 1.0
    engines: Tuple[str, ...] = ("eventsim", "simjax")
    billing: Any = None
    telemetry: int = 0
    tier: Any = None
    obs: Any = None
    force_oracle: bool = False
    devices: int = 0
    cluster: float = 0.0

    def __post_init__(self):
        engines = self.engines
        if isinstance(engines, str):
            engines = (engines,)
        object.__setattr__(self, "engines", tuple(engines))
        scale = float(self.scale)
        if not (math.isfinite(scale) and scale > 0):
            raise ValueError(f"RunSpec.scale must be finite and > 0, got {self.scale!r}")
        object.__setattr__(self, "scale", scale)
        telemetry = int(self.telemetry)
        if telemetry < 0:
            raise ValueError(f"RunSpec.telemetry must be >= 0, got {self.telemetry!r}")
        object.__setattr__(self, "telemetry", telemetry)
        devices = int(self.devices)
        if devices < 0:
            raise ValueError(f"RunSpec.devices must be >= 0, got {self.devices!r}")
        object.__setattr__(self, "devices", devices)
        cluster = float(self.cluster)
        if not (math.isfinite(cluster) and cluster >= 0):
            raise ValueError(f"RunSpec.cluster must be finite and >= 0, got {self.cluster!r}")
        object.__setattr__(self, "cluster", cluster)
        object.__setattr__(self, "force_oracle", bool(self.force_oracle))

    def replace(self, **changes) -> "RunSpec":
        return dataclasses.replace(self, **changes)
