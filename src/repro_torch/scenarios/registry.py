"""The scenario catalogue (EXPERIMENTS.md documents each one's knobs).

The port of ``repro.scenarios.registry``: the same 11 scenarios, field for
field (descriptions included), built from the port's own types.

Eight scenarios spanning the workload families the serverless literature
cares about: Shahrad'20's diurnal cycles and rare-but-bursty long tail,
flash crowds, multi-tenant interference, the paper's own 2000-function /
~3.5M-invocation KWOK-scale replay (Fig. 9), a 100k-function rate-based
planet-scale push of the same figure, a fleet-cost stress run
for the two-level autoscaling layer (Fig. 10 territory), and a spot-fleet
preemption storm for the capacity-tier layer (Fig. 12 territory) — plus
the multi-region cells family (``repro_torch.cells``, Fig. 14 territory): a
regional failover storm, a follow-the-sun scheduled-trigger rotation, and
a correlated cross-region spot-reclaim storm.
"""

from __future__ import annotations

from repro_torch.cells import CellTopology, ScheduledTrigger
from repro_torch.core.simtorch import JaxFleet
from repro_torch.core.trace import TraceConfig
from repro_torch.fleet.billing import IDEAL
from repro_torch.fleet.spot import SPOT_DEFAULT
from repro_torch.scenarios.spec import PolicySpec, Scenario
from repro_torch.scenarios.transforms import (BurstInject, RateScale, Splice,
                                        TenantMerge, TimeWarp)

_REGISTRY: dict[str, Scenario] = {}


def register(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"duplicate scenario {scenario.name!r}")
    _REGISTRY[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def list_scenarios() -> list[str]:
    return sorted(_REGISTRY)


register(Scenario(
    name="diurnal",
    description="Azure-like diurnal waves: a monotone time-warp concentrates "
                "the same 400-function load into two day/night cycles, "
                "stressing keepalive choices across load troughs.",
    figure="extends Fig. 3/4 (slowdown + memory vs keepalive)",
    base=TraceConfig(num_functions=400, duration_s=4800,
                     target_total_rps=62.5, seed=21),
    transforms=(TimeWarp(period_frac=0.5, depth=0.8),),
    policy=PolicySpec(kind="sync", keepalive_s=600),
    num_nodes=12,
))

register(Scenario(
    name="flash_crowd",
    description="Steady traffic, then the 20 hottest functions spike 6x for "
                "8% of the run: cold-start storms and queueing on the head.",
    figure="extends Fig. 2/5 (queueing CDF + creation rate)",
    base=TraceConfig(num_functions=400, duration_s=4800,
                     target_total_rps=62.5, seed=22),
    transforms=(BurstInject(at_frac=0.6, width_frac=0.08, factor=6.0,
                            top_k=20),),
    policy=PolicySpec(kind="async", window_s=60, target=0.7),
    num_nodes=16,
))

register(Scenario(
    name="cold_tail",
    description="Cold-start-heavy long tail: 600 rarely-invoked functions "
                "(sub-1/15min rates) under a short keepalive — churn "
                "overhead dominates useful work.",
    figure="extends Fig. 5/6 (creation rate + CPU overhead)",
    # burst_amp=0: pure Poisson gaps — the sparse-function regime where the
    # keepalive-expiry renewal model is exact (clustered gaps would need a
    # burstiness correction on both engines' warm-hit probability)
    base=TraceConfig(num_functions=600, duration_s=4800,
                     target_total_rps=8.0, max_rate=0.05, burst_amp=0.0,
                     seed=23),
    transforms=(RateScale(0.8),),
    policy=PolicySpec(kind="sync", keepalive_s=60),
    num_nodes=8,
))

register(Scenario(
    name="multi_tenant",
    description="Two tenants share one cluster: a second population at half "
                "the base load joins mid-stack, and a regime-change splice "
                "breaks window-average assumptions halfway through.",
    figure="extends Fig. 7 (interference / container concurrency)",
    base=TraceConfig(num_functions=200, duration_s=3600,
                     target_total_rps=30.0, seed=24),
    transforms=(Splice(at_frac=0.5), TenantMerge(num_functions_frac=1.0,
                                                 rps_frac=0.5)),
    policy=PolicySpec(kind="async", window_s=120, target=0.7),
    num_nodes=12,
))

register(Scenario(
    name="fig9_production",
    description="The paper's KWOK-scale hybrid replay: 2000 functions / "
                "~3.5M invocations; only the chunked lax.scan path is "
                "feasible at full scale (oracle runs at reduced scale).",
    figure="reproduces Fig. 9 (large-scale trade-off)",
    base=TraceConfig(num_functions=2000, duration_s=4800,
                     target_total_rps=729.0, seed=9),
    policy=PolicySpec(kind="sync", keepalive_s=600),
    num_nodes=50,
    oracle_ok=False,
))

register(Scenario(
    name="fig9_planet",
    description="Planet-scale fluid replay: 100k functions / ~50M "
                "invocations of rate-based (pre-binned Poisson-count) "
                "traffic.  Event synthesis and the oracle are both "
                "infeasible here; the scenario exists to exercise the "
                "device-sharded chunked scan (RunSpec.devices) and the "
                "long-tail clustering transform (RunSpec.cluster).",
    figure="extends Fig. 9 (large-scale trade-off, pushed 50x)",
    base=TraceConfig(num_functions=100_000, duration_s=2400.0,
                     target_total_rps=20_900.0, seed=13),
    policy=PolicySpec(kind="sync", keepalive_s=600, tick_s=2.0),
    num_nodes=2500,
    oracle_ok=False,
    chunk_ticks=256,
    rate_trace=True,
))

register(Scenario(
    name="fleet_cost_stress",
    description="Two-level autoscaling under load swings: rate-scaled "
                "Poisson traffic with an injected flash crowd drives node "
                "provisioning churn against a cooldown-gated fleet — the "
                "same sync-keepalive policy family the Fig. 10 cost "
                "frontier sweeps.",
    figure="extends Fig. 10 (dollar-cost frontier)",
    base=TraceConfig(num_functions=300, duration_s=3600,
                     target_total_rps=45.0, burst_amp=0.0, seed=26),
    transforms=(RateScale(1.2),
                BurstInject(at_frac=0.55, width_frac=0.08, factor=4.0,
                            top_k=15)),
    policy=PolicySpec(kind="sync", keepalive_s=600),
    fleet=JaxFleet(node_memory_mb=32_768.0, provision_s=60.0, min_nodes=1,
                   max_nodes=48, util_target=0.7, warm_frac=0.25,
                   cooldown_s=120.0),
))

register(Scenario(
    name="spot_storm",
    description="A 60%-spot fleet under a preemption hazard: the market "
                "keeps reclaiming warm capacity (2-min notice), in-flight "
                "work re-queues, and every eviction triggers a cold-start "
                "storm — the spot-aware policy holds hazard-scaled warm "
                "headroom and the bill discounts only the spot tier.",
    figure="new Fig. 12 (spot cost-vs-p99 frontier)",
    # pure Poisson gaps (burst_amp=0): the keepalive-expiry renewal model's
    # exact regime, so the parity band measures the SPOT model, not gap
    # burstiness (see cold_tail)
    base=TraceConfig(num_functions=300, duration_s=3600,
                     target_total_rps=45.0, burst_amp=0.0, seed=27),
    transforms=(RateScale(1.2),),
    policy=PolicySpec(kind="spot_aware", keepalive_s=600,
                      extra={"spot_fraction": 0.6,
                             "hazard_per_hour": SPOT_DEFAULT.hazard_per_hour}),
    fleet=JaxFleet(node_memory_mb=16_384.0, provision_s=60.0, min_nodes=1,
                   max_nodes=64, util_target=0.7, warm_frac=0.25,
                   cooldown_s=120.0,
                   reclaim_notice_s=SPOT_DEFAULT.reclaim_notice_s),
    billing=IDEAL.with_spot_discount(SPOT_DEFAULT.discount),
))

register(Scenario(
    name="region_failover",
    description="Three routed cells (skewed origin weights) and the "
                "largest one dies 60% into the run: its queued + in-flight "
                "work re-queues on the survivors and its later traffic "
                "redirects along the failover preference — the "
                "failover-storm cost of multi-region warm pools.",
    figure="new Fig. 14 (failover-storm overhead)",
    # 120 functions (not 240): the skewed partition makes the smallest
    # cell's per-function traffic ~6x sparser than the single-cell
    # scenarios, and the keepalive renewal model's sparse-regime error
    # compounds with the failover transient.  Denser per-function rates +
    # a mild warp keep the seed-averaged p99/memory parity inside the 15%
    # band (creation rate is out-of-band for partitioned warped traffic —
    # the fig9_production limitation, see EXPERIMENTS.md).
    base=TraceConfig(num_functions=120, duration_s=3600,
                     target_total_rps=36.0, burst_amp=0.0, seed=31),
    transforms=(TimeWarp(period_frac=0.5, depth=0.4),),
    policy=PolicySpec(kind="cells", keepalive_s=600,
                      extra={"spot_fraction": 0.0, "hazard_per_hour": 0.0,
                             "cell_count": 3.0, "spill_threshold": 0.0,
                             "route_skew": 0.5}),
    fleet=JaxFleet(node_memory_mb=16_384.0, provision_s=60.0, min_nodes=1,
                   max_nodes=32, util_target=0.7, warm_frac=0.25,
                   cooldown_s=120.0),
    cells=CellTopology(cell_count=3, route_skew=0.5, fail_cell=0,
                       fail_frac=0.6),
))

register(Scenario(
    name="follow_the_sun",
    description="Three equal cells, one diurnal wave phase-staggered a "
                "third of a cycle apart, and a scheduled (cron-style) "
                "trigger pre-provisioning each region before its morning: "
                "the otter-style scheduled-scaling layer, measured as "
                "keeping-warm overhead.",
    figure="new Fig. 14 (scheduled pre-provisioning)",
    base=TraceConfig(num_functions=240, duration_s=3600,
                     target_total_rps=36.0, burst_amp=0.0, seed=32),
    transforms=(TimeWarp(period_frac=1.0, depth=0.7),),
    policy=PolicySpec(kind="cells", keepalive_s=600,
                      extra={"spot_fraction": 0.0, "hazard_per_hour": 0.0,
                             "cell_count": 3.0, "spill_threshold": 0.0,
                             "route_skew": 0.0}),
    fleet=JaxFleet(node_memory_mb=16_384.0, provision_s=60.0, min_nodes=1,
                   max_nodes=32, util_target=0.7, warm_frac=0.25,
                   cooldown_s=120.0),
    cells=CellTopology(
        cell_count=3, phase_spread=1.0,
        scheduled=(ScheduledTrigger(cell=0, start_frac=0.00,
                                    end_frac=0.35, floor=6),
                   ScheduledTrigger(cell=1, start_frac=0.30,
                                    end_frac=0.65, floor=6),
                   ScheduledTrigger(cell=2, start_frac=0.60,
                                    end_frac=0.95, floor=6))),
))

register(Scenario(
    name="cell_hazard_corr",
    description="Four cells buying 60% spot capacity under a reclaim "
                "hazard that is 70% CORRELATED across regions: one shared "
                "storm process reclaims every cell's spot nodes together, "
                "so failover headroom planned against independent hazards "
                "meets simultaneous cross-region eviction storms.",
    figure="new Fig. 14 (correlated reclaim storms)",
    base=TraceConfig(num_functions=240, duration_s=3600,
                     target_total_rps=36.0, burst_amp=0.0, seed=33),
    transforms=(RateScale(1.1),),
    policy=PolicySpec(kind="cells", keepalive_s=600,
                      extra={"spot_fraction": 0.6,
                             "hazard_per_hour": SPOT_DEFAULT.hazard_per_hour,
                             "cell_count": 4.0, "spill_threshold": 0.0,
                             "route_skew": 0.0}),
    fleet=JaxFleet(node_memory_mb=16_384.0, provision_s=60.0, min_nodes=1,
                   max_nodes=48, util_target=0.7, warm_frac=0.25,
                   cooldown_s=120.0,
                   reclaim_notice_s=SPOT_DEFAULT.reclaim_notice_s),
    cells=CellTopology(cell_count=4, hazard_corr=0.7),
    billing=IDEAL.with_spot_discount(SPOT_DEFAULT.discount),
))
