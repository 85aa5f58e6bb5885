"""Replay a Scenario through both simulation engines and emit metric rows.

One ``Scenario`` spec, two engines:

* ``eventsim`` — the discrete-event oracle (exact per-request latency,
  per-instance keepalive timers, real placement);
* ``simjax``  — the chunked fluid simulator (production scale, no per-tick
  histories); in the port, ``repro_torch.core.simtorch`` (and
  ``repro_torch.cells.fluid`` for cells scenarios).  The leg keeps the JAX
  package's engine name, so that rows, ``--engines`` and ``parity_report``
  compare field for field with ``repro.scenarios.runner``'s.

Each engine produces one metric row with a shared key core (slowdown /
normalized memory / creation rate / CPU overhead / node accounting), so a
scenario run doubles as an oracle-vs-fluid parity measurement — the hybrid
methodology of the paper's Fig. 9, generalized to a scenario family.

The port of ``repro.scenarios.runner``.  ``run_scenario`` and
``billed_parity`` take ``device=None`` beside ``spec``: the fluid leg runs
there (CUDA by default, raising without it; the CPU only when named).  The
oracle leg is numpy on the host.  ``frontier`` takes ``device=None`` too
and runs the port's frontier engine (``repro_torch.opt.search``) there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

from repro_torch.core.cluster import Cluster
from repro_torch.core.eventsim import EventSim, SimConfig
from repro_torch.core.metrics import compute
from repro_torch.core.runspec import RunSpec
from repro_torch.core.simtorch import JaxFleet, simulate_chunked
from repro_torch.device import resolve_device
from repro_torch.fleet.billing import (BillingProfile, apply_throttle, bill_sim,
                                 bill_summary, resolve_profile)
from repro_torch.fleet.nodes import NodeFleet, NodeType
from repro_torch.fleet.policies import UtilizationFleetPolicy
from repro_torch.fleet.spot import (CapacityTier, SpotMarket, SpotNodeFleet,
                              get_tier)
from repro_torch.scenarios.cluster import cluster_functions
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.spec import PolicySpec, Scenario

ENGINES = ("eventsim", "simjax")

# the metric core both engines report; parity is judged on the first three
PARITY_KEYS = ("slowdown_geomean_p99", "normalized_memory", "creation_rate")


def _spot_knobs(spec: PolicySpec) -> tuple[float, float]:
    """The (spot_fraction, hazard_per_hour) a policy spec carries, if its
    family declares the spot axes (they ride the ``extra`` mapping)."""
    extra = dict(spec.extra or {})
    return (float(extra.get("spot_fraction", 0.0)),
            float(extra.get("hazard_per_hour", 0.0)))


def oracle_node_type(jf: JaxFleet) -> NodeType:
    """The node shape a traced fleet lowers to: the default shape scaled
    to the fleet's node size at constant $/GB-hour (also the basis the
    frontier engine and fig12 bill on)."""
    base = NodeType()
    ratio = jf.node_memory_mb / base.memory_mb
    return NodeType(memory_mb=jf.node_memory_mb, provision_s=jf.provision_s,
                    vcpus=base.vcpus * ratio,
                    price_per_hour=base.price_per_hour * ratio)


def _oracle_fleet(jf: JaxFleet, spec: Optional[PolicySpec] = None,
                  seed: int = 0) -> NodeFleet:
    """Lower the traced fleet parameters to the oracle's NodeFleet (the same
    mapping the two-level parity tests pin).  A policy spec carrying spot
    axes lowers to a ``SpotNodeFleet`` whose market runs the spec's hazard
    with the fleet's reclaim notice (seeded: parity replays are
    deterministic)."""
    nt = oracle_node_type(jf)
    policy = UtilizationFleetPolicy(min_nodes=int(jf.min_nodes),
                                    max_nodes=int(jf.max_nodes),
                                    util_target=jf.util_target,
                                    warm_frac=jf.warm_frac)
    sf, hz = _spot_knobs(spec) if spec is not None else (0.0, 0.0)
    if sf > 0.0 or hz > 0.0:
        tier = CapacityTier("spot", hazard_per_hour=hz,
                            reclaim_notice_s=jf.reclaim_notice_s)
        return SpotNodeFleet(policy, node_type=nt, cooldown_s=jf.cooldown_s,
                             spot_fraction=sf,
                             market=SpotMarket(tier, seed=seed))
    return NodeFleet(policy, node_type=nt, cooldown_s=jf.cooldown_s)


def apply_tier(sc: Scenario, tier: CapacityTier) -> Optional[Scenario]:
    """Re-spec a scenario to run under the given capacity tier: its
    policy's ``hazard_per_hour`` axis, the fleet's reclaim notice, and the
    tier discount in the billing spec.  Returns None when the scenario
    cannot express a tier (no fleet, or its policy family declares no spot
    axes) — the CLI reports those instead of silently running them
    unchanged."""
    if sc.fleet is None \
            or "hazard_per_hour" not in sc.policy.family().axis_names():
        return None
    extra = {**dict(sc.policy.extra or {}),
             "hazard_per_hour": tier.hazard_per_hour}
    return dataclasses.replace(
        sc,
        policy=dataclasses.replace(sc.policy, extra=extra),
        fleet=dataclasses.replace(sc.fleet,
                                  reclaim_notice_s=tier.reclaim_notice_s),
        billing=sc.billing.with_spot_discount(tier.discount))


def _billing_node_type(sc: Scenario) -> NodeType:
    """The node shape a scenario's bill is denominated in (both engines)."""
    return oracle_node_type(sc.fleet) if sc.fleet is not None else NodeType()


def _run_eventsim(sc: Scenario, trace, sim: SimConfig, obs=None,
                  detail: Optional[dict] = None,
                  billing: Optional[BillingProfile] = None) -> dict:
    if isinstance(trace, list):
        # multi-region cells: per-cell EventSim replicas + failover
        # (lifecycle tracing via ``obs`` is a single-cluster feature and
        # is not threaded through the cell replicas)
        from repro_torch.cells.oracle import run_cells_eventsim
        return run_cells_eventsim(sc, trace, sim, detail=detail,
                                  billing=billing)
    if sc.fleet is not None:
        cluster = Cluster(max(1, int(sc.fleet.min_nodes)),
                          node_memory_mb=sc.fleet.node_memory_mb)
        fleet = _oracle_fleet(sc.fleet, sc.policy, seed=sim.seed)
    else:
        cluster = Cluster(sc.num_nodes)
        fleet = None
    res = EventSim(trace, cluster, sc.policy.factory(), sim, fleet=fleet,
                   obs=obs).run()
    if detail is not None:
        detail["oracle_result"] = res
    row = compute(res).row()
    if billing is not None:
        # exact per-record billed durations (SimResult.billed_duration_totals)
        row.update(bill_sim(res, trace, billing,
                            node_type=_billing_node_type(sc)).row())
    return row


def _run_simjax(sc: Scenario, trace, sim: SimConfig, telemetry: int = 0,
                billing: Optional[BillingProfile] = None,
                devices: int = 0, detail: Optional[dict] = None,
                device=None) -> dict:
    if isinstance(trace, list):
        # multi-region cells: a leading cell axis in the chunked scan
        # (telemetry slots are a single-cluster feature; per-cell
        # attribution lands in detail["cell_rows"] instead)
        if devices > 0:
            raise ValueError("cells scenarios do not shard over devices "
                             "yet: the cell axis owns the scan's batch "
                             "leading dimension")
        from repro_torch.cells.fluid import run_cells_fluid
        row = run_cells_fluid(sc, trace, sim, billing=billing,
                              detail=detail, device=device)
    else:
        # dt = the oracle's reconcile tick: both engines share one control
        # period
        row = simulate_chunked(trace, sc.policy.to_jax(), sim=sim,
                               dt=sim.tick_s, num_nodes=sc.num_nodes,
                               fleet=sc.fleet, chunk_ticks=sc.chunk_ticks,
                               spec=RunSpec(telemetry=telemetry,
                                            billing=billing,
                                            devices=devices),
                               device=device)
    if billing is not None:
        row = {**row, **bill_summary(row, billing,
                                     node_type=_billing_node_type(sc),
                                     dt=sim.tick_s).row()}
    return row


def run_scenario(scenario: Union[str, Scenario],
                 sim: Optional[SimConfig] = None,
                 detail: Optional[dict] = None,
                 *, spec: Optional[RunSpec] = None, device=None) -> list[dict]:
    """Build the scenario trace once and replay it through each engine.

    Run configuration lands through ``spec`` (a ``repro_torch.core.runspec
    .RunSpec``): engines / scale / force_oracle / obs / telemetry /
    billing, plus the planet-scale knobs — ``devices`` (shard the fluid
    scan's function axis over that many local devices), ``cluster`` (a
    mean-rps threshold below which functions are bucketed into weighted
    super-functions, see ``repro_torch.scenarios.cluster``), and ``tier`` (a
    capacity-tier name or ``CapacityTier``, applied via ``apply_tier``;
    a scenario that cannot express a tier raises).  ``spec`` is the ONLY
    way to pass run configuration — the transitional loose keyword forms
    were removed.  ``sim`` and ``detail`` are genuine per-call arguments,
    not run configuration.

    The oracle leg is skipped for scenarios flagged ``oracle_ok=False``
    unless the run is shrunk (scale <= 0.25) or ``force_oracle`` is set —
    replaying ~3.5M discrete events is exactly what the chunked scan exists
    to avoid.  Rate-based runs (``Scenario.rate_trace`` or clustering)
    have NO event stream for the oracle to replay: the eventsim leg drops
    silently, ``force_oracle`` notwithstanding.

    Observability (repro_torch.obs): pass a ``SpanRecorder`` as ``obs`` to trace
    the oracle leg's request/instance/node lifecycles; ``telemetry=S``
    attaches S-slot downsampled series + attribution sums to the fluid
    leg's row.  Both default off and change nothing when off.  ``detail``,
    when given a dict, receives ``"oracle_result"`` (the raw ``SimResult``
    the attribution ledger reads), ``"fluid_summary"`` and ``"wall_parts_s"``
    (the host seconds of the trace's synthesis and transforms, of the
    clustering when there is one, and of each engine leg).

    ``billing`` (a ``repro_torch.fleet.billing`` profile or name, default off)
    bills BOTH engines' rows through the profile — the oracle by exact
    per-record duration rounding, the fluid leg by the in-scan analytic
    expectation — applies the profile's cpu-throttle term to the shared
    trace, and tags each row with the profile name.  A profile given BY
    NAME inherits the scenario's spot discount (the tier is workload
    state, not provider semantics); a profile OBJECT is used verbatim.

    The fluid leg runs on ``device`` (CUDA by default); it is resolved
    before the trace is built, so a run that needs the card and has none
    raises at once.
    """
    spec = spec if spec is not None else RunSpec()
    if not isinstance(spec, RunSpec):
        raise TypeError("run_scenario() spec= must be a RunSpec, got "
                        f"{type(spec).__name__}")
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if spec.tier is not None:
        tier = (get_tier(spec.tier) if isinstance(spec.tier, str)
                else spec.tier)
        tiered = apply_tier(sc, tier)
        if tiered is None:
            raise ValueError(
                f"scenario {sc.name!r} cannot express capacity tier "
                f"{tier.name!r}: no fleet, or its policy family declares "
                f"no spot axes")
        sc = tiered
    bp = (resolve_profile(spec.billing, sc.billing)
          if spec.billing is not None else None)
    # both engines run the same control-loop period (see PolicySpec.tick_s)
    sim = sim or SimConfig(tick_s=sc.policy.tick_s)
    rate_based = sc.rate_trace or spec.cluster > 0
    # a trivial topology (one cell, no failure/triggers/correlation) runs
    # the plain single-cluster path — byte-identical to cells=None
    cells_active = sc.cells is not None and not sc.cells.is_trivial
    if cells_active and rate_based:
        raise ValueError(
            f"scenario {sc.name!r}: cells topologies partition an event "
            f"stream — rate_trace / clustered runs cannot carry them")
    runnable = []
    for engine in spec.engines:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; pick from {ENGINES}")
        if engine == "eventsim" and (rate_based or not (
                sc.oracle_ok or spec.scale <= 0.25 or spec.force_oracle)):
            continue
        runnable.append(engine)
    if not runnable:       # don't synthesize a multi-million-event trace
        return []          # just to run nothing
    if "simjax" in runnable:
        device = resolve_device(device)
    t0 = time.time()
    if cells_active:
        from repro_torch.cells.topology import build_cell_traces
        trace = build_cell_traces(sc, spec.scale)
        if bp is not None:
            trace = [apply_throttle(t, bp) for t in trace]
        meta_fns, meta_inv = trace[0].num_functions, sum(map(len, trace))
    else:
        trace = sc.build_trace(spec.scale)
        if bp is not None:
            # the throttled trace is SHARED: both engines replay the same
            # memory-stretched durations, so parity judges the billing
            # model, not a one-sided duration transform (identity under
            # ``ideal``)
            trace = apply_throttle(trace, bp)
    parts = {"trace": round(time.time() - t0, 3)}
    if not cells_active:
        if spec.cluster > 0:
            # cluster AFTER throttling: the throttle stretches durations
            # the bucket key quantizes on, so the order is load-bearing
            t0 = time.time()
            trace = cluster_functions(trace, spec.cluster, tick_s=sim.tick_s)
            parts["cluster"] = round(time.time() - t0, 3)
        meta_fns, meta_inv = trace.num_functions, len(trace)
    meta = {"scenario": sc.name, "scale": spec.scale, "figure": sc.figure,
            "num_functions": meta_fns, "invocations": meta_inv}
    if bp is not None:
        meta["billing"] = bp.name
    rows = []
    for engine in runnable:
        t0 = time.time()
        if engine == "eventsim":
            metrics = _run_eventsim(sc, trace, sim, obs=spec.obs,
                                    detail=detail, billing=bp)
        else:
            metrics = _run_simjax(sc, trace, sim, telemetry=spec.telemetry,
                                  billing=bp, devices=spec.devices,
                                  detail=detail, device=device)
            if detail is not None:
                detail["fluid_summary"] = metrics
        rows.append({**meta, "engine": engine,
                     "wall_s": round(time.time() - t0, 3), **metrics})
    if detail is not None:
        detail["wall_parts_s"] = {**parts, **{r["engine"]: r["wall_s"] for r in rows}}
    return rows


def billed_parity(scenario: Union[str, Scenario],
                  billing: Union[str, BillingProfile],
                  scale: float = 0.25,
                  sim: Optional[SimConfig] = None, *, device=None) -> dict:
    """Replay a scenario through BOTH engines under a billing profile and
    return the relative oracle-vs-fluid gaps of the billed dollar totals —
    the acceptance gate for the provider-calibrated billing engine (≤15%
    on ``total_cost`` at 0.25x, the scale the parity band is calibrated
    at)."""
    rows = run_scenario(scenario, sim=sim,
                        spec=RunSpec(scale=scale, force_oracle=True,
                                     billing=billing), device=device)
    by = {r["engine"]: r for r in rows}
    if not {"eventsim", "simjax"} <= set(by):
        raise RuntimeError("billed_parity needs both engine legs; got "
                           f"{sorted(by)}")
    out = {}
    for k in ("total_cost", "billed_gb_s"):
        a, b = by["eventsim"][k], by["simjax"][k]
        out[k] = abs(a - b) / max(abs(a), 1e-9)
    return out


def frontier(scenarios: Optional[Sequence[str]] = None,
             space=None, spot_check: int = 0,
             log=None, coarse_frac: float = 0.1, eps: float = 0.15,
             survivor_cap: int = 12,
             telemetry=None, *, spec: Optional[RunSpec] = None, device=None):
    """Scenario-side entry point into the frontier engine: search the joint
    (policy x fleet) space across the given scenarios (default: every
    registered event-level scenario) with the coarse+refine schedule,
    optionally oracle-checking ``spot_check`` sampled winners per scenario.

    Run configuration (scale / billing / devices / cluster) lands through
    ``spec`` only — the loose ``scale=`` / ``billing=`` shim keywords were
    removed.  The search-shape knobs (``space``, ``coarse_frac``, ``eps``,
    ``survivor_cap``, ``spot_check``) and the sinks (``log``,
    ``telemetry`` — a ``repro_torch.obs.RunTelemetry``) are genuine
    parameters of THIS function, spelled out explicitly so a typo fails as
    a TypeError instead of vanishing into ``**kw``.  Every fluid run
    happens on ``device`` (CUDA by default), resolved before the search.

    Returns ``(FrontierResult, spot_records)``; see
    ``repro_torch.opt.search``.  (Imported lazily: ``repro_torch.opt``
    builds on this package.)
    """
    from repro_torch.opt.search import (DEFAULT_SPACE, frontier_search,
                                        oracle_spot_check)
    spec = spec if spec is not None else RunSpec()
    if not isinstance(spec, RunSpec):
        raise TypeError("frontier() spec= must be a RunSpec, got "
                        f"{type(spec).__name__}")
    device = resolve_device(device)
    result = frontier_search(scenarios, space=space or DEFAULT_SPACE,
                             scale=spec.scale, coarse_frac=coarse_frac,
                             eps=eps, survivor_cap=survivor_cap,
                             billing=spec.billing, log=log,
                             telemetry=telemetry, devices=spec.devices,
                             cluster=spec.cluster, device=device)
    checks = oracle_spot_check(result, k=spot_check, device=device) \
        if spot_check else []
    return result, checks


def parity_report(rows: Sequence[dict]) -> dict:
    """Relative oracle-vs-fluid gap per parity metric; {} unless both
    engines are present."""
    by = {r["engine"]: r for r in rows}
    if not {"eventsim", "simjax"} <= set(by):
        return {}
    out = {}
    for k in PARITY_KEYS:
        a, b = by["eventsim"][k], by["simjax"][k]
        out[k] = abs(a - b) / max(abs(a), 1e-9)
    return out
