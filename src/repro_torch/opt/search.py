"""Cross-scenario frontier search over the joint (policy x fleet) space.

The engine answers the paper's closing question — "new, cost-efficient
autoscaling strategies" — by SEARCHING instead of replaying: every
candidate configuration (keepalive / utilization target / container
concurrency / hybrid pre-warm lead x warm-pool / packing-headroom fleet
knobs) runs through ONE batched chunked run per scenario, then a
successive-halving refine re-runs the promising region at full fidelity:

1. **coarse**   — the whole grid, every registered scenario, on a shrunk
   trace (``coarse_frac`` x the target scale): hundreds of simulations for
   roughly the price of one, since points share one run's ticks;
2. **survive**  — per scenario, the Pareto front plus an ``eps`` slack band
   (``opt.frontier.epsilon_survivors``), capped;
3. **refine**   — the UNION of every scenario's survivors (plus the coarse
   robust candidates) re-runs in EVERY scenario at the full target scale:
   a shared candidate pool is what makes cross-scenario dominance a fair
   comparison at refine fidelity, and scenario A's specialists double as
   fallback candidates when the oracle later demotes B's;
4. **reduce**   — per-scenario Pareto fronts + the robust frontier (points
   dominated in NO scenario) over the refined rows.

``oracle_spot_check`` then replays sampled frontier winners through the
discrete-event oracle so the frontier is trusted simulation, not a
fluid-model artifact (the same <=15% parity band the scenario tests pin).

The port of ``repro.opt.search``.  The point batch runs through the port's
fluid engine (``repro_torch.core.simtorch._chunked_summaries``, or
``repro_torch.cells.fluid.cells_chunked_summaries`` for a cells scenario),
with a leading point axis where the JAX engine vmaps.  Every public entry
point takes ``device=None``, resolves it once (CUDA by default, raising
without it; the CPU only when named) and runs every fluid call there; the
oracle legs of the spot-checks run on the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.core.eventsim import SimConfig
from repro_torch.core.policy_api import get_family
from repro_torch.core.runspec import RunSpec
from repro_torch.core.simtorch import (_PFLEET, JaxFleet, JaxPolicy,
                                       _chunked_summaries, stack_params)
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device
from repro_torch.fleet.billing import (BillingProfile, apply_throttle,
                                       bill_summary, resolve_profile)
from repro_torch.fleet.nodes import NodeType
from repro_torch.opt.frontier import (X_DEFAULT, Y_DEFAULT, epsilon_survivors,
                                      frontier_slack, hypervolume, pareto_front,
                                      robust_front)
from repro_torch.opt.space import (DEFAULT_SPACE, SWEEPABLE, SearchSpace,
                                   active_knobs)
from repro_torch.scenarios.registry import get_scenario, list_scenarios
from repro_torch.scenarios.spec import Scenario


def _point_batch(policy: JaxPolicy, fleet: JaxFleet,
                 pts: Sequence[dict]) -> tuple[dict, np.ndarray]:
    """A batch's stacked params tree and (P, 7) fleet matrix: each point's
    overrides on the policy's params and the fleet's vector, every override
    checked (finite; a policy knob within its declared bounds)."""
    fam = get_family(policy.family)
    base = policy.params()
    trees, fleets = [], np.tile(fleet.params(), (len(pts), 1))
    axis_names = set(fam.axis_names())
    for i, p in enumerate(pts):
        tree = dict(base)
        for k, v in p.items():
            if not np.isfinite(v):
                # every override — fleet knobs and other families' inert
                # knobs included — must at least be finite, or a NaN rides
                # silently to the CI gate's last-resort check
                raise ValueError(f"sweep value {k}={v!r} is not finite")
            if k in _PFLEET:
                fleets[i, _PFLEET.index(k)] = v
            elif k in axis_names:
                ax = fam.axis(k)
                if v < ax.lo or v > ax.hi:
                    raise ValueError(
                        f"sweep value {k}={v!r} outside the declared bounds "
                        f"[{ax.lo}, {ax.hi}] of family {fam.name!r}")
                tree[k] = float(v)
            # else: another family's sweepable knob — inert here
        trees.append(tree)
    return stack_params(trees), fleets


def evaluate_points(trace: Trace, policy: JaxPolicy, fleet: JaxFleet,
                    points: Sequence[dict], sim: SimConfig = SimConfig(),
                    dt: float = 1.0, node_type: Optional[NodeType] = None,
                    billing: Union[str, BillingProfile, None] = None,
                    warmup_frac: float = 0.5,
                    chunk_ticks: int = 512, devices: int = 0, *,
                    cells=None, device=None) -> list[dict]:
    """Run every parameter point through one batched chunked run; return
    one row per point: {params..., metrics..., cost fields...}.  Rows are
    billed through the ``billing`` profile (``repro_torch.fleet.billing``;
    default ``ideal`` — bitwise the pre-billing ``cost_report`` math).
    ``devices`` above 1 raises ``NotImplementedError``, as the port's
    engine does (one device until the multi-device run is ported).  The
    run happens on ``device`` (CUDA by default).

    This is the generalized core behind ``repro_torch.fleet.sweep.sweep``: every
    policy axis the family declares sweepable is a traced batch axis
    alongside the six fleet knobs (the per-point params pytrees are stacked
    leaf-wise, so arbitrary-shaped policies batch the same way four scalar
    knobs did).  A knob another family declares (e.g. ``target`` under a
    sync scenario) is accepted but inert, exactly as the flat parameter
    vector behaved; ``evaluate_scenario`` collapses such duplicates before
    simulating.  Every override is bounds-checked against its declaration,
    so a NaN or out-of-range sweep value fails loudly here.

    ``cells`` switches the batch to the multi-region engine: a
    ``(traces, topology)`` pair (per-cell trace partition +
    ``repro_torch.cells.CellTopology``) routes the whole point batch through
    ``repro_torch.cells.fluid.cells_chunked_summaries`` instead of the
    single-cell scan.  ``trace`` is then only consulted for metadata; all
    points share ONE topology — ``evaluate_scenario`` groups points by
    their (structural) ``cell_count`` before calling here.  Incompatible
    with ``devices`` sharding.
    """
    pts = list(points) if points else [{}]
    # validate against the LIVE registry (sweepable_knobs()), not the
    # import-time SWEEPABLE snapshot — families registered later must be
    # honored here exactly as SearchSpace honors them
    from repro_torch.opt.space import sweepable_knobs
    dev = resolve_device(device)
    legal = sweepable_knobs()
    unknown = {k for p in pts for k in p} - legal
    if unknown:
        raise ValueError(f"unsweepable params {sorted(unknown)}; "
                         f"traced params are {sorted(legal)}")

    pols, fleets = _point_batch(policy, fleet, pts)

    prof = resolve_profile(billing)
    if cells is not None:
        if devices > 0:
            raise ValueError("cells sweeps do not shard over devices: the "
                             "cell axis owns the scan's leading dimension")
        from repro_torch.cells.fluid import cells_chunked_summaries
        cell_traces, topo = cells
        summaries = cells_chunked_summaries(
            cell_traces, topo, policy, pols, fleets, sim=sim, dt=dt,
            num_nodes=0, provision_s=fleet.provision_s, has_fleet=True,
            chunk_ticks=chunk_ticks, warmup_frac=warmup_frac, nbins=256,
            billing=prof, device=dev)
    else:
        summaries = _chunked_summaries(
            trace, policy, pols, fleets, sim=sim, dt=dt, num_nodes=0,
            provision_s=fleet.provision_s, has_fleet=True,
            chunk_ticks=chunk_ticks, warmup_frac=warmup_frac, nbins=256,
            billing=prof, devices=devices, device=dev)

    if node_type is None:
        # derive a shape from the fleet's node size at the default $/GB-hour
        base = NodeType()
        ratio = fleet.node_memory_mb / base.memory_mb
        node_type = NodeType(memory_mb=fleet.node_memory_mb,
                             vcpus=base.vcpus * ratio,
                             price_per_hour=base.price_per_hour * ratio,
                             provision_s=fleet.provision_s)
    nt = node_type
    rows = []
    for i, p in enumerate(pts):
        s = summaries[i]
        node_mem = fleets[i, _PFLEET.index("node_memory_mb")]
        if node_mem != nt.memory_mb:
            # sweeping node size: scale price and vCPUs linearly ($/GB-hour
            # held constant) so cost rows stay comparable across shapes
            ratio = node_mem / nt.memory_mb
            nt_i = NodeType(name=nt.name, memory_mb=float(node_mem),
                            vcpus=nt.vcpus * ratio,
                            price_per_hour=nt.price_per_hour * ratio,
                            provision_s=nt.provision_s)
        else:
            nt_i = nt
        cap_mb = max(s["nodes_mean"] * node_mem, 1e-9)
        cost = bill_summary(s, prof, node_type=nt_i, dt=dt, cap_mb=cap_mb)
        rows.append({**p, **s, **cost.row()})
    return rows


def default_fleet(sc: Scenario) -> JaxFleet:
    """An elastic twin of a static-cluster scenario: same node shape, the
    static size as headroom cap (x2 so the search can buy burst capacity).
    Cost needs node accounting, so the frontier always runs two-level."""
    if sc.fleet is not None:
        return sc.fleet
    return JaxFleet(node_memory_mb=NodeType().memory_mb,
                    min_nodes=1.0, max_nodes=float(max(4, 2 * sc.num_nodes)))


def _effective_key(point: dict, family: str) -> tuple:
    """Collapse knobs the scenario's policy family never reads, so inert
    grid axes do not multiply simulation work (point ids stay distinct)."""
    active = set(active_knobs(family)) | set(_PFLEET)
    return tuple(sorted((k, v) for k, v in point.items() if k in active))


def evaluate_scenario(scenario: Union[str, Scenario], points: Sequence[dict],
                      sim: Optional[SimConfig] = None,
                      dedupe: bool = True, *,
                      spec: Optional[RunSpec] = None,
                      device=None) -> list[dict]:
    """Evaluate every point against one scenario's workload; one row per
    point, tagged with ``point_id`` (the index into ``points``) and the
    scenario identity so downstream reducers can join across scenarios.

    Run configuration (scale / billing / devices / cluster) lands through
    ``spec`` (``repro_torch.core.runspec.RunSpec``) only — the loose ``scale=``
    / ``billing=`` shim keywords were removed.  ``sim`` and ``dedupe``
    are genuine per-call arguments.  ``spec.cluster`` > 0 buckets the
    long tail into weighted super-functions before the sweep
    (throttle-then-cluster); ``devices`` shards the point batch (see
    ``evaluate_points``).

    ``spec.billing`` defaults to the scenario's own profile (a spot
    scenario carries its tier discount there); a profile given by name
    inherits that discount.  The profile's cpu-throttle term stretches
    the trace BEFORE simulation, so a provider profile is a different
    workload, not just a different invoice.  The points run on ``device``
    (CUDA by default), resolved before any trace is built."""
    spec = spec if spec is not None else RunSpec()
    if not isinstance(spec, RunSpec):
        raise TypeError("evaluate_scenario() spec= must be a RunSpec, got "
                        f"{type(spec).__name__}")
    dev = resolve_device(device)
    scale = spec.scale
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    sim = sim or SimConfig(tick_s=sc.policy.tick_s)
    prof = resolve_profile(spec.billing, sc.billing)
    policy = sc.policy.to_jax()
    fleet = default_fleet(sc)
    cells_active = sc.cells is not None and not sc.cells.is_trivial
    if cells_active and spec.cluster > 0:
        raise ValueError(f"scenario {sc.name!r}: cells topologies partition "
                         f"an event stream — clustered sweeps cannot carry "
                         f"them")

    pts = list(points)
    if dedupe:
        uniq: dict[tuple, int] = {}
        order = []
        for p in pts:
            key = _effective_key(p, policy.family)
            if key not in uniq:
                uniq[key] = len(order)
                order.append(p)
            # remember which unique simulation backs each point
        backing = [uniq[_effective_key(p, policy.family)] for p in pts]
    else:
        order, backing = pts, list(range(len(pts)))

    t0 = time.time()
    if cells_active:
        # ``cell_count`` is STRUCTURAL: it changes the trace partition, not
        # just traced math, so points are grouped by its rounded value and
        # each group runs one batched multi-cell scan over its own
        # partition.  (``route_skew`` overrides stay traced — they steer
        # failover/spill preference; the origin partition keeps the
        # topology's static skew.)
        from repro_torch.cells.topology import build_cell_traces
        uniq_rows: list = [None] * len(order)
        base_count = sc.cells.cell_count
        groups: dict[int, list[int]] = {}
        for i, p in enumerate(order):
            c = int(round(p.get("cell_count", base_count)))
            groups.setdefault(c, []).append(i)
        n_functions = 0
        for c, idxs in sorted(groups.items()):
            topo = (sc.cells if c == base_count
                    else dataclasses.replace(sc.cells, cell_count=c))
            cell_traces = [apply_throttle(t, prof) for t in
                           build_cell_traces(dataclasses.replace(
                               sc, cells=topo), scale)]
            n_functions = cell_traces[0].num_functions
            sub = evaluate_points(cell_traces[0], policy, fleet,
                                  [order[i] for i in idxs], sim=sim,
                                  dt=sim.tick_s, billing=prof,
                                  chunk_ticks=sc.chunk_ticks,
                                  cells=(cell_traces, topo), device=dev)
            for i, r in zip(idxs, sub):
                uniq_rows[i] = r
    else:
        trace = apply_throttle(sc.build_trace(scale), prof)
        if spec.cluster > 0:
            from repro_torch.scenarios.cluster import cluster_functions
            trace = cluster_functions(trace, spec.cluster, tick_s=sim.tick_s)
        n_functions = trace.num_functions
        uniq_rows = evaluate_points(trace, policy, fleet, order, sim=sim,
                                    dt=sim.tick_s, billing=prof,
                                    chunk_ticks=sc.chunk_ticks,
                                    devices=spec.devices, device=dev)
    wall = time.time() - t0
    rows = []
    for pid, p in enumerate(pts):
        base = uniq_rows[backing[pid]]
        rows.append({**base, **p, "point_id": pid, "scenario": sc.name,
                     "scale": scale, "policy_kind": sc.policy.kind,
                     "num_functions": n_functions,
                     "sims": len(order), "stage_wall_s": round(wall, 3)})
    return rows


@dataclasses.dataclass
class FrontierResult:
    """Everything the coarse+refine search produced."""
    space: SearchSpace
    points: list[dict]                   # the full candidate set (id = index)
    scale: float                         # refine-stage trace scale
    coarse_scale: float
    coarse: dict[str, list[dict]]        # scenario -> rows (all points)
    refined: dict[str, list[dict]]       # scenario -> rows (refine set only)
    fronts: dict[str, list[dict]]        # scenario -> Pareto front (refined)
    robust_ids: list[int]                # robust frontier point ids (refined)
    wall_s: float
    # the billing spec every row was costed with — spot-check backfills
    # must re-evaluate on the same basis or dominance comparisons are
    # garbage (None = each scenario's own profile, the default)
    billing: Union[str, BillingProfile, None] = None
    # the sharding / clustering basis of every row, for the same reason
    devices: int = 0
    cluster: float = 0.0
    # which search engine produced this result ("grid" enumerates, "evo"
    # evolves — see repro_torch.opt.evo) and, for evo, the exact evaluation
    # ledger (an ``repro_torch.opt.evo.EvalBudget``)
    algo: str = "grid"
    budget: Optional[object] = None

    def robust_rows(self) -> list[dict]:
        """The robust frontier as rows: one per (robust point, scenario),
        at refine fidelity — the CSV/JSON the CLI emits."""
        out = []
        for pid in self.robust_ids:
            for name, rows in sorted(self.refined.items()):
                r = next((rr for rr in rows if rr["point_id"] == pid), None)
                if r is not None:
                    out.append(r)
        return out

    def summary(self) -> dict:
        return {
            "algo": self.algo,
            "budget": self.budget.summary() if self.budget is not None
            else None,
            "scale": self.scale, "coarse_scale": self.coarse_scale,
            "n_points": len(self.points), "wall_s": round(self.wall_s, 3),
            "scenarios": {
                name: {
                    "coarse_sims": self.coarse[name][0]["sims"]
                    if self.coarse[name] else 0,
                    "refined_points": len(self.refined[name]),
                    "front": [
                        {k: r[k] for k in (*r.keys() & SWEEPABLE, "point_id",
                                           X_DEFAULT, Y_DEFAULT)}
                        for r in self.fronts[name]],
                } for name in sorted(self.fronts)},
            "robust_point_ids": self.robust_ids,
            "robust_points": [self.points[i] for i in self.robust_ids],
        }


def _front_hypervolume(rows: Sequence[dict]) -> float:
    """Dominated-area hypervolume of a row set's Pareto front, referenced
    just beyond the set's own worst finite corner — the per-round search
    progress number the telemetry stream carries (comparable within one
    search, not across searches)."""
    xs = [r[X_DEFAULT] for r in rows if np.isfinite(r.get(X_DEFAULT, np.nan))]
    ys = [r[Y_DEFAULT] for r in rows if np.isfinite(r.get(Y_DEFAULT, np.nan))]
    if not xs or not ys:
        return 0.0
    return hypervolume(rows, x_ref=1.05 * max(xs), y_ref=1.05 * max(ys))


# coarse stage floor: below ~0.05x, Scenario.scaled_config's clamps
# (>=8 functions, >=240 s) take over and the grid would be ranked on a
# degenerate workload unrelated to the refine-stage one
MIN_COARSE_SCALE = 0.05

# the search engines frontier_search can dispatch to; the CLI validates
# its --algo flag against this tuple (repro_torch.launch.flags)
SEARCH_ALGOS = ("grid", "evo")


def frontier_search(scenarios: Optional[Sequence[Union[str, Scenario]]] = None,
                    space: SearchSpace = DEFAULT_SPACE, scale: float = 1.0,
                    coarse_frac: float = 0.1, eps: float = 0.15,
                    survivor_cap: int = 12,
                    billing: Union[str, BillingProfile, None] = None,
                    log: Optional[Callable[[str], None]] = None,
                    telemetry=None, devices: int = 0,
                    cluster: float = 0.0, *, algo: str = "grid",
                    budget: Optional[int] = None, seed: int = 0,
                    forbidden: Sequence[dict] = (),
                    evo_config=None, device=None) -> FrontierResult:
    """The coarse -> survive -> refine -> reduce pipeline over every given
    scenario (default: every registered event-level scenario).  ``scale``
    is the refine-stage trace scale; the coarse grid runs at
    ``coarse_frac * scale``, clamped to [MIN_COARSE_SCALE, scale] so a
    small search scale never pushes the coarse traces onto their
    degenerate size floors.

    ``algo`` picks the search engine over the SAME space and contract:
    ``"grid"`` (default) enumerates the cartesian product as described
    above; ``"evo"`` dispatches to the population optimizer
    (``repro_torch.opt.evo.evo_search`` — NSGA-II selection over the same
    coarse scale, budgeted in simulated candidate-scenario pairs, grid
    parity by default via ``grid_budget``).  ``budget`` / ``seed`` /
    ``forbidden`` / ``evo_config`` parameterize the evo engine and are
    ignored by the grid (enumeration has no stochastic state and always
    costs exactly its deduped product).  Both engines return the same
    ``FrontierResult`` (tagged ``algo``), so ``oracle_spot_check`` and
    the CLI output paths apply unchanged.

    ``devices`` shards each stage's candidate batch over local devices
    (the point axis, see ``evaluate_points``); ``cluster`` buckets each
    scenario's long tail below that mean-rps threshold into weighted
    super-functions first.  Rate-based scenarios (``rate_trace=True``,
    e.g. fig9_planet) are excluded from the default scenario set — the
    oracle spot-check cannot replay them and their size would dwarf every
    other stage; name one explicitly to search it.

    ``telemetry`` (a ``repro_torch.obs.RunTelemetry``) receives one event per
    stage x scenario carrying sims / wall / front size / hypervolume.

    Every stage runs on ``device`` (CUDA by default), resolved before the
    first trace is built."""
    if algo not in SEARCH_ALGOS:
        raise ValueError(f"unknown search algo {algo!r}; "
                         f"choose from {list(SEARCH_ALGOS)}")
    dev = resolve_device(device)
    if algo == "evo":
        from repro_torch.opt.evo.engine import EvoConfig, evo_search
        return evo_search(scenarios, space, scale, coarse_frac, eps,
                          survivor_cap, billing, log, telemetry, devices,
                          cluster, budget=budget, seed=seed,
                          config=evo_config or EvoConfig(),
                          forbidden=forbidden, device=dev)
    t_start = time.time()
    say = log or (lambda s: None)
    tel = telemetry.emit if telemetry is not None else (lambda *a, **k: None)
    if scenarios is None:
        scenarios = [n for n in list_scenarios()
                     if not get_scenario(n).rate_trace]
    # Scenario OBJECTS are honored verbatim (a tiered re-spec from
    # apply_tier is not the registry entry of the same name)
    scs = {}
    for s in scenarios:
        sc = get_scenario(s) if isinstance(s, str) else s
        scs[sc.name] = sc
    points = space.points()
    coarse_scale = min(max(scale * coarse_frac, MIN_COARSE_SCALE), scale)
    run_spec = RunSpec(billing=billing, devices=devices, cluster=cluster)

    coarse: dict[str, list[dict]] = {}
    for name, sc in scs.items():
        coarse[name] = evaluate_scenario(
            sc, points, spec=run_spec.replace(scale=coarse_scale), device=dev)
        say(f"coarse {name}: {coarse[name][0]['sims']} sims for "
            f"{len(points)} points in {coarse[name][0]['stage_wall_s']}s")
        tel("frontier_coarse", scenario=name, sims=coarse[name][0]["sims"],
            points=len(points), wall_s=coarse[name][0]["stage_wall_s"],
            hypervolume=_front_hypervolume(coarse[name]))

    survivors = {name: {r["point_id"]
                        for r in epsilon_survivors(rows, eps=eps,
                                                   cap=survivor_cap)}
                 for name, rows in coarse.items()}
    robust_candidates = set(robust_front(coarse))
    say(f"survivors/scenario: "
        f"{ {n: len(s) for n, s in sorted(survivors.items())} }; "
        f"{len(robust_candidates)} robust candidates")

    # one shared refine pool: every scenario's survivors + robust candidates
    ids = sorted(set().union(*survivors.values()) | robust_candidates) \
        if survivors else sorted(robust_candidates)
    sub = [points[i] for i in ids]
    refined: dict[str, list[dict]] = {}
    for name, sc in scs.items():
        rows = evaluate_scenario(sc, sub, spec=run_spec.replace(scale=scale),
                                 device=dev)
        for r, pid in zip(rows, ids):     # re-key to global point ids
            r["point_id"] = pid
        refined[name] = rows
        say(f"refine {name}: {rows[0]['sims'] if rows else 0} sims for "
            f"{len(ids)} pooled survivors")
        tel("frontier_refine", scenario=name,
            sims=rows[0]["sims"] if rows else 0, survivors=len(ids),
            wall_s=rows[0]["stage_wall_s"] if rows else 0.0,
            front_size=len(pareto_front(rows)),
            hypervolume=_front_hypervolume(rows))

    fronts = {name: pareto_front(rows) for name, rows in refined.items()}
    robust_ids = robust_front(refined)
    tel("frontier_reduce", robust_points=len(robust_ids),
        wall_s=round(time.time() - t_start, 3))
    return FrontierResult(space=space, points=points, scale=scale,
                          coarse_scale=coarse_scale, coarse=coarse,
                          refined=refined, fronts=fronts,
                          robust_ids=robust_ids,
                          wall_s=time.time() - t_start, billing=billing,
                          devices=devices, cluster=cluster)


# ---------------------------------------------------------------------------
# oracle spot-checks: trust, but verify the fluid frontier
# ---------------------------------------------------------------------------

# per-scenario parity keys documented out-of-band (EXPERIMENTS.md: the
# renewal-matched expiry under-expires on strongly bursty sparse tails,
# which surfaces as a creation-rate gap on the production replay)
_PARITY_EXCLUDE: Mapping[str, tuple] = {"fig9_production": ("creation_rate",)}


def point_scenario(sc: Scenario, point: dict) -> Scenario:
    """Rebuild a scenario pinned to one searched configuration, so BOTH
    engines (oracle + fluid) replay exactly that point.

    Policy knobs always apply.  Fleet knobs apply only when the scenario is
    itself fleet-enabled: the parity band covers the instance-level metrics
    (slowdown / memory / creation), and the oracle's node layer is
    calibrated in the registered fleet configuration — grafting an elastic
    min_nodes=1 fleet onto a scenario specced with a static cluster puts
    its oracle leg outside that envelope (provision transients at every
    load wave), which measurement shows costs 2-5x the parity budget."""
    pol_rep = {}
    if "keepalive_s" in point:
        pol_rep["keepalive_s"] = float(point["keepalive_s"])
    if "target" in point:
        pol_rep["target"] = float(point["target"])
    if "cc" in point:
        pol_rep["container_concurrency"] = int(point["cc"])
    if "prewarm_s" in point:
        pol_rep["prewarm_s"] = float(point["prewarm_s"])
    # novel axes the scenario's family declares (e.g. the spot_aware
    # family's spot_fraction / hazard_per_hour) ride the ``extra`` mapping
    # — both lowerings (to_jax and the oracle fleet) read them from there
    fam_axes = set(sc.policy.family().axis_names())
    named = {"keepalive_s", "target", "cc", "prewarm_s"}
    novel = {k: float(v) for k, v in point.items()
             if k in fam_axes and k not in named and k not in _PFLEET}
    if novel:
        pol_rep["extra"] = {**dict(sc.policy.extra or {}), **novel}
    fleet = None
    if sc.fleet is not None:
        fleet = dataclasses.replace(
            sc.fleet, **{k: float(v) for k, v in point.items()
                         if k in _PFLEET})
    return dataclasses.replace(sc, policy=dataclasses.replace(sc.policy,
                                                              **pol_rep),
                               fleet=fleet)


def hazard_parity_gaps(sc_point: Scenario, scale: float,
                       seeds: Optional[Sequence[int]] = None, *,
                       device=None) -> dict:
    """Oracle-vs-fluid parity gaps for one pinned scenario.

    The oracle leg is averaged over ``seeds`` — by default three market
    seeds when the scenario's policy runs a preemption hazard (the fluid
    model is the hazard process's EXPECTATION, so a single Poisson reclaim
    realization would dominate the verdict) and a single replay otherwise.
    Shared by the spot-check machinery and the fig12 benchmark.  The fluid
    leg runs on ``device`` (CUDA by default)."""
    from repro_torch.scenarios.runner import PARITY_KEYS, run_scenario
    if seeds is None:
        hz = float((dict(sc_point.policy.extra or {})
                    ).get("hazard_per_hour", 0.0))
        seeds = (0, 1, 2) if hz > 0.0 else (0,)
    fluid = run_scenario(sc_point, spec=RunSpec(engines=("simjax",),
                                                scale=scale),
                         device=device)[0]
    acc = {m: 0.0 for m in PARITY_KEYS}
    for seed in seeds:
        row = run_scenario(sc_point,
                           spec=RunSpec(engines=("eventsim",), scale=scale,
                                        force_oracle=True),
                           sim=SimConfig(tick_s=sc_point.policy.tick_s,
                                         seed=seed))[0]
        for m in PARITY_KEYS:
            acc[m] += row[m] / len(seeds)
    return {m: abs(acc[m] - fluid[m]) / max(abs(acc[m]), 1e-9)
            for m in PARITY_KEYS}


def sample_front(front: Sequence[dict], k: int,
                 rng: Optional[np.random.Generator] = None) -> list[dict]:
    """Up to ``k`` winners along a (cost-sorted) front: evenly spaced by
    default, or — given an explicit seeded ``rng`` — a reproducible draw
    that keeps both endpoints and samples the interior without
    replacement.  All randomness on the spot-check path is INJECTED
    through this parameter; there is no module-level RNG to make two
    "identical" runs sample different winners."""
    if not front or k <= 0:
        return []
    if len(front) <= k:
        return list(front)
    if rng is None:
        idx = np.unique(np.linspace(0, len(front) - 1, k).round().astype(int))
    elif k == 1:
        idx = np.asarray([rng.integers(0, len(front))])
    else:
        interior = rng.choice(len(front) - 2,
                              size=min(k - 2, len(front) - 2),
                              replace=False) + 1
        idx = np.unique(np.concatenate(
            ([0, len(front) - 1], interior))).astype(int)
    return [front[i] for i in idx]


def oracle_spot_check(result: FrontierResult, k: int = 3,
                      scale: Optional[float] = None, tol: float = 0.15,
                      demote: bool = True, include_infeasible: bool = False,
                      log: Optional[Callable[[str], None]] = None,
                      telemetry=None,
                      rng: Optional[np.random.Generator] = None,
                      device=None) -> list[dict]:
    """Replay sampled frontier winners per oracle-feasible scenario through
    BOTH engines and judge the oracle-vs-fluid gap against the parity band.

    Runs at 0.25 scale by default regardless of the search scale: that is
    the scale where the discrete-event oracle is feasible AND where the
    parity band is calibrated — smaller traces are noise-dominated (a
    handful of functions carry the geomean), larger ones make the oracle
    leg the bottleneck.  Scenarios flagged ``oracle_ok=False`` (the
    production replay) are skipped by default — their discrete replay is
    feasible at 0.25x but costs minutes per point, blowing the CI budget;
    ``include_infeasible=True`` checks them anyway, with their
    ``_PARITY_EXCLUDE`` waivers applied (fig9's creation rate, see
    EXPERIMENTS.md).

    With ``demote`` (default), a winner the oracle refutes is REMOVED from
    that scenario's front (and from the robust frontier) and the front is
    re-derived without it; checking continues until ``k`` winners pass or
    2k candidates have been tried.  The emitted frontier is therefore the
    oracle-confirmed one — fluid-only points outside the calibrated
    envelope are demoted, not shipped — and every demotion is returned in
    the records, so nothing fails silently.

    Points whose policy runs a preemption hazard (the spot axes) replay
    the oracle over three market seeds and are judged against the AVERAGE
    (``hazard_parity_gaps``): the fluid model is the hazard process's
    expectation, and a handful of Poisson reclaim draws at 0.25x would
    otherwise dominate the verdict.

    ``rng`` (a seeded ``numpy.random.Generator``) randomizes which front
    winners are sampled, reproducibly; the default keeps the historical
    deterministic even spacing (see ``sample_front``).

    The fluid legs and the backfills run on ``device`` (CUDA by default),
    the oracle legs on the host.
    """
    dev = resolve_device(device)
    check_scale = 0.25 if scale is None else scale
    say = log or (lambda s: None)
    tel = telemetry.emit if telemetry is not None else (lambda *a, **k: None)
    records = []
    for name in sorted(result.fronts):
        sc = get_scenario(name)
        if not (sc.oracle_ok or include_infeasible):
            continue
        exclude = set(_PARITY_EXCLUDE.get(name, ()))
        family = sc.policy.to_jax().family

        def check_key(pid: int) -> tuple:
            # the configuration class one oracle replay actually verifies:
            # active policy knobs, plus fleet knobs only when the scenario's
            # oracle leg runs a fleet (see point_scenario) — points
            # differing only in knobs the check cannot see share one
            # verdict, so checking them separately would waste the budget
            # on duplicate replays
            active = set(active_knobs(family))
            if sc.fleet is not None:
                active |= set(_PFLEET)
            return tuple(sorted((kk, v) for kk, v in
                                result.points[pid].items() if kk in active))

        rows = list(result.refined[name])
        checked: set[tuple] = set()
        passed = 0
        budget = 2 * k
        # demotion fallback: coarse classes nearest the coarse front, so a
        # scenario whose whole refined pool gets refuted can still descend
        # into the next-best configurations instead of ending frontless
        cfront = pareto_front(result.coarse[name])
        backups = sorted(result.coarse[name],
                         key=lambda r: frontier_slack(r, cfront))
        while passed < k and budget > 0:
            front = pareto_front(rows)
            classes: list[dict] = []       # one representative per class
            seen = set(checked)
            for r in front:
                key = check_key(r["point_id"])
                if key not in seen:
                    seen.add(key)
                    classes.append(r)
            todo = sample_front(classes, k - passed, rng=rng)
            if not todo:
                if any(check_key(r["point_id"]) not in checked for r in rows):
                    # unchecked classes remain but are dominated by already
                    # confirmed winners — every winner is verified, done
                    break
                nxt = next((b for b in backups
                            if check_key(b["point_id"]) not in checked), None)
                if nxt is None:
                    break
                pid = nxt["point_id"]
                newrow = evaluate_scenario(
                    sc, [result.points[pid]],
                    spec=RunSpec(scale=result.scale, billing=result.billing,
                                 devices=result.devices,
                                 cluster=result.cluster), device=dev)[0]
                newrow["point_id"] = pid
                rows.append(newrow)
                result.refined[name] = rows
                say(f"spot {name}: backfilled point {pid} "
                    f"{result.points[pid]} from the coarse grid")
                continue
            for row in todo:
                pid = row["point_id"]
                key = check_key(pid)
                checked.add(key)
                budget -= 1
                point = result.points[pid]
                gaps = hazard_parity_gaps(point_scenario(sc, point),
                                          check_scale, device=dev)
                judged = {m: g for m, g in gaps.items() if m not in exclude}
                ok = bool(judged) and all(g <= tol for g in judged.values())
                records.append({
                    "scenario": name, "point_id": pid, "point": point,
                    "scale": check_scale, "gaps": gaps, "pass": ok,
                    "demoted": demote and not ok,
                })
                say(f"spot {name} point {pid} {point}: "
                    + ("ok " if ok else "DEMOTED ")
                    + " ".join(f"{m}={g:.3f}" for m, g in gaps.items()))
                if ok:
                    passed += 1
                elif demote:
                    # the oracle refuted the fluid claim for this whole
                    # configuration class, not just this grid point
                    rows = [r for r in rows
                            if check_key(r["point_id"]) != key]
                    result.refined[name] = rows
                if budget <= 0:
                    break
        result.fronts[name] = pareto_front(result.refined[name])
        mine = [r for r in records if r["scenario"] == name]
        tel("spot_check", scenario=name, checked=len(mine),
            passed=sum(r["pass"] for r in mine),
            demoted=sum(r["demoted"] for r in mine),
            front_size=len(result.fronts[name]),
            hypervolume=_front_hypervolume(result.refined[name]))
    if demote:
        # demotions change each scenario's surviving row set; the robust
        # frontier is recomputed over the confirmed rows (a demotion can
        # both remove robust points and promote ones its class shadowed)
        result.robust_ids = robust_front(result.refined)
    return records
