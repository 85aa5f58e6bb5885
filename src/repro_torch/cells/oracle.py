"""Oracle multi-cell engine: per-cell ``EventSim`` replicas + failover.

Each cell runs the FULL discrete simulator on its partition of the trace —
its own ``Cluster``, its own node fleet reconciled by
``ConvergenceFleetPolicy`` (utilization + scheduled + reactive desired
state, feeding ``NodeFleet``'s per-source scale-down cooldowns), its own
seeded spot market when the policy declares the spot axes.  The cells
layer wires them together:

* FAILOVER — the failed cell's simulation is truncated at the failure
  time (``duration_s = t_fail``: ticks, sampling and billing stop there,
  while the event heap drains so every accepted request still resolves).
  Requests still in flight at ``t_fail`` are harvested as RETRIES — their
  records are dropped from the dead cell (and their useful CPU backed
  out, since the work re-executes) and they restart from scratch on
  survivors at ``t_fail``.  Post-failure arrivals of the dead partition
  redirect the same way.  Both redistribute along the seeded failover
  distribution (``repro_torch.cells.traffic.failover_dist_np``) — the discrete
  twin of the fluid engine's dead-row flux.
* CORRELATED HAZARD — ``CorrelatedSpotMarket`` splits each cell's spot
  reclaim hazard into a SHARED storm process (one coin per poll time,
  common to all cells: when it fires, every polled spot node in every
  cell is reclaimed together — the cross-region capacity storm) and an
  independent per-node remainder, keeping the total per-node hazard equal
  to the configured rate so the mean-field (fluid) lowering is unchanged.

The per-cell ``SimResult``s are combined into one (record concatenation,
counter sums, zero-padded elementwise sample sums) so ``compute`` and
``bill_sim`` read a multi-region run exactly like a single-cluster one.

NOT modelled here: spill routing (the fluid router's overflow flux).  The
oracle routes by origin weight + failover only; parity scenarios run with
``spill_threshold = 0`` and EXPERIMENTS.md flags spill as fluid-only.

A copy of ``repro.cells.oracle`` (numpy only); its lazy imports of the
runner point at the port's runner.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.cluster import Cluster
from repro_torch.core.eventsim import EventSim, SimConfig, SimResult
from repro_torch.core.metrics import compute
from repro_torch.core.trace import Trace
from repro_torch.fleet.billing import bill_sim
from repro_torch.fleet.nodes import NodeFleet
from repro_torch.fleet.spot import CapacityTier, SpotMarket, SpotNodeFleet

from repro_torch.cells.topology import CellTopology
from repro_torch.cells.traffic import failover_dist_np
from repro_torch.cells.triggers import ConvergenceFleetPolicy

_FAILOVER_SALT = 0xFA110373
_STORM_SALT = 0x570A11ED


class SharedStorm:
    """The correlated component of a multi-cell spot hazard: one seeded
    coin per poll time, shared by every cell's market.  ``active`` is
    memoized on the poll time so all cells polling the same reconcile tick
    see the same storm decision."""

    def __init__(self, hazard_per_hour: float, corr: float, seed: int = 0):
        self.rate_s = corr * hazard_per_hour / 3600.0
        self.rng = np.random.default_rng(seed)
        self._events: dict = {}

    def active(self, t: float, dt: float) -> bool:
        key = round(float(t), 6)
        if key not in self._events:
            p = -math.expm1(-self.rate_s * dt)
            self._events[key] = bool(self.rng.uniform() < p)
        return self._events[key]


class CorrelatedSpotMarket(SpotMarket):
    """``SpotMarket`` with its hazard split ``corr`` shared / ``1 - corr``
    independent.  A shared-storm poll reclaims EVERY polled node (the
    fleet-wide eviction storm); otherwise each node faces the thinned
    private hazard.  Total per-node reclaim probability per interval stays
    ``1 - exp(-hazard * dt)`` to first order, so the fluid engine's
    mean-field eviction flux needs no change."""

    def __init__(self, tier: CapacityTier, seed: int = 0,
                 storm: Optional[SharedStorm] = None, corr: float = 0.0):
        super().__init__(tier, seed=seed)
        self.storm = storm
        self.corr = corr

    def preempted(self, t, nodes):
        dt = 0.0 if self._last_poll is None else max(t - self._last_poll, 0.0)
        self._last_poll = t
        if dt <= 0.0 or self.tier.hazard_per_hour <= 0.0 or not nodes:
            return []
        if self.storm is not None and self.storm.active(t, dt):
            return list(nodes)
        p = -math.expm1(-(1.0 - self.corr)
                        * self.tier.hazard_per_hour / 3600.0 * dt)
        return [n for n in nodes if self.rng.uniform() < p]


def _cell_fleet(jf, spec, topo: CellTopology, cell: int, duration_s: float,
                seed: int, storm: Optional[SharedStorm]) -> NodeFleet:
    """Lower the traced fleet parameters to one cell's oracle fleet — the
    cells variant of ``runner._oracle_fleet``, with the utilization policy
    replaced by the trigger-aware convergence reconciler."""
    from repro_torch.scenarios.runner import _spot_knobs, oracle_node_type
    nt = oracle_node_type(jf)
    policy = ConvergenceFleetPolicy(
        min_nodes=int(jf.min_nodes), max_nodes=int(jf.max_nodes),
        util_target=jf.util_target, warm_frac=jf.warm_frac,
        schedule=topo.schedule_entries(cell, duration_s),
        reactive=topo.reactive)
    sf, hz = _spot_knobs(spec) if spec is not None else (0.0, 0.0)
    if sf > 0.0 or hz > 0.0:
        tier = CapacityTier("spot", hazard_per_hour=hz,
                            reclaim_notice_s=jf.reclaim_notice_s)
        if storm is not None and topo.hazard_corr > 0.0:
            market = CorrelatedSpotMarket(tier, seed=seed, storm=storm,
                                          corr=topo.hazard_corr)
        else:
            market = SpotMarket(tier, seed=seed)
        return SpotNodeFleet(policy, node_type=nt, cooldown_s=jf.cooldown_s,
                             spot_fraction=sf, market=market)
    return NodeFleet(policy, node_type=nt, cooldown_s=jf.cooldown_s)


def _run_cell(sc, trace: Trace, sim: SimConfig, topo: CellTopology,
              cell: int, duration_s: float, warmup_s: float,
              storm: Optional[SharedStorm]) -> SimResult:
    """One cell's EventSim pass.  ``duration_s`` is the GLOBAL horizon
    (schedule windows are fractions of it, even when this cell's trace is
    truncated); ``warmup_s`` pins the global measure-from so a truncated
    cell measures [warmup, t_fail) rather than half its own horizon."""
    cfg = dataclasses.replace(sim, warmup_s=warmup_s,
                              seed=sim.seed + 101 * cell)
    if sc.fleet is not None:
        cluster = Cluster(max(1, int(sc.fleet.min_nodes)),
                          node_memory_mb=sc.fleet.node_memory_mb)
        fleet = _cell_fleet(sc.fleet, sc.policy, topo, cell, duration_s,
                            seed=cfg.seed, storm=storm)
    else:
        cluster = Cluster(int(topo.cell_nodes(sc.num_nodes)[cell]))
        fleet = None
    return EventSim(trace, cluster, sc.policy.factory(), cfg,
                    fleet=fleet).run()


def _pad_sum(arrays) -> np.ndarray:
    arrays = [np.asarray(a, np.float64) for a in arrays]
    out = np.zeros(max(len(a) for a in arrays))
    for a in arrays:
        out[:len(a)] += a
    return out


def _combine(results: list, measure_window_s: float) -> SimResult:
    """Merge per-cell SimResults into one: records concatenate (shared
    function-id space), counters sum, sample series zero-pad to the
    longest cell and sum elementwise (a dead cell simply stops
    contributing after its last sample)."""
    longest = max(results, key=lambda r: len(r.sample_times))
    return SimResult(
        records=[r for res in results for r in res.records],
        creations=sum(r.creations for r in results),
        teardowns=sum(r.teardowns for r in results),
        cpu_useful_s=sum(r.cpu_useful_s for r in results),
        cpu_worker_overhead_s=sum(r.cpu_worker_overhead_s for r in results),
        cpu_master_overhead_s=sum(r.cpu_master_overhead_s for r in results),
        mem_samples_total_mb=_pad_sum([r.mem_samples_total_mb
                                       for r in results]),
        mem_samples_busy_mb=_pad_sum([r.mem_samples_busy_mb
                                      for r in results]),
        sample_times=np.asarray(longest.sample_times).copy(),
        measure_window_s=measure_window_s,
        dropped=sum(r.dropped for r in results),
        node_seconds=sum(r.node_seconds for r in results),
        node_samples=_pad_sum([r.node_samples for r in results]),
        node_provisions=sum(r.node_provisions for r in results),
        node_terminations=sum(r.node_terminations for r in results),
        nodes_hint=sum(r.nodes_hint for r in results),
        spot_node_seconds=sum(r.spot_node_seconds for r in results),
        node_evictions=sum(r.node_evictions for r in results),
        mem_samples_starting_mb=_pad_sum([r.mem_samples_starting_mb
                                          for r in results]),
        cpu_churn_creation_s=sum(r.cpu_churn_creation_s for r in results),
        cpu_evict_storm_s=sum(r.cpu_evict_storm_s for r in results),
        cpu_keepalive_idle_s=sum(r.cpu_keepalive_idle_s for r in results))


def run_cells_eventsim(sc, traces, sim: SimConfig, *,
                       detail: Optional[dict] = None,
                       billing=None) -> dict:
    """Run a cells scenario through per-cell EventSims and return one
    combined metric row (the multi-region twin of ``runner._run_eventsim``).

    ``traces`` is the per-cell partition from ``build_cell_traces``.  When
    ``detail`` is a dict it receives ``oracle_result`` (the combined
    ``SimResult``) and ``cell_results`` (the per-cell list, failback
    adjustments applied)."""
    topo = sc.cells
    c_n = topo.cell_count
    duration = float(traces[0].duration_s)
    warmup = sim.warmup_s if sim.warmup_s is not None else duration / 2.0
    t_fail = topo.fail_time(duration)
    extra = dict(sc.policy.extra or {})
    route_skew = float(extra.get("route_skew", topo.route_skew))

    storm = None
    if sc.fleet is not None and topo.hazard_corr > 0.0:
        from repro_torch.scenarios.runner import _spot_knobs
        _, hz = _spot_knobs(sc.policy)
        if hz > 0.0:
            storm = SharedStorm(hz, topo.hazard_corr,
                                seed=sim.seed ^ _STORM_SALT)

    cell_traces = list(traces)
    results: list = [None] * c_n
    if t_fail is not None:
        fc = topo.fail_cell
        tr = traces[fc]
        pre = tr.t < t_fail
        dead_trace = Trace(tr.t[pre], tr.fn[pre].astype(np.int32),
                           tr.dur[pre], tr.profile, t_fail)
        res = _run_cell(sc, dead_trace, sim, topo, fc, duration, warmup,
                        storm)
        # in flight at t_fail: these completed only in the drain — the
        # region died under them, so they re-execute on survivors (their
        # useful CPU is backed out here and re-earned there)
        ghosts = [r for r in res.records if r.end > t_fail]
        results[fc] = dataclasses.replace(
            res, records=[r for r in res.records if r.end <= t_fail],
            cpu_useful_s=res.cpu_useful_s - sum(g.dur for g in ghosts))
        # redirect retries (restarting at t_fail) + the dead partition's
        # post-failure arrivals along the failover distribution
        alive = np.ones(c_n)
        alive[fc] = 0.0
        dist = failover_dist_np(alive, route_skew)
        rng = np.random.default_rng((sim.seed << 1) ^ _FAILOVER_SALT)
        post = ~pre
        r_t = np.concatenate([np.full(len(ghosts), t_fail), tr.t[post]])
        r_fn = np.concatenate([np.asarray([g.fn for g in ghosts], np.int64),
                               tr.fn[post]]).astype(np.int32)
        r_dur = np.concatenate([np.asarray([g.dur for g in ghosts]),
                                tr.dur[post]])
        assign = rng.choice(c_n, size=len(r_t), p=dist)
        for d in range(c_n):
            if d == fc:
                continue
            sel = assign == d
            base = traces[d]
            t2 = np.concatenate([base.t, r_t[sel]])
            order = np.argsort(t2, kind="stable")
            cell_traces[d] = Trace(
                t2[order],
                np.concatenate([base.fn, r_fn[sel]])[order].astype(np.int32),
                np.concatenate([base.dur, r_dur[sel]])[order],
                base.profile, duration)

    for c in range(c_n):
        if results[c] is None:
            results[c] = _run_cell(sc, cell_traces[c], sim, topo, c,
                                   duration, warmup, storm)

    combined = _combine(results, max(duration - warmup, 1e-9))
    if detail is not None:
        detail["oracle_result"] = combined
        detail["cell_results"] = results
    row = compute(combined).row()
    if billing is not None:
        from repro_torch.scenarios.runner import _billing_node_type
        row.update(bill_sim(combined, traces[0], billing,
                            node_type=_billing_node_type(sc)).row())
    return row
