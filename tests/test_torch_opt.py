"""``repro_torch.opt`` (grid and NSGA-II search) and ``repro_torch.fleet.sweep``
against ``repro.opt`` and ``repro.fleet.sweep``.

The cases of ``tests/test_opt.py`` and ``tests/test_evo.py``, each as a hold
of the port against the JAX package on the same inputs: the Pareto reducers,
the search space, the NSGA-II primitives, the genome and the budget exactly;
``evaluate_scenario``, ``evaluate_points``, ``fleet.sweep`` and the grid
``frontier_search`` rows at rtol 1e-4 (the slowdown at 1e-3), their fronts
and robust ids equal and the hypervolume at 1e-4; the evo engine's point
sequence equal at a seed (on an analytic evaluator and on the simulator,
gradient refinement included); ``oracle_spot_check``'s verdicts; the device
rule.  Scenarios run at 0.05-0.1 x on the CPU.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.opt as J
import repro.opt.evo as JE
import repro.opt.frontier as JF
from repro.core.runspec import RunSpec as JRunSpec
from repro.core.simjax import JaxFleet as JFleet
from repro.core.simjax import JaxPolicy as JPolicy
from repro.core.trace import TraceConfig as JConfig
from repro.core.trace import synthesize as j_synth
from repro.fleet.sweep import sweep as j_sweep
from repro.scenarios import get_scenario as j_scenario
from repro.scenarios.runner import frontier as j_frontier

import repro_torch.opt as T
import repro_torch.opt.evo as TE
import repro_torch.opt.frontier as TF
from repro_torch.core.runspec import RunSpec as TRunSpec
from repro_torch.core.simtorch import JaxFleet as TFleet
from repro_torch.core.simtorch import JaxPolicy as TPolicy
from repro_torch.core.trace import TraceConfig as TConfig
from repro_torch.core.trace import synthesize as t_synth
from repro_torch.fleet.sweep import sweep as t_sweep
from repro_torch.scenarios import get_scenario as t_scenario
from repro_torch.scenarios.runner import frontier as t_frontier

from torch_dist_common import jax_jobs
from torch_opt_common import fields, hold_result, hold_row, hold_rows

TC = dict(num_functions=30, duration_s=600, target_total_rps=5, seed=11)
SMALL = dict(policy={"keepalive_s": (60.0, 600.0)}, fleet={"warm_frac": (0.0, 0.25)})
CELLS = dict(policy={"keepalive_s": (60.0, 300.0, 1200.0), "spot_fraction": (0.0, 0.6),
                     "cell_count": (2.0, 4.0, 8.0)},
             fleet={"util_target": (0.6, 0.8)})


@pytest.fixture(scope="module")
def traces():
    return j_synth(JConfig(**TC)), t_synth(TConfig(**TC))


def _spaces(kw):
    return J.SearchSpace(**kw), T.SearchSpace(**kw)


# ---------------------------------------------------------------------------
# the pure reducers and the search space: exactly JAX's
# ---------------------------------------------------------------------------


def _rows(pairs):
    return [{"cost_per_million": c, "slowdown_geomean_p99": s, "point_id": i}
            for i, (c, s) in enumerate(pairs)]


_RNG = np.random.default_rng(4)
ROW_SETS = {
    "empty": [],
    "single": _rows([(1.0, 2.0)]),
    "ties": _rows([(1, 2), (1, 2), (2, 1)]),
    "dominated_and_nan": _rows([(1, 5), (2, 3), (3, 4), (4, 1), (5, 2), (0.1, math.nan)]),
    "near_band": _rows([(1.0, 1.0), (1.05, 1.05), (2.0, 2.0)]),
    "random": _rows(_RNG.uniform(1.0, 10.0, size=(40, 2)).tolist()),
}


@pytest.mark.parametrize("name", list(ROW_SETS))
def test_frontier_reducers_match_jax(name):
    rows = ROW_SETS[name]
    assert TF.pareto_front(rows) == JF.pareto_front(rows)
    for eps, cap in ((0.10, 10), (5.0, 2), (0.15, 12)):
        assert TF.epsilon_survivors(rows, eps=eps, cap=cap) == \
            JF.epsilon_survivors(rows, eps=eps, cap=cap)
    for ref in ((2000.0, 50.0), (6.0, 6.0)):
        a, b = TF.hypervolume(rows, *ref), JF.hypervolume(rows, *ref)
        assert (math.isnan(a) and math.isnan(b)) or a == b
    front = JF.pareto_front(rows)
    for r in rows:
        assert TF.frontier_slack(r, front) == JF.frontier_slack(r, front)
    other = _rows(list(reversed([(r["cost_per_million"], r["slowdown_geomean_p99"])
                                 for r in rows])))
    assert TF.robust_front({"A": rows, "B": other}) == JF.robust_front({"A": rows, "B": other})


@pytest.mark.parametrize("module", ["opt", "opt.evo", "opt.frontier", "opt.space", "opt.search",
                                    "opt.learned", "opt.evo.engine", "opt.evo.genome",
                                    "opt.evo.nsga", "opt.evo.budget", "fleet.sweep",
                                    "launch.frontier"])
def test_public_names_match_jax(module):
    import importlib
    j = importlib.import_module(f"repro.{module}")
    t = importlib.import_module(f"repro_torch.{module}")
    own = {n for n in dir(j) if not n.startswith("_")
           and getattr(getattr(j, n), "__module__", "").startswith("repro.")}
    missing = {n for n in own if not hasattr(t, n)}
    assert not missing
    assert getattr(t, "__all__", None) == getattr(j, "__all__", None)


@pytest.mark.parametrize("grid", [{}, {"a": [1, 2], "b": [3]},
                                  {**CELLS["policy"], **CELLS["fleet"]}])
def test_grid_points_match_jax(grid):
    assert T.grid_points(grid) == J.grid_points(grid)


def test_search_space_matches_jax():
    from repro.core.policy_api import list_families
    from repro.opt.space import sweepable_knobs as j_knobs
    from repro_torch.opt.space import sweepable_knobs as t_knobs
    # the import-time snapshot and the live registry (the cells family
    # registers its axes when the cells package is imported)
    assert T.SWEEPABLE == J.SWEEPABLE
    assert t_knobs() == j_knobs() >= J.SWEEPABLE | {"cell_count"}
    for fam in list_families():
        assert T.active_knobs(fam) == J.active_knobs(fam)
    for kind in (0, 1, 2, 3):
        assert T.active_knobs(kind) == J.active_knobs(kind)
    assert T.DEFAULT_SPACE.points() == J.DEFAULT_SPACE.points()
    assert T.DEFAULT_SPACE.size() == J.DEFAULT_SPACE.size() == 96
    a, b = _spaces(SMALL)
    assert (a.points(), a.size()) == (b.points(), b.size())


@pytest.mark.parametrize("bad", [dict(policy={"bogus": (1.0,)}),
                                 dict(fleet={"keepalive_s": (60.0,)}),
                                 dict(policy={"target": ()}),
                                 dict(policy={"target": (0.5, math.inf)})])
def test_search_space_refusals_match_jax(bad):
    with pytest.raises(ValueError) as want:
        J.SearchSpace(**bad)
    with pytest.raises(ValueError) as got:
        T.SearchSpace(**bad)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# NSGA-II primitives, genome, budget: exactly JAX's on the same draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nsga_primitives_match_jax(seed):
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.0, 1.0, size=(24, 2))
    F[rng.integers(0, 24, size=3)] = F[0]               # duplicates
    if seed:
        F[5, 0], F[9, 1] = np.nan, np.inf                # quarantined rows
    (ra, fa), (rb, fb) = TE.non_dominated_sort(F), JE.non_dominated_sort(F)
    np.testing.assert_array_equal(ra, rb)
    assert len(fa) == len(fb) and all(np.array_equal(x, y) for x, y in zip(fa, fb))
    for front in fb:
        np.testing.assert_array_equal(TE.crowding_distance(F, front),
                                      JE.crowding_distance(F, front))
    (ka, ca), (kb, cb) = TE.nsga_rank(F), JE.nsga_rank(F)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(ca, cb)
    lo, hi = np.zeros(3), np.asarray([1.0, 10.0, 100.0])
    ga, gb = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    pool = np.arange(24)
    for _ in range(20):
        assert TE.tournament_pick(ga, ka, ca, pool) == JE.tournament_pick(gb, kb, cb, pool)
        x, y = ga.uniform(lo, hi), gb.uniform(lo, hi)
        u, v = ga.uniform(lo, hi), gb.uniform(lo, hi)
        for p, q in zip(TE.sbx_crossover(ga, x, u, lo, hi), JE.sbx_crossover(gb, y, v, lo, hi)):
            np.testing.assert_array_equal(p, q)
        np.testing.assert_array_equal(TE.polynomial_mutation(ga, x, lo, hi, p_mut=0.7),
                                      JE.polynomial_mutation(gb, y, lo, hi, p_mut=0.7))


@pytest.mark.parametrize("space,families", [
    ("default", ["sync"]), ("default", ["async"]), ("default", ["sync", "spot_aware"]),
    ("default", None), ("cells", ["cells"])])
def test_genome_matches_jax(space, families):
    kw = {"default": dict(policy=dict(J.DEFAULT_SPACE.policy),
                          fleet=dict(J.DEFAULT_SPACE.fleet)), "cells": CELLS}[space]
    js, ts = _spaces(kw)
    gj, gt = JE.genome_from_space(js, families), TE.genome_from_space(ts, families)
    assert [dataclasses.astuple(g) for g in gt.genes] == \
        [dataclasses.astuple(g) for g in gj.genes]
    assert gt.fixed == gj.fixed
    np.testing.assert_array_equal(gt.lo, gj.lo)
    np.testing.assert_array_equal(gt.hi, gj.hi)
    rng = np.random.default_rng(3)
    for p in js.points():
        np.testing.assert_array_equal(gt.encode(p), gj.encode(p))
        assert gt.project(p) == gj.project(p)
        v = rng.uniform(np.maximum(gj.lo, -50.0), np.minimum(gj.hi, 50.0))
        np.testing.assert_array_equal(gt.repair(v), gj.repair(v))
        assert gt.decode(v) == gj.decode(v)
        assert TE.point_key(gt.decode(v)) == JE.point_key(gj.decode(v))


def test_genome_refusals_match_jax():
    bad = dict(policy={"target": (0.01, 1.0)})           # the axis' lo is 0.05
    with pytest.raises(ValueError, match="leaves the declared axis bounds"):
        JE.genome_from_space(J.SearchSpace(**bad), ["async"])
    with pytest.raises(ValueError, match="leaves the declared axis bounds"):
        TE.genome_from_space(T.SearchSpace(**bad), ["async"])


def _ledger(mod):
    """The same spends, records and refusals through one package's budget."""
    out = []
    b = mod.EvalBudget(20)
    b.spend(6, "seed", "s1", 0)
    b.spend(6, "evolve", "s1", 1)
    b.record(40, "refine", "s1")
    out.append((b.spent, b.remaining, b.recorded, b.exhausted, b.can_afford(8)))
    with pytest.raises(mod.BudgetExhausted) as e:
        b.spend(9, "evolve")
    out.append(str(e.value))
    b.spend(8, "evolve", "s1", 2)
    for bad in ((lambda: b.spend(-1, "x")), (lambda: b.record(-1, "x")),
                (lambda: mod.EvalBudget(0))):
        with pytest.raises(ValueError) as e:
            bad()
        out.append(str(e.value))
    return out + [b.summary(), b.ledger]


def test_budget_matches_jax():
    assert _ledger(TE) == _ledger(JE)


@pytest.mark.parametrize("names", [["fleet_cost_stress"],
                                   ["fleet_cost_stress", "flash_crowd"],
                                   ["region_failover", "spot_storm", "cold_tail"]])
def test_grid_budget_matches_jax(names):
    assert T.grid_budget(T.DEFAULT_SPACE, names) == J.grid_budget(J.DEFAULT_SPACE, names)


@pytest.mark.parametrize("k,seeded", [(0, False), (1, True), (3, False), (3, True),
                                      (10, True)])
def test_sample_front_matches_jax(k, seeded):
    front = _rows([(i, 10 - i) for i in range(7)])
    ga = np.random.default_rng(9) if seeded else None
    gb = np.random.default_rng(9) if seeded else None
    assert T.sample_front(front, k, rng=ga) == J.sample_front(front, k, rng=gb)


# ---------------------------------------------------------------------------
# the simulator-backed stages: rows at rtol 1e-4, fronts and ids equal
# ---------------------------------------------------------------------------

EVAL_CASES = {
    "cold_tail": (0.05, {"keepalive_s": [60.0, 600.0], "target": [0.5, 1.0]}),
    "fleet_cost_stress": (0.05, None),                     # DEFAULT_SPACE: 16 sims
    "region_failover": (0.05, {"keepalive_s": [60.0, 600.0], "cell_count": [2.0, 3.0]}),
    "spot_storm": (0.05, {"keepalive_s": [60.0, 600.0], "spot_fraction": [0.0, 0.6]}),
}


@pytest.mark.parametrize("name", list(EVAL_CASES))
def test_evaluate_scenario_matches_jax(name):
    scale, grid = EVAL_CASES[name]
    pts = J.DEFAULT_SPACE.points() if grid is None else J.grid_points(grid)
    want = J.evaluate_scenario(name, pts, spec=JRunSpec(scale=scale))
    got = T.evaluate_scenario(name, pts, spec=TRunSpec(scale=scale), device="cpu")
    hold_rows(got, want)
    assert got[0]["sims"] == want[0]["sims"] <= len(pts)


@pytest.mark.parametrize("policy,points", [
    (dict(kind=1, window_s=60, target=0.7), [{"cc": 1.0}, {"cc": 4.0}]),
    (dict(kind=2, keepalive_s=1800.0), [{"prewarm_s": 0.0}, {"prewarm_s": 4.0}]),
    (dict(kind=0), [{"keepalive_s": 60.0, "node_memory_mb": 16384.0},
                    {"keepalive_s": 600.0, "max_nodes": 4.0}]),
])
def test_evaluate_points_matches_jax(traces, policy, points):
    jt, tt = traces
    kw = dict(node_memory_mb=8192.0)
    want = J.evaluate_points(jt, JPolicy(**policy), JFleet(**kw), points)
    got = T.evaluate_points(tt, TPolicy(**policy), TFleet(**kw), points, device="cpu")
    hold_rows(got, want)


def test_evaluate_points_refusals_match_jax(traces):
    jt, tt = traces
    for bad, match in (([{"bogus": 1.0}], "unsweepable"),
                       ([{"keepalive_s": math.nan}], "not finite"),
                       ([{"keepalive_s": 1e9}], "outside the declared bounds")):
        with pytest.raises(ValueError, match=match):
            J.evaluate_points(jt, JPolicy(kind=0), JFleet(), bad)
        with pytest.raises(ValueError, match=match):
            T.evaluate_points(tt, TPolicy(kind=0), TFleet(), bad, device="cpu")


def test_fleet_sweep_matches_jax(traces):
    jt, tt = traces
    grid = {"keepalive_s": [60.0, 600.0], "warm_frac": [0.0, 0.5], "max_nodes": [4.0, 16.0]}
    kw = dict(node_memory_mb=8192.0)
    want = j_sweep(jt, JPolicy(kind=0), JFleet(**kw), grid=grid, billing="aws_lambda")
    got = t_sweep(tt, TPolicy(kind=0), TFleet(**kw), grid=grid, billing="aws_lambda",
                  device="cpu")
    hold_rows(got, want)
    assert [{k: r[k] for k in grid} for r in got] == J.grid_points(grid)


def test_frontier_search_grid_matches_jax():
    js, ts = _spaces(SMALL)
    names = ["cold_tail", "fleet_cost_stress"]
    want = J.frontier_search(names, space=js, scale=0.1, coarse_frac=0.5)
    got = T.frontier_search(names, space=ts, scale=0.1, coarse_frac=0.5, device="cpu")
    hold_result(got, want)
    assert got.summary().keys() == want.summary().keys()
    assert got.summary()["robust_point_ids"] == want.summary()["robust_point_ids"]


def test_runner_frontier_and_spot_check_match_jax():
    """``scenarios.runner.frontier`` with one oracle spot-check a scenario
    (test_opt.py's spot-check case, at 0.1 x): the search, then each
    verdict, its gaps within 1e-4 and the demoted classes alike."""
    space = dict(policy={"keepalive_s": (60.0, 300.0)}, fleet={"warm_frac": (0.0,)})
    js, ts = _spaces(space)
    want, wchecks = j_frontier(["cold_tail"], space=js, coarse_frac=0.5, spot_check=1,
                               spec=JRunSpec(scale=0.1))
    got, gchecks = t_frontier(["cold_tail"], space=ts, coarse_frac=0.5, spot_check=1,
                              spec=TRunSpec(scale=0.1), device="cpu")
    hold_result(got, want)
    assert len(gchecks) == len(wchecks) > 0
    for g, w in zip(gchecks, wchecks):
        assert {k: g[k] for k in ("scenario", "point_id", "point", "scale", "pass", "demoted")} \
            == {k: w[k] for k in ("scenario", "point_id", "point", "scale", "pass", "demoted")}
        assert g["gaps"] == pytest.approx(w["gaps"], abs=1e-4)


def test_oracle_spot_check_with_demotion_matches_jax():
    """A spot-check on fleet_cost_stress (a fleet scenario: its check class
    carries the fleet knobs) at 0.1 x, seeded winner draws, two winners."""
    js, ts = _spaces(SMALL)
    want = J.frontier_search(["fleet_cost_stress"], space=js, scale=0.1, coarse_frac=0.5)
    got = T.frontier_search(["fleet_cost_stress"], space=ts, scale=0.1, coarse_frac=0.5,
                            device="cpu")
    wrec = J.oracle_spot_check(want, k=2, scale=0.1, rng=np.random.default_rng(0))
    grec = T.oracle_spot_check(got, k=2, scale=0.1, rng=np.random.default_rng(0),
                               device="cpu")
    assert [(r["point_id"], r["pass"], r["demoted"]) for r in grec] == \
        [(r["point_id"], r["pass"], r["demoted"]) for r in wrec]
    for g, w in zip(grec, wrec):
        assert g["gaps"] == pytest.approx(w["gaps"], abs=1e-4)
    hold_result(got, want)


@pytest.mark.parametrize("point", [{"keepalive_s": 300.0, "warm_frac": 0.5},
                                   {"target": 0.5, "cc": 2.0, "util_target": 0.6},
                                   {"spot_fraction": 0.6, "keepalive_s": 120.0}])
@pytest.mark.parametrize("name", ["cold_tail", "fleet_cost_stress", "spot_storm"])
def test_point_scenario_matches_jax(name, point):
    assert fields(T.point_scenario(t_scenario(name), point)) == \
        fields(J.point_scenario(j_scenario(name), point))


# ---------------------------------------------------------------------------
# the evo engine: the same candidates in the same order at a seed
# ---------------------------------------------------------------------------


def _analytic_eval(sc, pts, scale):
    """tests/test_evo.py's analytic evaluator (no simulator)."""
    rows = []
    for p in pts:
        ka = p.get("keepalive_s", 100.0)
        wf = p.get("warm_frac", 0.0)
        rows.append({"cost_per_million": 100.0 + 0.05 * ka + 400.0 * wf,
                     "slowdown_geomean_p99": 1.0 + 300.0 / (ka + 10.0) + 0.3 / (wf + 0.1),
                     "sims": len(pts), "scenario": sc.name, "scale": scale,
                     "stage_wall_s": 0.0})
    return rows


@pytest.mark.parametrize("seed,budget,forbidden", [
    (1, 30, ()), (5, 24, ()), (6, 24, ()),
    (0, 24, ({"keepalive_s": 60.0, "util_target": 0.6, "warm_frac": 0.0},))])
def test_evo_engine_on_an_analytic_evaluator_matches_jax(seed, budget, forbidden):
    kw = dict(scale=0.1, coarse_frac=1.0, budget=budget, seed=seed, refine=False,
              forbidden=forbidden)
    from repro.obs import RunTelemetry as JTel
    from repro_torch.obs import RunTelemetry as TTel
    jt, tt = JTel(), TTel()
    want = J.evo_search(["fleet_cost_stress"], evaluate=_analytic_eval, telemetry=jt, **kw)
    got = T.evo_search(["fleet_cost_stress"], evaluate=_analytic_eval, telemetry=tt, **kw)
    assert got.points == want.points
    assert got.robust_ids == want.robust_ids
    assert got.budget.ledger == want.budget.ledger
    strip = [{k: v for k, v in e.items() if k not in ("t", "wall_s")} for e in jt.events]
    assert [{k: v for k, v in e.items() if k not in ("t", "wall_s")} for e in tt.events] == strip


def test_evo_refusals_match_jax():
    with pytest.raises(ValueError, match="cannot seed"):
        J.evo_search(["fleet_cost_stress", "flash_crowd"], budget=3, refine=False,
                     evaluate=_analytic_eval)
    with pytest.raises(ValueError, match="cannot seed"):
        T.evo_search(["fleet_cost_stress", "flash_crowd"], budget=3, refine=False,
                     evaluate=_analytic_eval)
    with pytest.raises(ValueError, match="unknown search algo"):
        T.frontier_search(["fleet_cost_stress"], algo="annealing", device="cpu")


@pytest.mark.parametrize("seed", [0, 3])
def test_evo_search_on_the_simulator_matches_jax(seed):
    """Below ``grad_min_budget``: no gradient step, every candidate exactly
    JAX's (tests/test_torch_learned.py holds a run with the gradient
    endgame)."""
    kw = dict(scale=0.1, coarse_frac=1.0, algo="evo", budget=16, seed=seed)
    want = J.frontier_search(["fleet_cost_stress"], **kw)
    got = T.frontier_search(["fleet_cost_stress"], device="cpu", **kw)
    assert "grad" not in got.budget.by_stage()
    assert got.budget.summary() == want.budget.summary()
    hold_result(got, want)


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_no_device_means_cuda_or_raise(traces):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA error cannot be shown here")
    _, tt = traces
    ts = T.SearchSpace(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.frontier_search(["cold_tail"], space=ts, scale=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.frontier_search(["cold_tail"], space=ts, scale=0.1, algo="evo", budget=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_frontier(["cold_tail"], space=ts, spec=TRunSpec(scale=0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.evaluate_scenario("cold_tail", ts.points(), spec=TRunSpec(scale=0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sweep(tt, TPolicy(kind=0), TFleet(), grid={"keepalive_s": [60.0]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.evaluate_points(tt, TPolicy(kind=0), TFleet(), [{}], device="cuda")
    with pytest.raises(TypeError, match="RunSpec"):
        t_frontier(["cold_tail"], spec={"scale": 0.1}, device="cpu")


def test_more_than_one_device_is_not_ported():
    """RunSpec(devices=2) shards the batch's point axis over two shards (on
    the CPU here) and holds to the JAX package's rows under two forced host
    devices (torch_dist_common.py); a cells batch refuses devices as JAX's
    does."""
    pts = [{"keepalive_s": 60.0}, {"keepalive_s": 600.0}]
    spec2 = dict(scale=0.05, devices=2)
    want = jax_jobs([dict(kind="evaluate_scenario", name="cold_tail", points=pts,
                          spec=spec2)])[0]
    got = T.evaluate_scenario("cold_tail", pts, spec=TRunSpec(**spec2), device="cpu")
    hold_rows(got, want)
    assert got[0]["sims"] == want[0]["sims"] == 2
    with pytest.raises(ValueError, match="do not shard over devices"):
        T.evaluate_points(None, t_scenario("region_failover").policy.to_jax(), TFleet(), [{}],
                          cells=([], None), devices=1, device="cpu")


def test_one_point_alone_equals_its_batched_row(traces):
    """The port's own batching: a point run alone equals its row in a batch
    within 1e-6 (PERF.md's batched-to-alone hold), the premise of holding a
    seeded search's rankings to JAX's."""
    _, tt = traces
    pts = [{"keepalive_s": 60.0}, {"keepalive_s": 300.0}, {"keepalive_s": 1200.0}]
    batch = T.evaluate_points(tt, TPolicy(kind=0), TFleet(node_memory_mb=8192.0), pts,
                              device="cpu")
    for p, row in zip(pts, batch):
        alone = T.evaluate_points(tt, TPolicy(kind=0), TFleet(node_memory_mb=8192.0), [p],
                                  device="cpu")[0]
        hold_row(alone, row, rtol=1e-6, slowdown_rtol=1e-6)
