"""``repro_torch.cells`` against ``repro.cells``.

The router's torch functions against the JAX ones on a grid (rtol 1e-6);
the copied plain-data layer (topology, triggers, the per-cell traces, the
convergence policy) equal to JAX's; the fluid leg at one healthy cell bit
for bit the plain engine; the three cells scenarios at 0.25 x: the oracle
rows exactly JAX's, the fluid rows and ``cell_rows`` at rtol 1e-4 (slowdown
1e-3), and the oracle-vs-fluid parity bands of ``tests/test_cells.py``;
variants no registered scenario reaches (spill, a reactive trigger, no
fleet, a batch of points) held to JAX the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.cells as JC
import repro.cells.traffic as JT
from repro.cells.fluid import cells_chunked_summaries as j_cells_summaries
from repro.core.eventsim import SimConfig as JSim
from repro.core.runspec import RunSpec as JRunSpec
from repro.core.simjax import stack_params as j_stack
from repro.scenarios import get_scenario as j_get
from repro.scenarios import run_scenario as j_run

import repro_torch.cells as TC
import repro_torch.cells.traffic as TT
from repro_torch.cells.fluid import cells_chunked_summaries as t_cells_summaries
from repro_torch.cells.fluid import run_cells_fluid
from repro_torch.core.eventsim import SimConfig as TSim
from repro_torch.core.runspec import RunSpec as TRunSpec
from repro_torch.core.simtorch import simulate_chunked
from repro_torch.core.simtorch import stack_params as t_stack
from repro_torch.scenarios import get_scenario as t_get
from repro_torch.scenarios import parity_report
from repro_torch.scenarios import run_scenario as t_run

from torch_fluid_common import _hold_row
from torch_scenario_common import same_value

CELLS_SCENARIOS = ["region_failover", "follow_the_sun", "cell_hazard_corr"]
RTOL = 1e-6
CELL_ROW_RTOL = 1e-4


def _row_exact(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k != "wall_s":
            assert same_value(got[k], v), (k, got[k], v)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alive,spill,free", [
    ([1, 1, 1], [0.0, 0.0, 0.0], [4.0, 2.0, 1.0]),     # no spill
    ([1, 1, 1], [0.5, 1.0, 0.2], [4.0, 2.0, 1.0]),     # heavy spill
    ([1, 1, 1], [0.7, 0.7, 0.7], [0.0, 0.0, 0.0]),     # no free slots: home
    ([0, 1, 1], [0.0, 0.3, 0.0], [0.0, 3.0, 1.0]),     # one cell dead
    ([0, 0, 1], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]),     # only one survivor
])
def test_flux_matrix_rows_sum_to_one_and_match_jax(alive, spill, free):
    a = torch.tensor(alive, dtype=torch.float32)
    fd = TT.failover_dist(a, 0.5)
    m = TT.flux_matrix(a, torch.tensor(spill), torch.tensor(free), fd).numpy()
    np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-6)
    for c, al in enumerate(alive):
        if not al:
            np.testing.assert_allclose(m[c], fd.numpy(), atol=1e-6)
    arr = np.arange(1.0, 13.0, dtype=np.float32).reshape(3, 4)
    assert np.einsum("cd,cf->df", m, arr).sum() == pytest.approx(arr.sum(), rel=1e-6)
    a_np = np.asarray(alive, np.float32)
    jfd = JT.failover_dist(a_np, 0.5)
    want = np.asarray(JT.flux_matrix(a_np, np.asarray(spill, np.float32),
                                     np.asarray(free, np.float32), jfd))
    np.testing.assert_allclose(m, want, rtol=RTOL, atol=1e-7)


def test_failover_dist_torch_matches_numpy_and_jax():
    for alive in ([1, 1, 1, 1], [0, 1, 0, 1], [0, 0, 0, 0], [1, 0, 0, 0]):
        for skew in (0.0, 0.5, 2.0, 60.0):
            a = np.asarray(alive, np.float64)
            got = TT.failover_dist(torch.tensor(a, dtype=torch.float32), skew).numpy()
            np.testing.assert_allclose(got, TT.failover_dist_np(a, skew), atol=1e-6)
            np.testing.assert_array_equal(TT.failover_dist_np(a, skew),
                                          JT.failover_dist_np(a, skew))
            np.testing.assert_allclose(
                got, np.asarray(JT.failover_dist(a.astype(np.float32), skew)),
                rtol=RTOL, atol=1e-7)


def test_spill_fraction_gating():
    q = torch.tensor([0.0, 50.0])
    arr = torch.tensor([10.0, 10.0])
    slots = torch.tensor([20.0, 20.0])
    # threshold 0 disables spill exactly, even with a huge backlog
    assert TT.spill_fraction(q, arr, slots, 0.0).max().item() == 0.0
    s = TT.spill_fraction(q, arr, slots, 1.0)
    assert s[0].item() == 0.0                 # under threshold: nothing spills
    assert 0.0 < s[1].item() <= 1.0           # overflow spills, clipped


def test_router_matches_jax_on_a_grid_with_a_point_axis():
    """spill_fraction, failover_dist and flux_matrix over P = 4 points of
    (route_skew, threshold) and random per-cell states, each point against
    its own JAX call."""
    rng = np.random.default_rng(5)
    c, points = 4, 4
    skew = np.asarray([0.0, 0.3, 1.5, 4.0], np.float32)
    thr = np.asarray([0.0, 0.5, 2.0, 8.0], np.float32)
    for alive in ([1, 1, 1, 1], [1, 0, 1, 1], [0, 0, 1, 0]):
        a = np.asarray(alive, np.float32)
        q = rng.uniform(0, 40, (points, c)).astype(np.float32)
        ar = rng.uniform(0, 20, (points, c)).astype(np.float32)
        slots = rng.uniform(0, 30, (points, c)).astype(np.float32)
        free = rng.uniform(-2, 10, (points, c)).astype(np.float32)
        s = TT.spill_fraction(torch.tensor(q), torch.tensor(ar), torch.tensor(slots),
                              torch.tensor(thr)[:, None]) * torch.tensor(a)
        fd = TT.failover_dist(torch.tensor(a), torch.tensor(skew)[:, None])
        m = TT.flux_matrix(torch.tensor(a), s, torch.tensor(free), fd)
        assert m.shape == (points, c, c)
        for p in range(points):
            js = np.asarray(JT.spill_fraction(q[p], ar[p], slots[p], thr[p])) * a
            jfd = np.asarray(JT.failover_dist(a, skew[p]))
            jm = np.asarray(JT.flux_matrix(a, js, free[p], jfd))
            np.testing.assert_allclose(s[p].numpy(), js, rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(fd[p].numpy(), jfd, rtol=RTOL, atol=1e-7)
            np.testing.assert_allclose(m[p].numpy(), jm, rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# the plain-data layer
# ---------------------------------------------------------------------------

_BAD_TOPOLOGIES = [
    dict(cell_count=0), dict(cell_count=2, fail_cell=2),
    dict(cell_count=2, fail_cell=0, fail_frac=1.5), dict(cell_count=2, hazard_corr=1.2),
    dict(cell_count=2, route_skew=-1.0),
]


@pytest.mark.parametrize("kw", _BAD_TOPOLOGIES, ids=str)
def test_topology_raises_where_jax_raises(kw):
    with pytest.raises(ValueError) as je:
        JC.CellTopology(**kw)
    with pytest.raises(ValueError) as te:
        TC.CellTopology(**kw)
    assert str(te.value) == str(je.value)


def test_trigger_validation_equals_jax():
    for mod in (JC, TC):
        with pytest.raises(ValueError):
            mod.CellTopology(cell_count=2, scheduled=(mod.ScheduledTrigger(3, 0.1, 0.2, 4),))
        with pytest.raises(ValueError):
            mod.ScheduledTrigger(0, 0.5, 0.4, 2)
        with pytest.raises(ValueError):
            mod.ReactiveTrigger("t", util_high=0.0, change=2)


def _topologies(mod):
    return [mod.CellTopology(cell_count=4, route_skew=0.5),
            mod.CellTopology(cell_count=3, route_skew=1.25, fail_cell=1, fail_frac=0.4),
            mod.CellTopology(cell_count=1, hazard_corr=0.5),
            mod.CellTopology(cell_count=3, scheduled=(mod.ScheduledTrigger(1, 0.25, 0.5, 6),
                                                      mod.ScheduledTrigger(1, 0.40, 0.6, 9),
                                                      mod.ScheduledTrigger(2, 0.00, 0.1, 3))),
            mod.CellTopology(cell_count=1)]


def test_topology_derived_data_equals_jax():
    for j, t in zip(_topologies(JC), _topologies(TC)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        np.testing.assert_array_equal(t.weights(), j.weights())
        assert t.is_trivial == j.is_trivial
        assert t.fail_time(3600.0) == j.fail_time(3600.0)
        for nodes in (1, 8, 50):
            np.testing.assert_array_equal(t.cell_nodes(nodes), j.cell_nodes(nodes))
        for cell in range(t.cell_count):
            assert t.schedule_entries(cell, 1000.0) == j.schedule_entries(cell, 1000.0)
        np.testing.assert_array_equal(t.floor_schedule(1000, 1.0, 1000.0),
                                      j.floor_schedule(1000, 1.0, 1000.0))
        np.testing.assert_array_equal(t.floor_schedule(600, 2.0, 1200.0),
                                      j.floor_schedule(600, 2.0, 1200.0))


@pytest.mark.parametrize("name", CELLS_SCENARIOS)
def test_build_cell_traces_equal_jax(name):
    jt = JC.build_cell_traces(j_get(name), scale=0.25)
    tt = TC.build_cell_traces(t_get(name), scale=0.25)
    assert len(tt) == len(jt) == t_get(name).cells.cell_count
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.t, a.t)
        np.testing.assert_array_equal(b.fn, a.fn)
        np.testing.assert_array_equal(b.dur, a.dur)
        assert b.duration_s == a.duration_s
        assert b.num_functions == a.num_functions
    assert all(t.profile is tt[0].profile for t in tt)


def test_convergence_policy_equals_jax_on_a_grid():
    """One call sequence through both policies: schedule windows, two
    reactive triggers with their holds and cooldowns, rising and falling
    utilization; every desired count and binding source equal."""
    def make(mod):
        trig = (mod.ReactiveTrigger("burst", util_high=0.8, change=4, hold_s=50.0,
                                    cooldown_s=200.0),
                mod.ReactiveTrigger("slow", util_high=0.6, change=1, hold_s=300.0,
                                    cooldown_s=30.0))
        return mod.ConvergenceFleetPolicy(min_nodes=1, max_nodes=40, util_target=0.7,
                                          warm_frac=0.25,
                                          schedule=((100.0, 200.0, 8), (150.0, 400.0, 12)),
                                          reactive=trig)
    jp, tp = make(JC), make(TC)
    rng = np.random.default_rng(3)
    node_mb = 10_000.0
    nodes = 4
    for t in np.arange(0.0, 800.0, 7.0):
        used = float(rng.uniform(0.0, 1.1) * nodes * node_mb)
        want = jp.desired(float(t), used, node_mb, nodes)
        got = tp.desired(float(t), used, node_mb, nodes)
        assert got == want, t
        assert (tp.last_source, tp.last_cooldown_s) == (jp.last_source, jp.last_cooldown_s)
        nodes = max(1, want)


# ---------------------------------------------------------------------------
# the fluid leg
# ---------------------------------------------------------------------------


def test_cells_fluid_c1_is_bitwise_plain_engine():
    """The whole cells machinery (the cell rows, the router, the per-cell
    accumulators) collapses exactly to the plain chunked run at one healthy
    cell: every metric bit for bit."""
    sc = dataclasses.replace(t_get("region_failover"), cells=TC.CellTopology(cell_count=1))
    traces = TC.build_cell_traces(sc, scale=0.25)
    sim = TSim(tick_s=sc.policy.tick_s)
    cells_row = run_cells_fluid(sc, traces, sim, device="cpu")
    plain_row = simulate_chunked(traces[0], sc.policy.to_jax(), sim=sim, dt=sim.tick_s,
                                 num_nodes=sc.num_nodes, fleet=sc.fleet,
                                 chunk_ticks=sc.chunk_ticks, spec=TRunSpec(), device="cpu")
    assert cells_row == plain_row


def test_trivial_topology_runs_plain_path():
    sc = t_get("diurnal")
    trivial = dataclasses.replace(sc, cells=TC.CellTopology(cell_count=1))
    spec = TRunSpec(scale=0.1, engines=("simjax",))
    rows = t_run(trivial, spec=spec, device="cpu")
    plain = t_run(sc, spec=spec, device="cpu")
    assert rows[0]["slowdown_geomean_p99"] == plain[0]["slowdown_geomean_p99"]


@pytest.fixture(scope="module")
def quarter_runs():
    """Each cells scenario at 0.25 x through both engines of both packages."""
    out = {}
    for name in CELLS_SCENARIOS:
        jd, td = {}, {}
        j = j_run(name, detail=jd, spec=JRunSpec(scale=0.25))
        t = t_run(name, detail=td, spec=TRunSpec(scale=0.25), device="cpu")
        out[name] = (j, jd, t, td)
    return out


@pytest.mark.parametrize("name", CELLS_SCENARIOS)
def test_cells_scenario_rows_match_jax(quarter_runs, name):
    j, jd, t, td = quarter_runs[name]
    assert [r["engine"] for r in t] == [r["engine"] for r in j] == ["eventsim", "simjax"]
    _row_exact(t[0], j[0])
    meta = ("scenario", "scale", "figure", "num_functions", "invocations", "engine")
    assert {k: t[1][k] for k in meta} == {k: j[1][k] for k in meta}
    _hold_row({k: v for k, v in t[1].items() if k != "wall_s"},
              {k: v for k, v in j[1].items() if k != "wall_s"})
    assert len(td["cell_rows"]) == len(jd["cell_rows"]) == t_get(name).cells.cell_count
    for got, want in zip(td["cell_rows"], jd["cell_rows"]):
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k] == pytest.approx(v, rel=CELL_ROW_RTOL, abs=1e-9), (got["cell"], k)
    # the oracle's per-cell results, record for record
    for a, b in zip(jd["cell_results"], td["cell_results"]):
        assert [(r.fn, r.arrival, r.start, r.end) for r in b.records] == \
            [(r.fn, r.arrival, r.start, r.end) for r in a.records]


@pytest.mark.parametrize("name", ["follow_the_sun", "cell_hazard_corr"])
def test_cells_scenario_parity(quarter_runs, name):
    gaps = parity_report(quarter_runs[name][2])
    assert gaps["slowdown_geomean_p99"] <= 0.15, gaps
    assert gaps["normalized_memory"] <= 0.15, gaps


def test_region_failover_parity_smoke(quarter_runs):
    gaps = parity_report(quarter_runs["region_failover"][2])
    assert gaps["slowdown_geomean_p99"] <= 0.30, gaps
    assert gaps["normalized_memory"] <= 0.30, gaps


def _variant_args(mod, get, fleet: bool, family: str, extra: dict, reactive: bool):
    sc = get("region_failover")
    topo = dataclasses.replace(sc.cells, reactive=(
        mod.ReactiveTrigger("burst", util_high=0.05, change=2, hold_s=30.0,
                            cooldown_s=60.0),) if reactive else ())
    pol = dataclasses.replace(sc.policy, kind=family,
                              extra=None if family != "cells" else {**sc.policy.extra, **extra})
    return dataclasses.replace(sc, cells=topo, policy=pol,
                               fleet=sc.fleet if fleet else None, num_nodes=8)


VARIANTS = {
    # the router's spill path and a reactive trigger: no registered scenario
    # runs either
    "spill_reactive": dict(fleet=True, family="cells",
                           extra={"spill_threshold": 0.5, "route_skew": 1.0}, reactive=True),
    # static cell nodes, and a family without the router axes (the topology's
    # statics route)
    "no_fleet_sync": dict(fleet=False, family="sync", extra={}, reactive=False),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cells_fluid_variants_match_jax(variant):
    from repro.cells.fluid import run_cells_fluid as j_run_cells
    kw = VARIANTS[variant]
    jsc = _variant_args(JC, j_get, **kw)
    tsc = _variant_args(TC, t_get, **kw)
    jtr = JC.build_cell_traces(jsc, scale=0.15)
    ttr = TC.build_cell_traces(tsc, scale=0.15)
    jd, td = {}, {}
    want = j_run_cells(jsc, jtr, JSim(tick_s=1.0), detail=jd)
    got = run_cells_fluid(tsc, ttr, TSim(tick_s=1.0), detail=td, device="cpu")
    _hold_row(got, want)
    for a, b in zip(td["cell_rows"], jd["cell_rows"]):
        for k, v in b.items():
            assert a[k] == pytest.approx(v, rel=CELL_ROW_RTOL, abs=1e-9), (a["cell"], k)


def test_one_cell_that_fails_matches_jax():
    """A one-cell topology whose only cell fails is not trivial, so the runner
    sends it to the cells leg: after the failure no cell is alive and every
    sum adds nothing, as JAX's alive-masked sums do."""
    def scenario(mod, get):
        return dataclasses.replace(get("region_failover"),
                                   cells=mod.CellTopology(cell_count=1, fail_cell=0))
    jd, td = {}, {}
    want = j_run(scenario(JC, j_get), detail=jd,
                 spec=JRunSpec(scale=0.1, engines=("simjax",)))[0]
    got = t_run(scenario(TC, t_get), detail=td, device="cpu",
                spec=TRunSpec(scale=0.1, engines=("simjax",)))[0]
    assert got["ticks_measured"] == want["ticks_measured"]
    _hold_row({k: v for k, v in got.items() if k != "wall_s"},
              {k: v for k, v in want.items() if k != "wall_s"})
    assert td["cell_rows"][0]["ticks_alive"] == jd["cell_rows"][0]["ticks_alive"] \
        < want["ticks_measured"]
    for k, v in jd["cell_rows"][0].items():
        assert td["cell_rows"][0][k] == pytest.approx(v, rel=CELL_ROW_RTOL, abs=1e-9), k


def test_cells_batch_of_points_matches_jax():
    """Three (keepalive, route_skew, spill_threshold) points in one call
    against JAX's batched call: the (point, cell) row layout."""
    from repro.core.simjax import _PFLEET
    jsc, tsc = j_get("region_failover"), t_get("region_failover")
    knobs = [(300.0, 0.0, 0.0), (600.0, 1.5, 0.0), (120.0, 0.5, 1.0)]

    def points(sc):
        pols = [dataclasses.replace(sc.policy, keepalive_s=ka,
                                    extra={**sc.policy.extra, "route_skew": rs,
                                           "spill_threshold": th}).to_jax()
                for ka, rs, th in knobs]
        return pols[0], [p.params() for p in pols]
    jpol, jparams = points(jsc)
    tpol, tparams = points(tsc)
    fleets = np.asarray([jsc.fleet.params()] * len(knobs), np.float32)
    assert len(_PFLEET) == fleets.shape[1]
    kw = dict(dt=1.0, num_nodes=jsc.num_nodes, provision_s=jsc.fleet.provision_s,
              has_fleet=True, chunk_ticks=jsc.chunk_ticks)
    want = j_cells_summaries(JC.build_cell_traces(jsc, 0.15), jsc.cells, jpol,
                             j_stack(jparams), fleets, sim=JSim(), **kw)
    got = t_cells_summaries(TC.build_cell_traces(tsc, 0.15), tsc.cells, tpol,
                            t_stack(tparams), fleets, sim=TSim(), device="cpu", **kw)
    assert len(got) == len(want) == len(knobs)
    for g, w in zip(got, want):
        _hold_row(g, w)


def test_cells_need_a_fleet_for_triggers_and_matching_traces():
    sc = t_get("follow_the_sun")
    traces = TC.build_cell_traces(sc, scale=0.1)
    with pytest.raises(ValueError, match="needs a fleet"):
        run_cells_fluid(dataclasses.replace(sc, fleet=None), traces, TSim(), device="cpu")
    with pytest.raises(ValueError, match="cell traces"):
        run_cells_fluid(sc, traces[:2], TSim(), device="cpu")


def test_region_failover_carries_a_subnormal_through_the_failover():
    """At 0.1 x region_failover's dead cell reaches its failure tick (216)
    holding subnormal in-flight masses: XLA flushes every subnormal float32
    result to zero, the port only the quantities where that changes the
    dynamics (``simtorch._ftz``; the first such mass from tick 49).  The
    failover re-injects the dead cell's mass on the survivors, each
    survivor's share flushed as XLA flushes it (``cells.fluid``).  Unflushed,
    the share tipped one ceil in cell 1 (one idle instance fewer at ticks 216
    and 217: cpu_worker_s two ticks of ``cpu_idle_per_s`` under JAX's) and,
    at 1.0 x with a keepalive of 1200 s, left a ghost in-flight mass that
    held an idle instance busy for the 1440 ticks after the failure (1.2-1.5e-4
    of cpu_worker_s over JAX's).  Flushed, the row and every cell's row hold
    within 1e-6 of JAX's (ROADMAP Queue 3)."""
    jd, td = {}, {}
    want = j_run("region_failover", detail=jd,
                 spec=JRunSpec(scale=0.1, engines=("simjax",)))[0]
    got = t_run("region_failover", detail=td, device="cpu",
                spec=TRunSpec(scale=0.1, engines=("simjax",)))[0]
    assert got["cpu_worker_s"] == pytest.approx(want["cpu_worker_s"], rel=1e-6)
    for c, (a, b) in enumerate(zip(td["cell_rows"], jd["cell_rows"])):
        assert a == pytest.approx(b, rel=1e-6, abs=1e-9), c
    for k, v in want.items():
        if isinstance(v, float) and k != "wall_s":
            assert got[k] == pytest.approx(v, rel=1e-6), k
