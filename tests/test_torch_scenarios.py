"""``repro_torch.scenarios`` against ``repro.scenarios``.

The registry field for field; every transform and ``cluster_functions`` bit
for bit on a seed; ``run_scenario`` at 0.1 x for all 11 scenarios (the
oracle rows exactly JAX's, the fluid rows at rtol 1e-4 with the slowdown at
1e-3, the meta fields equal); ``apply_tier``, ``billed_parity`` and the
clustered path held to JAX; and the runner's refusals.
"""

import dataclasses

import numpy as np
import pytest

import repro.scenarios as JS
from repro.core.runspec import RunSpec as JRunSpec
from repro.core.trace import TraceConfig as JConfig
from repro.core.trace import synthesize as j_synth
from repro.core.trace import synthesize_rates as j_synth_rates
from repro.fleet.spot import get_tier as j_tier
from repro.scenarios.runner import apply_tier as j_apply_tier
from repro.scenarios.runner import billed_parity as j_billed_parity

import repro_torch.scenarios as TS
from repro_torch.core.runspec import RunSpec as TRunSpec
from repro_torch.core.trace import TraceConfig as TConfig
from repro_torch.core.trace import synthesize as t_synth
from repro_torch.core.trace import synthesize_rates as t_synth_rates
from repro_torch.fleet.spot import get_tier as t_tier
from repro_torch.scenarios.runner import apply_tier as t_apply_tier
from repro_torch.scenarios.runner import billed_parity as t_billed_parity

from torch_dist_common import jax_jobs
from torch_fluid_common import _hold_row
from torch_scenario_common import same_value

NAMES = JS.list_scenarios()
META = ("scenario", "scale", "figure", "num_functions", "invocations", "engine")
TC_KW = dict(num_functions=50, duration_s=900, target_total_rps=8, seed=7)


def _plain(x):
    """A dataclass tree as (class name, fields) tuples, for comparing the two
    packages' objects field for field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.tolist())
    return x


def _trace_equal(got, want):
    np.testing.assert_array_equal(got.t, want.t)
    np.testing.assert_array_equal(got.fn, want.fn)
    np.testing.assert_array_equal(got.dur, want.dur)
    assert got.t.dtype == want.t.dtype and got.fn.dtype == want.fn.dtype
    assert got.duration_s == want.duration_s
    assert _plain(got.profile) == _plain(want.profile)


# ---------------------------------------------------------------------------
# the registry and the spec
# ---------------------------------------------------------------------------


def test_registry_holds_the_same_scenarios():
    assert TS.list_scenarios() == NAMES
    assert len(NAMES) == 11
    with pytest.raises(KeyError, match="unknown scenario"):
        TS.get_scenario("not_a_scenario")
    with pytest.raises(ValueError, match="duplicate"):
        TS.register(TS.get_scenario("diurnal"))


@pytest.mark.parametrize("name", NAMES)
def test_scenario_field_for_field(name):
    j, t = JS.get_scenario(name), TS.get_scenario(name)
    assert _plain(t) == _plain(j)
    for scale in (1.0, 0.25, 0.1):
        assert dataclasses.asdict(t.scaled_config(scale)) == \
            dataclasses.asdict(j.scaled_config(scale))


def test_policyspec_bridges_both_engines():
    for name in NAMES:
        j, t = JS.get_scenario(name).policy, TS.get_scenario(name).policy
        assert _plain(t.to_jax()) == _plain(j.to_jax())
        assert t.family().name == j.family().name
    sync = TS.PolicySpec(kind="sync", keepalive_s=42)
    asyn = TS.PolicySpec(kind="async", window_s=30, target=0.5)
    assert sync.to_jax().kind == 0 and sync.to_jax().keepalive_s == 42
    assert asyn.to_jax().kind == 1 and asyn.to_jax().target == 0.5
    assert sync.factory()(0).keepalive(0.0) == 42
    assert asyn.factory()(0).window_s == 30
    with pytest.raises(ValueError):
        TS.PolicySpec(kind="bogus").factory()


# ---------------------------------------------------------------------------
# transforms and clustering
# ---------------------------------------------------------------------------

TRANSFORMS = {
    "time_warp": lambda m: m.TimeWarp(period_frac=0.5, depth=0.8),
    "time_warp_phase": lambda m: m.TimeWarp(period_frac=1.0, depth=0.7, phase=2.1),
    "rate_scale_down": lambda m: m.RateScale(0.5),
    "rate_scale_up": lambda m: m.RateScale(2.3, jitter_s=0.5),
    "splice": lambda m: m.Splice(at_frac=0.4),
    "burst_inject": lambda m: m.BurstInject(at_frac=0.5, width_frac=0.1, factor=4.0,
                                            top_k=5),
    "tenant_merge": lambda m: m.TenantMerge(num_functions_frac=0.5, rps_frac=0.5),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_bit_for_bit(name):
    jtr, ttr = j_synth(JConfig(**TC_KW)), t_synth(TConfig(**TC_KW))
    _trace_equal(ttr, jtr)
    jtf, ttf = TRANSFORMS[name](JS), TRANSFORMS[name](TS)
    assert _plain(ttf) == _plain(jtf)
    want = jtf(jtr, JConfig(**TC_KW), np.random.default_rng(11))
    got = ttf(ttr, TConfig(**TC_KW), np.random.default_rng(11))
    _trace_equal(got, want)


def test_apply_transforms_stack_bit_for_bit():
    stack = [TRANSFORMS[n] for n in ("rate_scale_up", "burst_inject", "splice",
                                     "tenant_merge", "time_warp")]
    want = JS.apply_transforms(j_synth(JConfig(**TC_KW)), JConfig(**TC_KW),
                               tuple(f(JS) for f in stack), seed=5)
    got = TS.apply_transforms(t_synth(TConfig(**TC_KW)), TConfig(**TC_KW),
                              tuple(f(TS) for f in stack), seed=5)
    _trace_equal(got, want)


def _rate_trace_equal(got, want):
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.dtype == want.counts.dtype
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.tick_s == want.tick_s and got.duration_s == want.duration_s
    assert _plain(got.profile) == _plain(want.profile)


@pytest.mark.parametrize("below", [0.02, 0.1, 5.0])
def test_cluster_functions_bit_for_bit(below):
    kw = dict(num_functions=300, duration_s=600, target_total_rps=30, seed=4)
    want = JS.cluster_functions(j_synth(JConfig(**kw)), below, tick_s=2.0)
    got = TS.cluster_functions(t_synth(TConfig(**kw)), below, tick_s=2.0)
    _rate_trace_equal(got, want)
    jr = j_synth_rates(JConfig(**kw), tick_s=2.0)
    tr = t_synth_rates(TConfig(**kw), tick_s=2.0)
    _rate_trace_equal(TS.cluster_functions(tr, below, bins_per_octave=6),
                      JS.cluster_functions(jr, below, bins_per_octave=6))
    # a clustered trace clusters again (its weights carry over)
    _rate_trace_equal(TS.cluster_functions(got, below * 2),
                      JS.cluster_functions(want, below * 2))


@pytest.mark.parametrize("name", NAMES)
def test_build_trace_bit_for_bit(name):
    want = JS.get_scenario(name).build_trace(0.1)
    got = TS.get_scenario(name).build_trace(0.1)
    if hasattr(want, "counts"):
        _rate_trace_equal(got, want)
    else:
        _trace_equal(got, want)


# ---------------------------------------------------------------------------
# run_scenario against the JAX runner
# ---------------------------------------------------------------------------


def _hold_rows(got: list, want: list):
    assert [r["engine"] for r in got] == [r["engine"] for r in want]
    for g, w in zip(got, want):
        assert {k: g[k] for k in META} == {k: w[k] for k in META}
        if w["engine"] == "eventsim":
            assert g.keys() == w.keys()
            for k, v in w.items():
                if k != "wall_s":
                    assert same_value(g[k], v), (k, g[k], v)
        else:
            _hold_row({k: v for k, v in g.items() if k != "wall_s"},
                      {k: v for k, v in w.items() if k != "wall_s"})


@pytest.mark.parametrize("name", NAMES)
def test_run_scenario_matches_jax_at_a_tenth(name):
    jd, td = {}, {}
    want = JS.run_scenario(name, detail=jd, spec=JRunSpec(scale=0.1))
    got = TS.run_scenario(name, detail=td, spec=TRunSpec(scale=0.1), device="cpu")
    assert want and len(got) == len(want)
    _hold_rows(got, want)
    assert ("oracle_result" in td) == ("oracle_result" in jd)
    assert ("fluid_summary" in td) == ("fluid_summary" in jd)
    assert list(td["wall_parts_s"]) == ["trace", *(r["engine"] for r in got)]
    assert TS.parity_report(got).keys() == JS.parity_report(want).keys()
    for k, v in JS.parity_report(want).items():
        assert TS.parity_report(got)[k] == pytest.approx(v, abs=1e-4), k


def test_clustered_paths_match_jax():
    for name, scale in (("fig9_planet", 0.02), ("diurnal", 0.1)):
        detail = {}
        want = JS.run_scenario(name, spec=JRunSpec(scale=scale, cluster=0.05))
        got = TS.run_scenario(name, spec=TRunSpec(scale=scale, cluster=0.05),
                              device="cpu", detail=detail)
        assert [r["engine"] for r in got] == ["simjax"]   # rate-based: no oracle leg
        assert list(detail["wall_parts_s"]) == ["trace", "cluster", "simjax"]
        _hold_rows(got, want)


def test_apply_tier_equals_jax():
    for tier in ("spot", "on_demand"):
        for name in NAMES:
            j = j_apply_tier(JS.get_scenario(name), j_tier(tier))
            t = t_apply_tier(TS.get_scenario(name), t_tier(tier))
            assert (t is None) == (j is None), name
            if t is not None:
                assert _plain(t) == _plain(j), (name, tier)
    want = JS.run_scenario("spot_storm", spec=JRunSpec(scale=0.1, tier="spot"))
    got = TS.run_scenario("spot_storm", spec=TRunSpec(scale=0.1, tier="spot"),
                          device="cpu")
    _hold_rows(got, want)
    with pytest.raises(ValueError, match="cannot express capacity tier"):
        TS.run_scenario("diurnal", spec=TRunSpec(scale=0.1, tier="spot"), device="cpu")


def test_billed_parity_matches_jax():
    want = j_billed_parity("cold_tail", "aws_lambda", scale=0.1)
    got = t_billed_parity("cold_tail", "aws_lambda", scale=0.1, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-5), k
    rows_j = JS.run_scenario("cold_tail", spec=JRunSpec(scale=0.1, billing="gcr"))
    rows_t = TS.run_scenario("cold_tail", spec=TRunSpec(scale=0.1, billing="gcr"),
                             device="cpu")
    assert [r["billing"] for r in rows_t] == [r["billing"] for r in rows_j] == ["gcr"] * 2
    _hold_rows(rows_t, rows_j)


def test_runner_refusals():
    spec = TRunSpec(scale=0.1, engines=("simjax",), devices=1)
    with pytest.raises(ValueError, match="do not shard over devices"):
        TS.run_scenario("region_failover", spec=spec, device="cpu")
    with pytest.raises(TypeError, match="RunSpec"):
        TS.frontier(["diurnal"], spec={"scale": 0.1}, device="cpu")
    # two shards of the fluid leg (on the CPU here) hold to the JAX
    # package's rows under two forced host devices (torch_dist_common.py)
    spec2 = dict(scale=0.1, engines=["simjax"], devices=2)
    want = jax_jobs([dict(kind="scenario", name="diurnal", spec=spec2)])[0]
    _hold_rows(TS.run_scenario("diurnal", spec=TRunSpec(**spec2), device="cpu"), want)
    with pytest.raises(ValueError, match="unknown engine"):
        TS.run_scenario("diurnal", spec=TRunSpec(scale=0.1, engines=("bogus",)), device="cpu")
    with pytest.raises(TypeError, match="RunSpec"):
        TS.run_scenario("diurnal", spec={"scale": 0.1}, device="cpu")
    with pytest.raises(ValueError, match="rate_trace"):
        TS.run_scenario("region_failover", spec=TRunSpec(scale=0.1, cluster=0.05),
                        device="cpu")
    # the oracle leg only: nothing for the device to do
    assert TS.run_scenario("fig9_production",
                           spec=TRunSpec(engines=("eventsim",), scale=1.0)) == []
