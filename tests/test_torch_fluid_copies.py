"""The port's numpy copies of the simulator's modules against the JAX package.

``repro_torch.core.{trace,cluster,eventsim,metrics,runspec}``,
``repro_torch.fleet.*`` and ``repro_torch.obs.{telemetry,ledger}`` are
copies of ``repro``'s numpy modules (the port imports nothing of ``repro``);
on the same seeds they give the same outputs, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.cluster as jcluster
import repro.core.eventsim as jeventsim
import repro.core.metrics as jmetrics
import repro.core.trace as jtrace
import repro.fleet as jfleet
import repro.obs as jobs
from repro.core import simjax
from repro.core.policies import SyncKeepalivePolicy as JSync
from repro.core.runspec import RunSpec as JRunSpec

import repro_torch.core.cluster as tcluster
import repro_torch.core.eventsim as teventsim
import repro_torch.core.metrics as tmetrics
import repro_torch.core.trace as ttrace
import repro_torch.fleet as tfleet
import repro_torch.obs as tobs
from repro_torch.core.policies import SyncKeepalivePolicy as TSync
from repro_torch.core.runspec import RunSpec as TRunSpec

CFG = dict(num_functions=40, duration_s=900.0, target_total_rps=6.0, seed=5)


def _equal(a, b):
    """Recursive bit-for-bit equality of numpy / dataclass / dict trees."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b)
    else:
        assert a == b


def test_synthesize_is_bit_for_bit():
    _equal(jtrace.synthesize(jtrace.TraceConfig(**CFG)),
           ttrace.synthesize(ttrace.TraceConfig(**CFG)))
    np.testing.assert_array_equal(jtrace.KA_GRID, ttrace.KA_GRID)


@pytest.mark.parametrize("tick_s", [1.0, 2.0])
def test_synthesize_rates_and_rate_matrix_are_bit_for_bit(tick_s):
    a = jtrace.synthesize_rates(jtrace.TraceConfig(**CFG), tick_s=tick_s)
    b = ttrace.synthesize_rates(ttrace.TraceConfig(**CFG), tick_s=tick_s)
    _equal(a, b)
    assert len(a) == len(b)
    for tick in (tick_s, 2 * tick_s):
        _equal(jtrace.rate_matrix(a, tick), ttrace.rate_matrix(b, tick))
    ev_a = jtrace.synthesize(jtrace.TraceConfig(**CFG))
    ev_b = ttrace.synthesize(ttrace.TraceConfig(**CFG))
    _equal(jtrace.rate_matrix(ev_a, tick_s), ttrace.rate_matrix(ev_b, tick_s))
    with pytest.raises(ValueError, match="cannot be re-binned"):
        ttrace.rate_matrix(b, 1.5 * tick_s)


# the second: 28 of 50 functions with more than 256 gaps, strides below 16
@pytest.mark.parametrize("cfg", [CFG, dict(num_functions=50, duration_s=3000.0,
                                           target_total_rps=40.0, seed=1)])
def test_gap_statistics_are_bit_for_bit(cfg):
    """The port's gap_quantile takes every window's quantile of a function in
    one call, the JAX package's one call a window: the same values."""
    ev_a = jtrace.synthesize(jtrace.TraceConfig(**cfg))
    ev_b = ttrace.synthesize(ttrace.TraceConfig(**cfg))
    _equal(jtrace.gap_statistics(ev_a), ttrace.gap_statistics(ev_b))
    _equal(jtrace.gap_quantile(ev_a, 0.9), ttrace.gap_quantile(ev_b, 0.9))
    rates_a = jtrace.synthesize_rates(jtrace.TraceConfig(**cfg), tick_s=2.0)
    rates_b = ttrace.synthesize_rates(ttrace.TraceConfig(**cfg), tick_s=2.0)
    _equal(jtrace.gap_statistics(rates_a), ttrace.gap_statistics(rates_b))


def _oracle(tr, cluster, eventsim, sync, fleet_mod=None):
    trace = tr.synthesize(tr.TraceConfig(num_functions=20, duration_s=300,
                                         target_total_rps=4))
    fleet = None
    if fleet_mod is not None:
        fleet = fleet_mod.NodeFleet(fleet_mod.UtilizationFleetPolicy(
            min_nodes=1, max_nodes=16), node_type=fleet_mod.NodeType(memory_mb=8192.0))
    res = eventsim.EventSim(trace, cluster.Cluster(1 if fleet else 8, node_memory_mb=8192.0),
                            lambda f: sync(keepalive_s=120), eventsim.SimConfig(),
                            fleet=fleet).run()
    return res


@pytest.mark.parametrize("with_fleet", [False, True])
def test_eventsim_and_metrics_match(with_fleet):
    a = _oracle(jtrace, jcluster, jeventsim, JSync, jfleet if with_fleet else None)
    b = _oracle(ttrace, tcluster, teventsim, TSync, tfleet if with_fleet else None)
    _equal(jmetrics.compute(a).row(), tmetrics.compute(b).row())
    _equal(jmetrics.per_function_p99_slowdown(a), tmetrics.per_function_p99_slowdown(b))
    _equal(jmetrics.queueing_cdf(a), tmetrics.queueing_cdf(b))
    _equal(jobs.ledger_from_eventsim(a).__dict__, tobs.ledger_from_eventsim(b).__dict__)


def test_billing_weights_of_every_profile():
    prof = jtrace.make_profile(jtrace.TraceConfig(**CFG))
    assert jfleet.list_profiles() == tfleet.list_profiles()
    for name in jfleet.list_profiles():
        a, b = jfleet.get_profile(name), tfleet.get_profile(name)
        _equal(dataclasses.asdict(a), dataclasses.asdict(b))
        _equal(a.billed_weights(prof), b.billed_weights(prof))
        _equal(simjax._billed_weights(jtrace.synthesize(jtrace.TraceConfig(**CFG)), name)
               .__array__(), np.asarray(b.billed_weights(prof), np.float32))


def test_assemble_telemetry_and_the_ledger():
    rng = np.random.default_rng(0)
    s = 5
    series = rng.uniform(0, 10, (s, len(jobs.TELEM_SERIES)))
    ticks = rng.integers(1, 9, s).astype(np.float64)
    attr = rng.uniform(0, 3, len(jobs.TELEM_ATTR))
    assert jobs.TELEM_SERIES == tobs.TELEM_SERIES and jobs.TELEM_ATTR == tobs.TELEM_ATTR
    ta = jobs.assemble_telemetry(series, ticks, attr, 40, 2.0)
    tb = tobs.assemble_telemetry(series, ticks, attr, 40, 2.0)
    _equal(ta, tb)
    # a real chunked row with telemetry through both ledgers
    trace = jtrace.synthesize(jtrace.TraceConfig(num_functions=20, duration_s=300,
                                                 target_total_rps=4))
    row = simjax.simulate_chunked(trace, simjax.JaxPolicy(kind=0, keepalive_s=120),
                                  spec=JRunSpec(telemetry=8))
    la, lb = jobs.ledger_from_chunked(row), tobs.ledger_from_chunked(row)
    _equal(la.__dict__, lb.__dict__)
    assert jobs.check_ledger(la) == tobs.check_ledger(lb) == []
    _equal(jobs.ledger_parity(la, la), tobs.ledger_parity(lb, lb))
    assert jobs.attribution_table([la]) == tobs.attribution_table([lb])
    assert jobs.CPU_COMPONENTS == tobs.CPU_COMPONENTS
    assert jobs.MEM_COMPONENTS == tobs.MEM_COMPONENTS


def test_runspec_copy_validates_as_the_jax_one():
    assert dataclasses.asdict(JRunSpec()) == dataclasses.asdict(TRunSpec())
    for bad in (dict(scale=0.0), dict(telemetry=-1), dict(devices=-2), dict(cluster=-1.0)):
        with pytest.raises(ValueError):
            JRunSpec(**bad)
        with pytest.raises(ValueError):
            TRunSpec(**bad)
    assert TRunSpec(engines="simjax").engines == JRunSpec(engines="simjax").engines
