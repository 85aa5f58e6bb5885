"""``repro_torch.core.simtorch`` (the fluid engine) against ``repro.core.simjax``.

On the CPU, on the same traces: ``simulate``'s 14 series at rtol 1e-5 for
every policy family, without a fleet, with ``JaxFleet`` and with spot under
a fleet; a capacity-bound fleet's rows; a 2000-function trace; the port's
own full-history/chunked agreement; one chunk's gradient against
``jax.jacrev``; the one ceil where the two engines' division orders part
(ROADMAP Queue 3).  ``tests/test_torch_simtorch_chunked.py`` holds the chunked
engine's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.simjax as J
import repro.core.trace as JT
from repro.core.trace import TraceConfig, gap_statistics, rate_matrix, synthesize

import repro_torch.core.simtorch as T
import repro_torch.core.trace as TT
from repro_torch.core.eventsim import SimConfig as TSim
from repro_torch.core.runspec import RunSpec as TRunSpec
from torch_fluid_common import FLEETS, POLICIES, SERIES_RTOL, _fleets, _hold_row


@pytest.fixture(scope="module")
def trace():
    return synthesize(TraceConfig(num_functions=20, duration_s=300, target_total_rps=4))


@pytest.mark.parametrize("fleet", [None, "fleet"])
@pytest.mark.parametrize("family", list(POLICIES))
def test_simulate_series_match_jax(trace, family, fleet):
    jf, tf = _fleets(fleet)
    a = J.simulate(trace, J.JaxPolicy(**POLICIES[family]), fleet=jf)
    b = T.simulate(trace, T.JaxPolicy(**POLICIES[family]), fleet=tf, device="cpu")
    for name in J._YS_NAMES:
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape, name
        # cancellation (arr - dispatch + queue, ...) leaves an ulp of the
        # series' scale on small entries
        atol = 1e-6 * float(np.abs(x).max())
        np.testing.assert_allclose(y, x, rtol=SERIES_RTOL, atol=atol, err_msg=name)
    for k in ("dt", "warm_latency_s", "sync_tail"):
        assert getattr(a, k) == getattr(b, k)
    np.testing.assert_array_equal(a.dur, b.dur)
    _hold_row(T.summarize(b), J.summarize(a))


@pytest.mark.parametrize("family", ["sync", "async", "spot_aware"])
def test_capacity_bound_fleet_rows_match_jax(trace, family):
    """Node capacity binds: each tick's creates are scaled by the free
    memory, a difference of two sums over functions (capacity - committed)
    that cancels to a few MB of 6 GB.  XLA and torch sum in different
    orders, so the per-tick creates differ in their leading digits
    (ROADMAP Queue 3); the rows, which capacity pins, hold."""
    jf, tf = _fleets("tight")
    a = J.simulate(trace, J.JaxPolicy(**POLICIES[family]), fleet=jf)
    b = T.simulate(trace, T.JaxPolicy(**POLICIES[family]), fleet=tf, device="cpu")
    _hold_row(T.summarize(b), J.summarize(a))
    np.testing.assert_allclose(b.nodes, a.nodes, rtol=SERIES_RTOL)
    _hold_row(T.simulate_chunked(trace, T.JaxPolicy(**POLICIES[family]), fleet=tf,
                                 chunk_ticks=70, device="cpu"),
              J.simulate_chunked(trace, J.JaxPolicy(**POLICIES[family]), fleet=jf,
                                 chunk_ticks=70))


@pytest.mark.parametrize("policy,fleet", [
    (dict(kind=0, keepalive_s=120), None),
    (dict(kind=1, window_s=60, target=0.7), None),
    (dict(kind=1, window_s=60, target=0.7),
     dict(node_memory_mb=8192.0, min_nodes=1, max_nodes=32)),
])
def test_chunked_matches_full_history_in_the_port(trace, policy, fleet):
    """The tolerances of tests/test_scenarios.py::test_chunked_matches_full_history."""
    fl = None if fleet is None else T.JaxFleet(**fleet)
    full = T.summarize(T.simulate(trace, T.JaxPolicy(**policy), fleet=fl, device="cpu"))
    chunk = T.simulate_chunked(trace, T.JaxPolicy(**policy), fleet=fl, chunk_ticks=257,
                               device="cpu")
    for key in ("normalized_memory", "creation_rate", "cpu_overhead",
                "instances_mean", "nodes_mean", "node_seconds", "completed"):
        assert chunk[key] == pytest.approx(full[key], rel=1e-3), key
    assert chunk["slowdown_geomean_p99"] == pytest.approx(
        full["slowdown_geomean_p99"], rel=0.05)


def test_scales_to_thousands_of_functions():
    """Mirrors tests/test_simjax.py::test_simjax_scales_to_thousands_of_functions,
    and holds the row to the JAX package's."""
    tr = synthesize(TraceConfig(num_functions=2000, duration_s=600, target_total_rps=300,
                                seed=1))
    s = T.summarize(T.simulate(tr, T.JaxPolicy(kind=1, window_s=60, target=0.7),
                               device="cpu"))
    assert np.isfinite(s["slowdown_geomean_p99"])
    assert s["instances_mean"] > 10
    _hold_row(s, J.summarize(J.simulate(tr, J.JaxPolicy(kind=1, window_s=60, target=0.7))))


def _chunk_inputs(trace, policy, dt=1.0):
    arr = rate_matrix(trace, dt)
    dur, mem, cold, wbuf, consts = T._prep_static(trace, policy, TSim(), dt)
    gq, alive, tail = gap_statistics(trace)
    return dict(arr=arr, lam=arr.mean(0) / dt, dur=dur, mem=mem, cold=cold, wbuf=wbuf,
                consts=consts, gaps=gq, alive=alive, tail=tail,
                billed=T._billed_weights(trace, None), edges=T._delay_edges(256))


@pytest.mark.parametrize("family,knob,value,others,telem,picks", [
    # sums: instances, mem_total, cpu_worker, cpu_master, useful
    ("sync", "keepalive_s", 120.0, {"cc": 1.0}, 0, [0, 1, 4, 5, 6]),
    ("sync", "cc", 2.0, {"keepalive_s": 120.0}, 0, [0, 1, 4, 5, 6]),
    # the window ring and the telemetry slots under autograd: async's
    # gradient flows through cc (slot capacity) into the busy memory, the
    # master's CPU, the served work, the completions and the billed GB-s,
    # not through its ceil into the instance counts (JAX's gradient is 0
    # there too)
    ("async", "cc", 2.0, {"target": 0.7}, 8, [2, 5, 6, 8, 10]),
])
def test_gradient_of_a_chunk_matches_jax_grad(trace, family, knob, value, others, telem,
                                              picks):
    """d(sums)/d(knob) through one chunk (warm-up included), autograd against
    jax.jacrev: the path the learned-policy training (``repro_torch.opt.learned``)
    takes."""
    policy = J.JaxPolicy(family=family, window_s=60)
    x = _chunk_inputs(trace, policy)
    n_ticks = x["arr"].shape[0]
    kw = dict(warm_tick=n_ticks // 2, total_ticks=n_ticks, family=family, dt=1.0,
              cold_ticks=x["cold"], wbuf=x["wbuf"], prov_ticks=1, has_fleet=False,
              telem_slots=telem)

    def f(v):
        pol = {knob: v, **{k: jnp.float32(o) for k, o in others.items()}}
        st = J._init_state(x["arr"].shape[1], x["cold"], x["wbuf"], 1, jnp.float32(8.0))
        _, out = J._chunk_impl(
            st, jnp.asarray(x["arr"]), jnp.asarray(x["lam"], jnp.float32),
            jnp.asarray(x["gaps"], jnp.float32),
            (jnp.asarray(x["alive"], jnp.float32), jnp.asarray(x["tail"], jnp.float32)),
            jnp.asarray(x["dur"]), jnp.asarray(x["mem"]), jnp.asarray(x["billed"]), pol,
            jnp.zeros(7), x["consts"], 8.0, jnp.asarray(x["edges"]), jnp.int32(0), **kw)
        return out[2][jnp.asarray(picks)]
    want_val = np.asarray(f(jnp.float32(value)))
    want = np.asarray(jax.jacrev(f)(jnp.float32(value)))

    v = torch.tensor(value, requires_grad=True)
    pol = {knob: v.reshape(1, 1), **{k: torch.full((1, 1), o) for k, o in others.items()}}
    up = T._upload
    st = T._init_state(x["arr"].shape[1], x["cold"], x["wbuf"], 1, 8.0)
    _, out = T._chunk_impl(
        st, T._arrivals_on(x["arr"], "cpu"), up(x["lam"], "cpu"), up(x["gaps"], "cpu"),
        (up(x["alive"], "cpu"), up(x["tail"], "cpu")), up(x["dur"], "cpu"),
        up(x["mem"], "cpu"), up(x["billed"], "cpu"), pol, torch.zeros(1, 7), x["consts"],
        8.0, torch.as_tensor(x["edges"]), 0, **kw)
    sums = out[2][0]
    np.testing.assert_allclose(sums[picks].detach().numpy(), want_val, rtol=1e-5)
    got = np.asarray([torch.autograd.grad(sums[i], v, retain_graph=True)[0].item()
                      for i in picks])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert np.all(np.abs(want) > 0)


def test_async_ceil_at_an_exact_integer_follows_the_division_order():
    """ROADMAP Queue 3 pin: fig9_production's async w60 t0.7 row is 3
    creations (7.3e-5 of creation_rate) off JAX's, on the CPU as on the card.
    The first difference is function 1471 at tick 81, whose 60-tick window of
    concurrency sums to 294: the async family's desired count is
    ceil(294 / 60 / 0.7 - 1e-9).  Evaluated as written, as torch does,
    294 / 60 / 0.7 is 7.0000005 in float32 and the port creates an instance;
    compiled, XLA rewrites (s / n) / c into s / (n * c) = 294 / 42 = 7, so the
    JAX engine creates it a tick later.  The function alone (its first 90
    ticks; no fleet couples it to the others) shows the same."""
    full = synthesize(TraceConfig(num_functions=2000, duration_s=4800.0,
                                  target_total_rps=729.0, seed=9))
    counts = rate_matrix(full)[:90, 1471:1472]
    prof = {k: np.asarray(v)[1471:1472] for k, v in vars(full.profile).items()}
    one_j = JT.RateTrace(counts, 1.0, JT.FunctionProfile(**prof), 90.0)
    one_t = TT.RateTrace(counts, 1.0, TT.FunctionProfile(**prof), 90.0)
    policy = dict(kind=1, window_s=60, target=0.7)
    a = J.simulate(one_j, J.JaxPolicy(**policy), num_nodes=50)
    b = T.simulate(one_t, T.JaxPolicy(**policy), num_nodes=50, device="cpu")
    assert np.nonzero(a.creations != b.creations)[0].tolist() == [81, 82]
    assert (a.creations[81], a.creations[82]) == (0.0, 1.0)
    assert (b.creations[81], b.creations[82]) == (1.0, 0.0)
    # the port's window at tick 81
    pol = T.JaxPolicy(**policy)
    run = T._chunked_setup(one_t, pol, T.stack_params([pol.params()]),
                           np.zeros((1, len(T._PFLEET)), np.float32), sim=TSim(),
                           dt=1.0, num_nodes=50, provision_s=0.0, has_fleet=False,
                           chunk_ticks=90, warmup_frac=0.5, nbins=256, device="cpu")
    step = T._make_step(run.arr, **{k: v for k, v in run.chunk_kw.items() if k not in
                                     ("edges", "warm_tick", "total_ticks", "telem_slots")})
    state = run.state
    with torch.no_grad():
        for tick in range(82):
            state, _ = step(state, tick)
    assert state[4].sum().item() == 294.0
    s, n, c = np.float32(294.0), np.float32(60.0), np.float32(0.7)
    ts, tn, tc = (torch.tensor(x) for x in (s, n, c))
    assert torch.ceil(ts / tn / tc - 1e-9).item() == 8.0
    assert float(jax.jit(lambda s, n, c: jnp.ceil(s / n / c - 1e-9))(s, n, c)) == 7.0
    assert float(jnp.ceil(s / (n * c) - 1e-9)) == 7.0


def test_more_than_one_device_is_not_ported(trace):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        T.simulate_chunked(trace, T.JaxPolicy(kind=0), spec=TRunSpec(devices=2), device="cpu")
    # one device is the unsharded run, as in the JAX package
    one = T.simulate_chunked(trace, T.JaxPolicy(kind=0), spec=TRunSpec(devices=1), device="cpu")
    assert one == T.simulate_chunked(trace, T.JaxPolicy(kind=0), device="cpu")
    with pytest.raises(TypeError, match="RunSpec"):
        T.simulate_chunked(trace, T.JaxPolicy(kind=0), spec={"telemetry": 1}, device="cpu")
