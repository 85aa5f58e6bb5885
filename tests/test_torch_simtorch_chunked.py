"""The fluid engine's chunked rows (``simulate_chunked``,
``_chunked_summaries``) against ``repro.core.simjax``'s, on the CPU: rtol
1e-4 (slowdown 1e-3) with a chunk length that does not divide T, telemetry
slots, a billing profile, RateTraces with clustered weights and a batch of
points; the row with telemetry off bit for bit; the float32 slowdown solver.
"""

import numpy as np
import pytest
import torch

import repro.core.simjax as J
from repro.core.eventsim import SimConfig as JSim
from repro.core.runspec import RunSpec as JRunSpec
from repro.core.trace import TraceConfig, synthesize, synthesize_rates

import repro_torch.core.simtorch as T
from repro_torch.core.eventsim import SimConfig as TSim
from repro_torch.core.runspec import RunSpec as TRunSpec
from repro_torch.core.trace import TraceConfig as TTraceConfig
from repro_torch.core.trace import synthesize_rates as tsynthesize_rates
from torch_fluid_common import FLEETS, POLICIES, ROW_RTOL, SPOT, THETA, _fleets, _hold_row


@pytest.fixture(scope="module")
def trace():
    return synthesize(TraceConfig(num_functions=20, duration_s=300, target_total_rps=4))


@pytest.mark.parametrize("fleet", [None, "fleet"])
@pytest.mark.parametrize("family", list(POLICIES))
def test_chunked_rows_match_jax(trace, family, fleet):
    """chunk_ticks 70 does not divide T = 300; telemetry on; a billing
    profile that rounds."""
    jf, tf = _fleets(fleet)
    a = J.simulate_chunked(trace, J.JaxPolicy(**POLICIES[family]), fleet=jf, chunk_ticks=70,
                           spec=JRunSpec(telemetry=7, billing="aws_lambda"))
    b = T.simulate_chunked(trace, T.JaxPolicy(**POLICIES[family]), fleet=tf, chunk_ticks=70,
                           spec=TRunSpec(telemetry=7, billing="aws_lambda"), device="cpu")
    _hold_row(b, a)
    ta, tb = a["telemetry"], b["telemetry"]
    assert ta.keys() == tb.keys() and ta["series"].keys() == tb["series"].keys()
    np.testing.assert_array_equal(ta["ticks_per_slot"], tb["ticks_per_slot"])
    np.testing.assert_array_equal(ta["t"], tb["t"])
    for k, v in ta["series"].items():
        np.testing.assert_allclose(tb["series"][k], v, rtol=ROW_RTOL, atol=1e-6, err_msg=k)
    for k, v in ta["attribution"].items():
        assert tb["attribution"][k] == pytest.approx(v, rel=ROW_RTOL, abs=1e-9), k


def test_telemetry_off_is_the_row_without_telemetry(trace):
    pol = T.JaxPolicy(**SPOT)
    fl = T.JaxFleet(**FLEETS["fleet"])
    plain = T.simulate_chunked(trace, pol, fleet=fl, chunk_ticks=64, device="cpu")
    telem = T.simulate_chunked(trace, pol, fleet=fl, chunk_ticks=64,
                               spec=TRunSpec(telemetry=16), device="cpu")
    assert {k: v for k, v in telem.items() if k != "telemetry"} == plain


@pytest.mark.parametrize("clustered", [False, True])
def test_rate_traces_and_clustered_weights_match_jax(clustered):
    """A RateTrace (each package's own), with hand-set super-function
    weights: bucket-mean counts of ``weights`` members each."""
    cfg = dict(num_functions=30, duration_s=600, target_total_rps=6, seed=4)
    rates = [synthesize_rates(TraceConfig(**cfg), tick_s=2.0),
             tsynthesize_rates(TTraceConfig(**cfg), tick_s=2.0)]
    if clustered:
        w = np.random.default_rng(0).integers(1, 6, 30).astype(np.float64)
        for r in rates:
            r.weights = w
            r.counts = r.counts / w[None, :]
    for kw in (POLICIES["sync"], POLICIES["async"], POLICIES["hybrid"]):
        a = J.simulate_chunked(rates[0], J.JaxPolicy(**kw), dt=2.0, num_nodes=4,
                               chunk_ticks=100, spec=JRunSpec(telemetry=4))
        b = T.simulate_chunked(rates[1], T.JaxPolicy(**kw), dt=2.0, num_nodes=4,
                               chunk_ticks=100, spec=TRunSpec(telemetry=4), device="cpu")
        _hold_row(b, a)
        for k, v in a["telemetry"]["attribution"].items():
            assert b["telemetry"]["attribution"][k] == pytest.approx(v, rel=ROW_RTOL, abs=1e-9)


@pytest.mark.parametrize("family,fleet", [("sync", None), ("async", None), ("learned", None),
                                          ("spot_aware", "fleet")])
def test_batched_points_match_jax(trace, family, fleet):
    rng = np.random.default_rng(1)
    base = POLICIES[family]
    pols = []
    for _ in range(4):
        kw = dict(base)
        if "keepalive_s" in kw:
            kw["keepalive_s"] = float(rng.uniform(30, 900))
        if family == "async":
            kw["target"] = float(rng.uniform(0.3, 1.5))
        if family == "learned":
            kw["theta"] = dict(THETA, w2=rng.normal(0, 0.5, 4).astype(np.float32))
        pols.append(kw)
    jf, tf = _fleets(fleet)
    fleets = np.stack([np.asarray(jf.params()) * np.float32(s) if jf else np.zeros(7, np.float32)
                       for s in (1.0, 1.0, 1.0, 1.0)])
    if jf is not None:
        fleets[:, 1] = [8, 16, 32, 4]                  # max_nodes per point
    common = dict(sim=JSim(), dt=1.0, num_nodes=8.0,
                  provision_s=jf.provision_s if jf else 0.0, has_fleet=jf is not None,
                  chunk_ticks=128, warmup_frac=0.5, nbins=256)
    a = J._chunked_summaries(trace, J.JaxPolicy(**base),
                             J.stack_params([J.JaxPolicy(**k).params() for k in pols]),
                             fleets, **common)
    common["sim"] = TSim()
    b = T._chunked_summaries(trace, T.JaxPolicy(**base),
                             T.stack_params([T.JaxPolicy(**k).params() for k in pols]),
                             fleets, device="cpu", **common)
    assert len(a) == len(b) == 4
    for x, y in zip(a, b):
        _hold_row(y, x)
    # each batched row is the row of that point run alone
    alone = T.simulate_chunked(trace, T.JaxPolicy(**pols[2]),
                               fleet=None if tf is None else T.JaxFleet(
                                   **dict(FLEETS[fleet], max_nodes=32.0)),
                               chunk_ticks=128, device="cpu")
    _hold_row(alone, b[2], rtol=1e-6, slowdown_rtol=1e-6)


def test_torch_solver_matches_the_jax_solver():
    rng = np.random.default_rng(5)
    f, nbins = 300, 256
    edges = J._delay_edges(nbins)
    hist = rng.gamma(0.3, 1.0, (f, nbins)) * (rng.uniform(size=(f, nbins)) < 0.1)
    hist[:, 0] += rng.uniform(0, 50, f)
    arrtot = hist.sum(1)
    arrtot[:7] = 2.0                                  # below min_requests
    med = rng.uniform(0.05, 3.0, f)
    sig = rng.uniform(0.2, 1.5, f)
    weights = rng.integers(1, 4, f).astype(np.float64)
    for iid in (True, False):
        for fw in (None, weights):
            want = J._slowdown_geomean_jax(hist, arrtot, edges, med, sig, 0.008, 5, 0.99,
                                           iid, fw)
            got = T._slowdown_geomean_torch(torch.as_tensor(hist), arrtot, edges, med, sig,
                                            0.008, 5, 0.99, iid, fw)
            assert got == pytest.approx(want, rel=1e-5)
            # and near the float64 numpy bisection
            assert got == pytest.approx(J._slowdown_geomean(
                hist, arrtot, edges, med, sig, 0.008, iid_tail=iid, fn_weights=fw), rel=1e-3)
    # the routing: a histogram of 1 << 22 cells goes to the torch solver
    big = np.zeros((1 << 14, nbins))
    big[:, 0] = 10.0
    big[::3, 40] = 1.0
    n_big = big.sum(1)
    med_b, sig_b = np.full(1 << 14, 0.5), np.full(1 << 14, 1.0)
    assert T._slowdown_geomean(big, n_big, edges, med_b, sig_b, 0.008, device="cpu") == \
        pytest.approx(J._slowdown_geomean(big, n_big, edges, med_b, sig_b, 0.008), rel=1e-5)
