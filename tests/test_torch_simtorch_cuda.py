"""The fluid engine on the card against the same engine on the CPU.

Every policy family, without a fleet, with ``JaxFleet`` and with spot under a
fleet, on the 20-function trace: ``simulate``'s series at rtol 1e-5 and
``simulate_chunked``'s rows at 1e-4; a batch of points against the points
run alone; the row with telemetry off equal, bit for bit, to the row of a
run that also records telemetry.  (The CPU engine is held to the JAX package
in ``tests/test_torch_simtorch.py``.)

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_simtorch_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

import repro_torch.core.simtorch as st
from repro_torch.core.eventsim import SimConfig
from repro_torch.core.policies import init_theta
from repro_torch.core.runspec import RunSpec
from repro_torch.core.trace import TraceConfig, synthesize

SERIES_RTOL, ROW_RTOL, SLOWDOWN_RTOL = 1e-5, 1e-4, 1e-3
POLICIES = {
    "sync": dict(kind=0, keepalive_s=120),
    "async": dict(kind=1, window_s=60, target=0.7),
    "hybrid": dict(kind=2, keepalive_s=600, prewarm_s=1.0),
    "learned": dict(kind=3, theta=dict(init_theta(1), w2=np.asarray([0.4, -0.3, 0.2, 0.5],
                                                                    np.float32))),
    "spot_aware": dict(family="spot_aware", keepalive_s=300,
                       extra=dict(spot_fraction=0.5, hazard_per_hour=6.0)),
}
FLEET = dict(node_memory_mb=8192.0, min_nodes=1, max_nodes=32)


@pytest.fixture(scope="module")
def trace():
    return synthesize(TraceConfig(num_functions=20, duration_s=300, target_total_rps=4))


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the fluid engine's card path)")


def _hold_row(got, want, rtol=ROW_RTOL, slowdown_rtol=SLOWDOWN_RTOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k != "telemetry":
            tol = slowdown_rtol if k == "slowdown_geomean_p99" else rtol
            assert got[k] == pytest.approx(v, rel=tol, abs=1e-12), k


@pytest.mark.cuda
@pytest.mark.parametrize("with_fleet", [False, True])
@pytest.mark.parametrize("family", list(POLICIES))
def test_card_matches_the_cpu(trace, family, with_fleet):
    _need_cuda()
    pol = st.JaxPolicy(**POLICIES[family])
    fleet = st.JaxFleet(**FLEET) if with_fleet else None
    a = st.simulate(trace, pol, fleet=fleet, device="cpu")
    b = st.simulate(trace, pol, fleet=fleet)
    for name in st._YS_NAMES:
        x, y = getattr(a, name), getattr(b, name)
        np.testing.assert_allclose(y, x, rtol=SERIES_RTOL, atol=1e-6 * float(np.abs(x).max()),
                                   err_msg=name)
    _hold_row(st.summarize(b), st.summarize(a))
    _hold_row(st.simulate_chunked(trace, pol, fleet=fleet, chunk_ticks=70),
              st.simulate_chunked(trace, pol, fleet=fleet, chunk_ticks=70, device="cpu"))


@pytest.mark.cuda
def test_no_device_runs_on_the_card(trace):
    _need_cuda()
    row = st.simulate_chunked(trace, st.JaxPolicy(kind=0))
    assert row == st.simulate_chunked(trace, st.JaxPolicy(kind=0), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["async", "spot_aware"])
def test_a_batch_on_the_card_equals_its_points_alone(trace, family):
    _need_cuda()
    base = POLICIES[family]
    knob = "target" if family == "async" else "keepalive_s"
    values = [0.4, 0.7, 1.0, 1.6] if family == "async" else [60.0, 300.0, 900.0, 1800.0]
    pols = [st.JaxPolicy(**dict(base, **{knob: v})) for v in values]
    fleet = st.JaxFleet(**FLEET) if family == "spot_aware" else None
    fleets = np.stack([fleet.params() if fleet else np.zeros(7, np.float32)] * len(pols))
    rows = st._chunked_summaries(
        trace, pols[0], st.stack_params([p.params() for p in pols]), fleets,
        sim=SimConfig(), dt=1.0, num_nodes=8.0, provision_s=fleet.provision_s if fleet else 0.0,
        has_fleet=fleet is not None, chunk_ticks=128, warmup_frac=0.5, nbins=256)
    for p, row in zip(pols, rows):
        _hold_row(st.simulate_chunked(trace, p, fleet=fleet, chunk_ticks=128), row,
                  rtol=1e-6, slowdown_rtol=1e-6)


@pytest.mark.cuda
def test_telemetry_off_row_is_unchanged_bit_for_bit(trace):
    _need_cuda()
    pol = st.JaxPolicy(**POLICIES["spot_aware"])
    fleet = st.JaxFleet(**FLEET)
    plain = st.simulate_chunked(trace, pol, fleet=fleet, chunk_ticks=64)
    telem = st.simulate_chunked(trace, pol, fleet=fleet, chunk_ticks=64,
                                spec=RunSpec(telemetry=16))
    assert {k: v for k, v in telem.items() if k != "telemetry"} == plain
    assert telem["telemetry"]["slots"] == 16
