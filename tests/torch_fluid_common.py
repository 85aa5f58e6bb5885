"""Shared inputs of the fluid engine's CPU parity tests (not a test module)."""

import numpy as np
import pytest

import repro.core.simjax as J
from repro.core.policies import init_theta

import repro_torch.core.simtorch as T

SERIES_RTOL = 1e-5
ROW_RTOL, SLOWDOWN_RTOL = 1e-4, 1e-3

SPOT = dict(family="spot_aware", keepalive_s=300,
            extra=dict(spot_fraction=0.5, hazard_per_hour=6.0))
THETA = dict(init_theta(1), w2=np.asarray([0.4, -0.3, 0.2, 0.5], np.float32))
POLICIES = {
    "sync": dict(kind=0, keepalive_s=120),
    "async": dict(kind=1, window_s=60, target=0.7),
    "hybrid": dict(kind=2, keepalive_s=600, prewarm_s=1.0),
    "learned": dict(kind=3, theta=THETA),
    "spot_aware": SPOT,
}
FLEETS = {
    None: None,
    "fleet": dict(node_memory_mb=8192.0, min_nodes=1, max_nodes=32),
    # capacity binds: creates are scaled down and re-requested
    "tight": dict(node_memory_mb=2048.0, min_nodes=1, max_nodes=3, provision_s=30.0),
}


def _fleets(name):
    kw = FLEETS[name]
    return (None, None) if kw is None else (J.JaxFleet(**kw), T.JaxFleet(**kw))


def _hold_row(got, want, rtol=ROW_RTOL, slowdown_rtol=SLOWDOWN_RTOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "telemetry":
            continue
        tol = slowdown_rtol if k == "slowdown_geomean_p99" else rtol
        assert got[k] == pytest.approx(v, rel=tol, abs=1e-12), k
