"""The fluid engine's sharded run on the card against the unsharded run on
the card.

On the 61-function trace (prime F, so two shards pad the function axis):
``RunSpec(devices=1)`` is the unsharded run bit for bit; a two-shard mesh
that places both shards on ``cuda:0`` gives the unsharded run's per-function
histograms and arrival totals bit for bit and its rows within 1e-6, on the
function axis and on the point axis; ``RunSpec(devices=2)`` runs on two
cards where two are visible.  Two shards on one card test the shard logic,
not a speed-up.  (The sharded CPU run is held to the JAX package in
``tests/test_torch_simtorch_sharded.py``.)

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_sharded_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import numpy as np
import pytest
import torch

import repro_torch.core.simtorch as st
from repro_torch.core.eventsim import SimConfig
from repro_torch.core.runspec import RunSpec
from repro_torch.core.trace import TraceConfig, synthesize
from repro_torch.distributed.sharding import Mesh
from repro_torch.opt import evaluate_points

ROW_RTOL = 1e-6
POLICY = dict(kind=0, keepalive_s=120)


@pytest.fixture(scope="module")
def trace():
    return synthesize(TraceConfig(num_functions=61, duration_s=900, target_total_rps=8, seed=7))


def _need_cuda(n: int = 1):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s) (the sharded run's card path); "
                    f"{torch.cuda.device_count()} visible")


def _two_on_one_card(axis: str) -> Mesh:
    return Mesh((axis,), (2,), (torch.device("cuda", 0),) * 2)


class _Recorder:
    """Keeps each row's per-function histogram and arrival totals."""

    def __init__(self, monkeypatch):
        self.seen = []
        inner = st._acc_summary

        def wrapped(hist, arrtot, *a, **kw):
            h = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
            self.seen.append((h.copy(), np.asarray(arrtot).copy()))
            return inner(hist, arrtot, *a, **kw)
        monkeypatch.setattr(st, "_acc_summary", wrapped)

    def take(self):
        out, self.seen = self.seen, []
        return out


def _fn_rows(trace, mesh=None, devices=0):
    pol = st.JaxPolicy(**POLICY)
    return st._chunked_summaries(
        trace, pol, st.stack_params([pol.params()]),
        np.zeros((1, len(st._PFLEET)), np.float32), sim=SimConfig(), dt=1.0, num_nodes=8,
        provision_s=0.0, has_fleet=False, chunk_ticks=128, warmup_frac=0.5, nbins=256,
        devices=devices, mesh=mesh)


def _hold(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=ROW_RTOL, abs=1e-12), k


@pytest.mark.cuda
def test_one_device_is_the_unsharded_run_bit_for_bit(trace):
    _need_cuda()
    pol = st.JaxPolicy(**POLICY)
    base = st.simulate_chunked(trace, pol, chunk_ticks=128)
    assert st.simulate_chunked(trace, pol, chunk_ticks=128, spec=RunSpec(devices=1)) == base


@pytest.mark.cuda
def test_two_function_shards_on_one_card_are_the_unsharded_run(trace, monkeypatch):
    _need_cuda()
    rec = _Recorder(monkeypatch)
    base = _fn_rows(trace)[0]
    base_h = rec.take()
    got = _fn_rows(trace, mesh=_two_on_one_card("functions"))[0]
    got_h = rec.take()
    _hold(got, base)
    for (hg, ag), (hb, ab) in zip(got_h, base_h):
        np.testing.assert_array_equal(hg, hb)
        np.testing.assert_array_equal(ag, ab)


@pytest.mark.cuda
def test_two_point_shards_on_one_card_are_the_unsharded_batch(trace):
    _need_cuda()
    pts = [{"keepalive_s": ka} for ka in (60.0, 120.0, 300.0, 600.0)]
    pol, fleet = st.JaxPolicy(kind=0), st.JaxFleet(node_memory_mb=8192.0)
    base = evaluate_points(trace, pol, fleet, pts)
    got = evaluate_points(trace, pol, fleet, pts, mesh=_two_on_one_card("points"))
    for g, b in zip(got, base):
        _hold(g, b)


@pytest.mark.cuda
def test_two_cards(trace):
    _need_cuda(2)
    pol = st.JaxPolicy(**POLICY)
    base = st.simulate_chunked(trace, pol, chunk_ticks=128)
    _hold(st.simulate_chunked(trace, pol, chunk_ticks=128, spec=RunSpec(devices=2)), base)
