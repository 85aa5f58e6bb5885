"""The cells layer's fluid leg on the card against the same leg on the CPU.

The three cells scenarios at 0.1 x (rows at rtol 1e-4, the slowdown 1e-3,
``cell_rows`` at 1e-4), a variant with the router's spill and a reactive
trigger; two card runs of a cells scenario bit for bit (the histogram takes
one ``scatter_add_`` a cell, in cell order); a one-cell topology on the card
bit for bit the plain engine on the card.  (The CPU leg is held to the JAX
package in ``tests/test_torch_cells.py``.)

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cells_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import dataclasses

import pytest
import torch

import repro_torch.cells as C
from repro_torch.cells.fluid import run_cells_fluid
from repro_torch.core.eventsim import SimConfig
from repro_torch.core.runspec import RunSpec
from repro_torch.core.simtorch import simulate_chunked
from repro_torch.scenarios import get_scenario, run_scenario

ROW_RTOL, SLOWDOWN_RTOL = 1e-4, 1e-3
SCALE = 0.1
CELLS = ["region_failover", "follow_the_sun", "cell_hazard_corr"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells fluid leg's card path)")


def _hold_row(got, want, rtol=ROW_RTOL, slowdown_rtol=SLOWDOWN_RTOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k != "wall_s":
            tol = slowdown_rtol if k == "slowdown_geomean_p99" else rtol
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=tol, abs=1e-12), k
            else:
                assert got[k] == v, k


def _fluid(name, device):
    detail: dict = {}
    rows = run_scenario(name, detail=detail, device=device,
                        spec=RunSpec(scale=SCALE, engines=("simjax",)))
    return rows[0], detail["cell_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_matches_the_cpu(name):
    _need_cuda()
    card, card_cells = _fluid(name, None)
    cpu, cpu_cells = _fluid(name, "cpu")
    _hold_row(card, cpu)
    for a, b in zip(card_cells, cpu_cells):
        _hold_row(a, b, slowdown_rtol=ROW_RTOL)


@pytest.mark.cuda
def test_spill_and_a_reactive_trigger_card_matches_the_cpu():
    _need_cuda()
    sc = get_scenario("region_failover")
    sc = dataclasses.replace(
        sc, cells=dataclasses.replace(sc.cells, reactive=(
            C.ReactiveTrigger("burst", util_high=0.05, change=2, hold_s=30.0,
                              cooldown_s=60.0),)),
        policy=dataclasses.replace(sc.policy, extra={**sc.policy.extra,
                                                     "spill_threshold": 0.5}))
    traces = C.build_cell_traces(sc, scale=SCALE)
    _hold_row(run_cells_fluid(sc, traces, SimConfig()),
              run_cells_fluid(sc, traces, SimConfig(), device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_two_card_runs_are_bit_for_bit(name):
    _need_cuda()
    a = _fluid(name, "cuda")
    b = _fluid(name, "cuda")
    assert {k: v for k, v in a[0].items() if k != "wall_s"} == \
        {k: v for k, v in b[0].items() if k != "wall_s"}
    assert a[1] == b[1]


@pytest.mark.cuda
def test_one_cell_is_the_plain_engine_on_the_card():
    _need_cuda()
    sc = dataclasses.replace(get_scenario("region_failover"),
                             cells=C.CellTopology(cell_count=1))
    traces = C.build_cell_traces(sc, scale=0.25)
    sim = SimConfig(tick_s=sc.policy.tick_s)
    cells_row = run_cells_fluid(sc, traces, sim)
    plain_row = simulate_chunked(traces[0], sc.policy.to_jax(), sim=sim, dt=sim.tick_s,
                                 num_nodes=sc.num_nodes, fleet=sc.fleet,
                                 chunk_ticks=sc.chunk_ticks)
    assert cells_row == plain_row
