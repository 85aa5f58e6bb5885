"""The optimizer on the card against the same calls on the CPU.

A grid stage (``evaluate_scenario`` on fleet_cost_stress and region_failover
at 0.05 x: rows at rtol 1e-4, the slowdown 1e-3), the grid
``frontier_search`` (the same fronts and robust ids), a seeded evo search
(the same candidates), the learned policy's surrogate loss and its gradient
through autograd (loss at 1e-5, each gradient leaf within 1e-3 of its
largest entry) and a 2-step ``train_policy`` (history and ``theta`` at
1e-3).  (The CPU calls are held to the JAX package in
``tests/test_torch_opt.py`` and ``tests/test_torch_learned.py``.)

Imports no jax, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_opt_cuda.py

The card tests carry the ``cuda`` marker and skip where there is no card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.opt as T
import repro_torch.opt.learned as L
from repro_torch.core.eventsim import SimConfig
from repro_torch.core.policies import init_theta
from repro_torch.core.runspec import RunSpec
from repro_torch.fleet.billing import apply_throttle
from repro_torch.scenarios import get_scenario

ROW_RTOL, SLOWDOWN_RTOL = 1e-4, 1e-3
SCALE = 0.05
SPACE = dict(policy={"keepalive_s": (60.0, 600.0)}, fleet={"warm_frac": (0.0, 0.25)})


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the optimizer's card path)")


def _hold_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k == "stage_wall_s":
                continue
            if isinstance(v, (float, np.floating)):
                tol = SLOWDOWN_RTOL if k == "slowdown_geomean_p99" else ROW_RTOL
                assert float(g[k]) == pytest.approx(float(v), rel=tol, abs=1e-12), k
            else:
                assert g[k] == v, k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fleet_cost_stress", "region_failover"])
def test_grid_stage_on_the_card_holds_the_cpu(name):
    _need_cuda()
    pts = T.DEFAULT_SPACE.points()
    card = T.evaluate_scenario(name, pts, spec=RunSpec(scale=SCALE), device="cuda")
    cpu = T.evaluate_scenario(name, pts, spec=RunSpec(scale=SCALE), device="cpu")
    _hold_rows(card, cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["grid", "evo"])
def test_search_on_the_card_holds_the_cpu(algo):
    _need_cuda()
    kw = dict(space=T.SearchSpace(**SPACE), scale=0.1, coarse_frac=0.5, algo=algo,
              budget=12, seed=0)
    card = T.frontier_search(["fleet_cost_stress"], device="cuda", **kw)
    cpu = T.frontier_search(["fleet_cost_stress"], device="cpu", **kw)
    assert card.points == cpu.points
    for name in cpu.refined:
        _hold_rows(card.refined[name], cpu.refined[name])
        assert [r["point_id"] for r in card.fronts[name]] == \
            [r["point_id"] for r in cpu.fronts[name]]
    assert card.robust_ids == cpu.robust_ids


def _loss(device):
    sc = get_scenario("fleet_cost_stress")
    spec = dataclasses.replace(sc.policy, kind="learned", theta=init_theta(0))
    trace = apply_throttle(sc.build_trace(SCALE), sc.billing)
    loss_fn, p0 = L.make_loss(trace, spec.to_jax(), sim=SimConfig(),
                              fleet=T.default_fleet(sc), billing=sc.billing, device=device)
    theta = {"theta": L._tree_map(lambda x: L._trainable(x, device), p0["theta"])}
    return L._value_and_grad(loss_fn, {k: v for k, v in p0.items() if k != "theta"}, theta)


@pytest.mark.cuda
def test_learned_loss_and_gradient_on_the_card_hold_the_cpu():
    _need_cuda()
    (card, cgrad), (cpu, pgrad) = _loss("cuda"), _loss("cpu")
    assert card == pytest.approx(cpu, rel=1e-5)
    for k, w in pgrad["theta"].items():
        g, w = cgrad["theta"][k].cpu().numpy(), w.numpy()
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), k


@pytest.mark.cuda
def test_train_policy_on_the_card_holds_the_cpu():
    _need_cuda()
    card = L.train_policy("fleet_cost_stress", scale=SCALE, steps=2, device="cuda")
    cpu = L.train_policy("fleet_cost_stress", scale=SCALE, steps=2, device="cpu")
    assert card.history == pytest.approx(cpu.history, rel=1e-3)
    for k, v in cpu.policy.theta.items():
        np.testing.assert_allclose(card.policy.theta[k], v, atol=1e-3)
