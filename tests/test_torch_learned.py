"""``repro_torch.opt.learned`` (the learned policy through autograd) against
``repro.opt.learned`` (``jax.value_and_grad`` through the chunked scan).

On the CPU at fleet_cost_stress's 0.1 x (30 functions, 360 ticks, a fleet):
``make_loss``'s value at rtol 1e-4 and its gradient within 1e-3 of each
leaf's largest entry, for the learned family's ``theta``, a sync policy's
``keepalive_s`` and an async policy's ``target`` and ``cc``, at the default
truncation and at one that pads the JAX loss's last chunk; ``init_theta`` bit
for bit; ``train_policy`` for 3 steps (history and ``theta`` at 1e-3);
``refine_leaves`` on one point; ``evaluate_trained`` and ``confirm`` on the
trained policy; the evo engine's gradient endgame; the device rule.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.policies as JP
import repro.opt as J
import repro.opt.learned as JL
from repro.core.eventsim import SimConfig as JSim
from repro.fleet.billing import apply_throttle as j_throttle
from repro.scenarios import get_scenario as j_scenario

import repro_torch.core.policies as TP
import repro_torch.opt as T
import repro_torch.opt.learned as TL
from repro_torch.core.eventsim import SimConfig as TSim
from repro_torch.fleet.billing import apply_throttle as t_throttle
from repro_torch.scenarios import get_scenario as t_scenario

from torch_opt_common import hold_result, hold_row

NAME, SCALE = "fleet_cost_stress", 0.1
LOSS_RTOL, GRAD_LEAF_FRAC, TRAIN_TOL = 1e-4, 1e-3, 1e-3


def _losses(family: str, trunc_ticks: int):
    """Both packages' loss on the scenario's trace under ``family``, as
    ``train_policy`` builds it -> (JAX loss_fn, params0, port loss_fn, params0)."""
    out = []
    for get, throttle, sim, mod, policies in (
            (j_scenario, j_throttle, JSim, JL, JP), (t_scenario, t_throttle, TSim, TL, TP)):
        sc = get(NAME)
        spec = dataclasses.replace(sc.policy, kind=family,
                                   theta=policies.init_theta(0) if family == "learned" else None)
        trace = throttle(sc.build_trace(SCALE), sc.billing)
        kw = dict(device="cpu") if mod is TL else {}
        loss, p0 = mod.make_loss(trace, spec.to_jax(), sim=sim(), fleet=mod.default_fleet(sc),
                                 billing=sc.billing, trunc_ticks=trunc_ticks, **kw)
        out += [loss, p0]
    return out


def _flat(tree, prefix: str = "") -> dict:
    """A gradient tree (JAX arrays or tensors) as {path: numpy array}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("family,keys,trunc", [
    ("learned", ("theta",), 64),
    # 360 ticks in chunks of 7: the JAX loss pads its last chunk with 2 ticks
    ("learned", ("theta",), 7),
    ("sync", ("keepalive_s",), 64),
    ("async", ("target", "cc"), 64),
])
def test_make_loss_value_and_grad_match_jax(family, keys, trunc):
    jl, jp0, tl, tp0 = _losses(family, trunc)
    jth = {k: jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), jp0[k]) for k in keys}
    jfro = {k: v for k, v in jp0.items() if k not in keys}
    want, wgrad = jax.value_and_grad(lambda t: jl({**jfro, **t}))(jth)
    tth = {k: TL._tree_map(lambda x: TL._trainable(x, "cpu"), tp0[k]) for k in keys}
    got, ggrad = TL._value_and_grad(tl, {k: v for k, v in tp0.items() if k not in keys}, tth)
    assert got == pytest.approx(float(want), rel=LOSS_RTOL)
    wflat, gflat = _flat(wgrad), _flat(ggrad)
    assert gflat.keys() == wflat.keys()
    for path, w in wflat.items():
        # within GRAD_LEAF_FRAC of the leaf's largest entry
        err = np.abs(gflat[path] - w).max()
        assert err <= GRAD_LEAF_FRAC * np.abs(w).max(), (path, gflat[path], w)
    nonzero = sum(bool(np.abs(w).max() > 0) for w in wflat.values())
    assert nonzero > 0


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_init_theta_is_jax_bit_for_bit(seed):
    a, b = TP.init_theta(seed), JP.init_theta(seed)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def trained():
    want = JL.train_policy(NAME, scale=SCALE, steps=3)
    got = TL.train_policy(NAME, scale=SCALE, steps=3, device="cpu")
    return got, want


def test_train_policy_matches_jax(trained):
    got, want = trained
    assert got.history == pytest.approx(want.history, rel=TRAIN_TOL)
    assert got.history[-1] < got.history[0]
    assert got.policy.family == want.policy.family == "learned"
    for k, v in want.policy.theta.items():
        np.testing.assert_allclose(got.policy.theta[k], v, atol=TRAIN_TOL)
        assert np.asarray(got.policy.theta[k]).dtype == np.float32
    gs, ws = got.summary(), want.summary()
    assert {k: v for k, v in gs.items() if k not in ("wall_s", "loss_initial", "loss_final")} \
        == {k: v for k, v in ws.items() if k not in ("wall_s", "loss_initial", "loss_final")}


def test_trained_policy_runs_both_engines_as_jax(trained):
    """The trained policy round-trips into a Scenario that the fluid engine
    (evaluate_trained) and the oracle (confirm) both run, as JAX's does."""
    got, want = trained
    hold_row(TL.evaluate_trained(NAME, got, scale=SCALE, device="cpu"),
             JL.evaluate_trained(NAME, want, scale=SCALE))
    a = TL.confirm(NAME, got, scale=SCALE, device="cpu")
    b = JL.confirm(NAME, want, scale=SCALE)
    assert {k: a[k] for k in ("scenario", "scale", "pass")} == \
        {k: b[k] for k in ("scenario", "scale", "pass")}
    assert a["gaps"] == pytest.approx(b["gaps"], abs=1e-4)
    sc = TL.learned_scenario(t_scenario(NAME), got)
    assert sc.policy.kind == "learned" and sc.policy.theta is got.policy.theta


@pytest.mark.parametrize("point,axes,steps", [
    ({"keepalive_s": 300.0, "util_target": 0.7, "warm_frac": 0.25}, ["keepalive_s"], 3),
    # an axis the sync family does not carry is skipped
    ({"keepalive_s": 1200.0, "warm_frac": 0.0}, ["keepalive_s", "target"], 1),
])
def test_refine_leaves_matches_jax(point, axes, steps):
    want = JL.refine_leaves(NAME, point, axes, scale=SCALE, steps=steps)
    got = TL.refine_leaves(NAME, point, axes, scale=SCALE, steps=steps, device="cpu")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
    assert got["keepalive_s"] != point["keepalive_s"]


def test_refine_leaves_with_nothing_to_refine_returns_the_point():
    point = {"keepalive_s": 300.0}
    assert TL.refine_leaves(NAME, point, ["target"], scale=SCALE, device="cpu") == point


def test_evo_gradient_endgame_parts_from_jax_by_two_ulps():
    """Queue 3 pin: at budget 64 the evo engine refines two elites by a few
    Adam steps of the surrogate's gradient.  At scale 0.1, coarse_frac 0.5
    (seed 0) the 40 candidates equal JAX's but one: the second refined
    elite's keepalive_s, the end of six float32 Adam steps, lands 2 float32
    ulps (2.4e-4 s of 1905.5 s) above JAX's, so its key differs.  Every
    other candidate, the budget's ledger, the rows, fronts, robust ids and
    hypervolume are JAX's."""
    kw = dict(scale=0.1, coarse_frac=0.5, algo="evo", budget=64, seed=0)
    want = J.frontier_search([NAME], **kw)
    got = T.frontier_search([NAME], device="cpu", **kw)
    assert got.budget.summary() == want.budget.summary()
    assert "grad" in got.budget.by_stage()
    differ = [i for i, (p, q) in enumerate(zip(got.points, want.points)) if p != q]
    assert len(got.points) == len(want.points) == 40 and differ == [33]
    p, q = got.points[33], want.points[33]
    assert {k for k in p if p[k] != q[k]} == {"keepalive_s"}
    ulp = float(np.spacing(np.float32(q["keepalive_s"])))
    assert 0 < abs(p["keepalive_s"] - q["keepalive_s"]) <= 2 * ulp
    got.points[33] = q
    hold_result(got, want)


def test_no_device_means_cuda_or_raise():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-CUDA error cannot be shown here")
    sc = t_scenario(NAME)
    trace = sc.build_trace(SCALE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.make_loss(trace, sc.policy.to_jax())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.train_policy(NAME, scale=SCALE, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.refine_leaves(NAME, {"keepalive_s": 300.0}, ["keepalive_s"], scale=SCALE)
    with pytest.raises(ValueError, match="declares no learnable axes"):
        TL.train_policy(NAME, family="sync", scale=SCALE, steps=1, device="cpu")
