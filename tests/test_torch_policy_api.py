"""``repro_torch.core.policy_api`` against ``repro.core.policy_api``.

The port keeps its own registry; its metadata equals the JAX package's, and
each family's ``decide`` gives the JAX outputs on the same random
observations (one point with (F,) tensors, and a batch of P = 3 points with
a leading point axis against P separate JAX calls) at rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.policy_api as J
from repro.core.policies import init_theta as j_init_theta
from repro.core.policies import learned_keepalive as np_learned_keepalive
from repro.core.simjax import JaxPolicy as JPolicy

import repro_torch.core.policy_api as T
from repro_torch.core.simtorch import JaxPolicy as TPolicy

F = 64
P = 3
RTOL = 1e-6
# XLA flushes subnormal float32 results and inputs to zero, torch keeps
# them: a flushed intermediate moves a result by far less than this
TINY = 1e-30
FAMILIES = ["sync", "async", "hybrid", "learned", "spot_aware"]


def test_registry_metadata_equals_jax():
    # importing either cells package registers its "cells" family (another
    # test module in the same process may have done so already): import
    # both, and the two registries hold the same six families
    import repro.cells  # noqa: F401
    import repro_torch.cells  # noqa: F401
    assert T.list_families() == J.list_families() == sorted(FAMILIES + ["cells"])
    assert T.sweepable_policy_axes() == J.sweepable_policy_axes()
    assert T.HYBRID_MIN_KA_S == J.HYBRID_MIN_KA_S
    assert dataclasses.asdict(T.CC_AXIS) == dataclasses.asdict(J.CC_AXIS)
    for name in FAMILIES + ["cells"]:
        a, b = J.get_family(name), T.get_family(name)
        for attr in ("name", "kind", "synchronous_tail", "cold_factor", "uses_window"):
            assert getattr(a, attr) == getattr(b, attr), (name, attr)
        assert [dataclasses.asdict(x) for x in a.axes] == [dataclasses.asdict(x) for x in b.axes]
        assert a.sweepable_axes() == b.sweepable_axes()
        assert a.learnable_axes() == b.learnable_axes()
    for kind in range(4):
        assert T.get_family(kind).name == J.get_family(kind).name
    with pytest.raises(KeyError, match="unknown policy family"):
        T.get_family("nope")
    with pytest.raises(KeyError, match="unknown policy kind"):
        T.get_family(9)
    with pytest.raises(ValueError, match="duplicate"):
        T.register_family(T.SyncKeepaliveFamily())


def _obs(rng, lead=()):
    """Random observations: per-point fields with shape lead + (F,), the
    per-function rates, gap quantiles and (F, K) gap tables shared."""
    def u(lo, hi):
        return rng.uniform(lo, hi, lead + (F,)).astype(np.float32)
    inst = np.floor(u(0, 6)) + u(0, 1) * (u(0, 1) < 0.3)
    idle = np.floor(u(0, 3))
    lam = np.exp(rng.uniform(np.log(1e-3), np.log(5.0), F)).astype(np.float32)
    grid = J.KA_GRID[None, :]
    rate = lam[:, None] * rng.uniform(0.5, 2.0, (F, 1))
    alive = (-np.expm1(-rate * grid) / rate).astype(np.float32)
    tail = np.exp(-rate * grid).astype(np.float32)
    return dict(arr=np.floor(u(0, 4)), queue=u(0, 3), inst=inst, pending=np.floor(u(0, 2)),
                idle=np.minimum(idle, inst), idle_frac=u(0, 2), free=u(0, 3), avg=u(0, 8),
                demand=u(0, 2), lam=lam,
                gap_p99=np.exp(rng.uniform(0, np.log(4000.0), F)).astype(np.float32),
                alive_tab=alive, tail_tab=tail)


def _params(rng, name):
    p = {"cc": float(rng.integers(1, 4))}
    if name in ("sync", "hybrid", "spot_aware"):
        p["keepalive_s"] = float(rng.uniform(5, 2000))
    if name == "async":
        p["target"] = float(rng.uniform(0.1, 2.0))
    if name == "hybrid":
        p["prewarm_s"] = float(rng.uniform(0, 2))
    if name == "spot_aware":
        p["spot_fraction"] = float(rng.uniform(0, 1))
        p["hazard_per_hour"] = float(rng.uniform(0, 30))
    if name == "learned":
        theta = j_init_theta(int(rng.integers(100)))
        theta["w2"] = rng.normal(0, 0.5, theta["w2"].shape).astype(np.float32)
        p["theta"] = theta
    return p


def _jax_decide(name, params, obs, dt):
    pj = {k: ({n: jnp.asarray(v) for n, v in val.items()} if isinstance(val, dict)
              else jnp.float32(val)) for k, val in params.items()}
    oj = J.PolicyObs(**{k: jnp.asarray(v) for k, v in obs.items()}, dt=dt)
    if name == "learned":
        # The expiry rate magnifies the keepalive's relative error by
        # d ln r / d ln ka (~ lam * ka, tens for chatty functions), and XLA's
        # and torch's float32 exp/tanh differ by an ulp.  So the network is
        # held on its own (JAX's learned_keepalive(xp=jnp) against the port's
        # at RTOL), and the decide to JAX's sync decide fed the port's
        # keepalive: together they are the learned decide.
        theta = {n: torch.as_tensor(v) for n, v in params["theta"].items()}
        ka = T.learned_keepalive(theta, torch.as_tensor(obs["lam"])).numpy()
        np.testing.assert_allclose(
            ka, np.asarray(J.learned_keepalive(pj["theta"], oj.lam, xp=jnp)), rtol=RTOL)
        pj = {"cc": pj["cc"], "keepalive_s": jnp.asarray(ka)}
        name = "sync"
    d = J.get_family(name).decide(pj, oj)
    return [np.asarray(x, np.float32) * np.ones(F, np.float32)
            for x in (d.create, d.retire, d.cold_hide)]


def _to_torch(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("dt", [1.0, 2.0])
@pytest.mark.parametrize("name", FAMILIES)
def test_decide_one_point_matches_jax(name, dt):
    rng = np.random.default_rng(FAMILIES.index(name) + int(dt) * 10)
    obs, params = _obs(rng), _params(rng, name)
    want = _jax_decide(name, params, obs, dt)
    pt = {k: ({n: _to_torch(v) for n, v in val.items()} if isinstance(val, dict)
              else _to_torch(val)) for k, val in params.items()}
    d = T.get_family(name).decide(pt, T.PolicyObs(**{k: _to_torch(v) for k, v in obs.items()},
                                                  dt=dt))
    for w, g in zip(want, (d.create, d.retire, d.cold_hide)):
        g = np.asarray(g, np.float32) * np.ones(F, np.float32)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=TINY)


@pytest.mark.parametrize("name", FAMILIES)
def test_decide_batched_matches_separate_jax_calls(name):
    rng = np.random.default_rng(100 + FAMILIES.index(name))
    obs = _obs(rng, lead=(P,))
    params = [_params(rng, name) for _ in range(P)]
    stacked = {}
    for k in params[0]:
        if isinstance(params[0][k], dict):
            stacked[k] = {n: _to_torch(np.stack([p[k][n] for p in params]))
                          for n in params[0][k]}
        else:
            stacked[k] = _to_torch([p[k] for p in params])[:, None]
    tobs = {k: _to_torch(v) for k, v in obs.items()}
    d = T.get_family(name).decide(stacked, T.PolicyObs(**tobs, dt=1.0))
    for i in range(P):
        one = {k: (v[i] if v.ndim == 2 and k not in ("lam", "gap_p99", "alive_tab", "tail_tab")
                   else v) for k, v in obs.items()}
        want = _jax_decide(name, params[i], one, 1.0)
        for w, g in zip(want, (d.create, d.retire, d.cold_hide)):
            g = (np.asarray(g, np.float32) * np.ones((P, F), np.float32))[i]
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=TINY)


def test_expiry_helpers_match_jax():
    rng = np.random.default_rng(7)
    obs = _obs(rng)
    lam = rng.uniform(1e-4, 3.0, F).astype(np.float32)
    for ka in (0.5, 60.0, 86_400.0 * 2):
        np.testing.assert_allclose(
            np.asarray(T.renewal_expiry_rate(_to_torch(lam), ka)),
            np.asarray(J.renewal_expiry_rate(jnp.asarray(lam), ka)), rtol=RTOL, atol=TINY)
    kas = [np.float32(300.0), np.float32(1e-5), np.float32(1e6),
           rng.uniform(1e-3, 9e4, F).astype(np.float32)]
    for ka in kas:
        want = np.asarray(J._interp_table(jnp.asarray(obs["alive_tab"]), jnp.asarray(ka)))
        got = T._interp_table(_to_torch(obs["alive_tab"]), _to_torch(ka))
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL, atol=TINY)
    # batched keepalives (P, 1) and (P, F) against per-point JAX calls
    for ka in (rng.uniform(1, 3000, (P, 1)), rng.uniform(1, 3000, (P, F))):
        got = np.asarray(T._interp_table(_to_torch(obs["tail_tab"]), _to_torch(ka)))
        for i in range(P):
            want = np.asarray(J._interp_table(jnp.asarray(obs["tail_tab"]),
                                              jnp.asarray(ka[i].astype(np.float32))))
            np.testing.assert_allclose(got[i], want * np.ones(F), rtol=RTOL, atol=TINY)
    oj = J.PolicyObs(**{k: jnp.asarray(v) for k, v in obs.items()}, dt=1.0)
    ot = T.PolicyObs(**{k: _to_torch(v) for k, v in obs.items()}, dt=1.0)
    np.testing.assert_allclose(np.asarray(T.empirical_expiry_rate(ot, _to_torch(450.0))),
                               np.asarray(J.empirical_expiry_rate(oj, jnp.float32(450.0))),
                               rtol=RTOL, atol=TINY)


def test_learned_keepalive_twin_matches_numpy():
    rng = np.random.default_rng(3)
    lam = np.concatenate([[0.0, 1e-12], np.exp(rng.uniform(-9, 3, F - 2))])
    thetas = []
    for seed in range(P):
        th = j_init_theta(seed)
        th["w2"] = rng.normal(0, 0.7, th["w2"].shape).astype(np.float32)
        th["b2"] = np.float32(rng.normal())
        thetas.append(th)
    for th in thetas:
        want = np_learned_keepalive(th, lam)
        got = T.learned_keepalive({k: _to_torch(v) for k, v in th.items()}, _to_torch(lam))
        np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL)
    stacked = {k: _to_torch(np.stack([th[k] for th in thetas])) for k in thetas[0]}
    got = np.asarray(T.learned_keepalive(stacked, _to_torch(lam)))
    assert got.shape == (P, F)
    for i, th in enumerate(thetas):
        np.testing.assert_allclose(got[i], np_learned_keepalive(th, lam), rtol=RTOL)
    # the untrained network is the 600 s keepalive, as in the JAX package
    np.testing.assert_allclose(
        np.asarray(T.learned_keepalive({k: _to_torch(v) for k, v in j_init_theta().items()},
                                       _to_torch(lam))), 600.0, rtol=1e-5)


BAD_POLICIES = [
    dict(),                                        # no family, no kind
    dict(family="nope"),
    dict(kind=0, keepalive_s=float("nan")),
    dict(kind=0, keepalive_s=0.5),                 # below the axis bound
    dict(kind=1, window_s=0.0),
    dict(kind=1, target=5.0),
    dict(kind=0, cc=0),
    dict(kind=2, prewarm_s=400.0),
    dict(family="spot_aware"),                     # spot axes missing
    dict(family="spot_aware", extra=dict(spot_fraction=1.5, hazard_per_hour=1.0)),
    dict(kind=3, theta={"w1": np.full(4, 2e3, np.float32), "b1": np.zeros(4, np.float32),
                        "w2": np.zeros(4, np.float32), "b2": np.float32(0)}),
]


@pytest.mark.parametrize("kw", BAD_POLICIES, ids=lambda kw: ",".join(f"{k}" for k in kw) or "empty")
def test_jax_policy_raises_where_jax_raises(kw):
    with pytest.raises((ValueError, KeyError)) as want:
        JPolicy(**kw)
    with pytest.raises(want.type):
        TPolicy(**kw)


def test_jax_policy_params_equal_jax():
    extra = dict(spot_fraction=0.25, hazard_per_hour=3.0)
    for kw in (dict(kind=0, keepalive_s=60), dict(kind=1, window_s=600, target=1.0),
               dict(kind=2, prewarm_s=1.5), dict(family="learned"),
               dict(family="spot_aware", extra=extra)):
        a, b = JPolicy(**kw), TPolicy(**kw)
        assert (a.family, a.kind) == (b.family, b.kind)
        pa, pb = a.params(), b.params()
        assert pa.keys() == pb.keys()
        for k in pa:
            if isinstance(pa[k], dict):
                for n in pa[k]:
                    np.testing.assert_array_equal(pa[k][n], pb[k][n])
            else:
                assert pa[k] == pb[k]
