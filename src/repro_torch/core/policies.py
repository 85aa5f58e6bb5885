"""Autoscaling policies — the paper's primary subject.

A copy of ``repro.core.policies`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Two families (paper §2.1) plus one beyond-paper baseline:

* ``SyncKeepalivePolicy`` (AWS-Lambda-like, §2.1.1): instance creation on the
  request critical path; idle instances retained for ``keepalive_s``.
* ``AsyncConcurrencyPolicy`` (Knative/GCR-like, §2.1.2): a dedicated
  autoscaler computes ``desired_f = ceil(avg_concurrency_f(window) /
  (utilization_target * container_concurrency))`` and reconciles.
* ``HybridHistogramPolicy`` (Shahrad'20, beyond-paper): per-function idle-time
  histogram decides a pre-warm delay + adaptive keepalive window.

Policies are deliberately tiny pure-state machines so the SAME object drives
(a) the discrete-event oracle, (b) the vectorized lax.scan simulator (via
their jnp twin in ``simjax``), and (c) the real JAX serving control plane.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PolicyDecision:
    create: int = 0            # instances to create now
    retire: int = 0            # idle instances to retire now


class Policy:
    """Per-function autoscaling policy instance."""

    #: synchronous policies gate request handling on instance creation
    synchronous: bool = False
    container_concurrency: int = 1

    def on_arrival(self, t: float, idle: int, busy_slots: int, starting: int,
                   queued: int) -> PolicyDecision:
        return PolicyDecision()

    def on_tick(self, t: float, concurrency: float, instances: int,
                starting: int, idle: int) -> PolicyDecision:
        return PolicyDecision()

    def keepalive(self, t: float) -> float:
        """How long an idle instance is retained."""
        return math.inf

    def on_idle_expired(self, t: float, idle_for: float) -> bool:
        """True -> tear the instance down."""
        return True


@dataclasses.dataclass
class SyncKeepalivePolicy(Policy):
    """Fixed-keepalive synchronous scaling (paper's Kn-Sync / AWS Lambda)."""
    keepalive_s: float = 600.0
    container_concurrency: int = 1
    synchronous: bool = True

    def __post_init__(self):
        Policy.__init__(self)

    def on_arrival(self, t, idle, busy_slots, starting, queued):
        # no free slot anywhere -> create exactly one instance for this request
        if idle == 0 and busy_slots == 0:
            return PolicyDecision(create=1)
        return PolicyDecision()

    def keepalive(self, t):
        return self.keepalive_s


@dataclasses.dataclass
class AsyncConcurrencyPolicy(Policy):
    """Knative KPA-style window-averaged concurrency scaling.

    desired = ceil(window_avg(concurrency) / (target * container_concurrency))
    Scale-down is damped by the window average itself (longer window = more
    inertia), mirroring Knative's stable mode; panic mode is disabled in the
    paper's setup and here.
    """
    window_s: float = 60.0
    target: float = 0.7
    container_concurrency: int = 1
    tick_s: float = 2.0
    synchronous: bool = False

    def __post_init__(self):
        Policy.__init__(self)
        n = max(1, int(round(self.window_s / self.tick_s)))
        self._buf: deque[float] = deque(maxlen=n)

    def on_tick(self, t, concurrency, instances, starting, idle):
        self._buf.append(concurrency)
        avg = sum(self._buf) / len(self._buf)
        desired = math.ceil(avg / (self.target * self.container_concurrency) - 1e-9)
        desired = max(desired, 0)
        have = instances + starting
        if desired > have:
            return PolicyDecision(create=desired - have)
        if desired < have:
            return PolicyDecision(retire=min(have - desired, idle))
        return PolicyDecision()

    def keepalive(self, t):
        return math.inf  # teardown is driven by on_tick retire decisions


@dataclasses.dataclass
class HybridHistogramPolicy(Policy):
    """Beyond-paper: Shahrad'20 hybrid histogram keepalive.

    Tracks the function's idle-time distribution; keeps instances warm for the
    99th percentile of observed idle times (within [min_s, max_s]).  Behaves
    like a short keepalive for chatty functions and avoids wasting memory on
    rarely-invoked ones.
    """
    min_s: float = 30.0
    max_s: float = 1800.0
    quantile: float = 0.99
    container_concurrency: int = 1
    synchronous: bool = True

    def __post_init__(self):
        Policy.__init__(self)
        self._idle_samples: deque[float] = deque(maxlen=256)
        self._last_arrival: Optional[float] = None

    def on_arrival(self, t, idle, busy_slots, starting, queued):
        if self._last_arrival is not None:
            self._idle_samples.append(t - self._last_arrival)
        self._last_arrival = t
        if idle == 0 and busy_slots == 0:
            return PolicyDecision(create=1)
        return PolicyDecision()

    def keepalive(self, t):
        if not self._idle_samples:
            return self.min_s
        q = float(np.quantile(np.asarray(self._idle_samples), self.quantile))
        return float(np.clip(q * 1.1, self.min_s, self.max_s))


# how far ahead the spot-aware policy insures against preemption: warm
# headroom covers the expected instance loss over roughly one node
# provision cycle (rebuilding evicted capacity takes provision_s ≫ cold
# start).  Shared by the oracle twin below and the traced
# ``policy_api.SpotAwareFamily`` so both engines compute identical headroom.
SPOT_HEADROOM_HORIZON_S = 120.0


@dataclasses.dataclass
class SpotAwarePolicy(SyncKeepalivePolicy):
    """Sync keepalive scaling that over-provisions warm headroom against
    spot preemption: each reconcile tick tops idle capacity up to the
    expected instance loss rate (instances x spot_fraction x hazard) over
    the headroom horizon, so an eviction lands on pre-warmed spares
    instead of a cold-start storm.  ``spot_fraction``/``hazard_per_hour``
    mirror the fleet tier actually purchased (the policy insures exactly
    the capacity at risk)."""
    spot_fraction: float = 0.0
    hazard_per_hour: float = 0.0

    def on_tick(self, t, concurrency, instances, starting, idle):
        target = int(round(instances * self.spot_fraction
                           * self.hazard_per_hour / 3600.0
                           * SPOT_HEADROOM_HORIZON_S))
        extra = max(target - idle - starting, 0)
        if extra > 0:
            return PolicyDecision(create=extra)
        return PolicyDecision()


# ---------------------------------------------------------------------------
# learned keepalive: the gradient-searched policy family
# ---------------------------------------------------------------------------
#
# A tiny MLP maps a function's observed arrival rate to its keepalive — the
# smooth, parameterized generalization of the hybrid histogram's rate->warmth
# heuristic.  The NETWORK lives here (numpy by default, jnp when the fluid
# simulator passes ``xp=jax.numpy``) so the oracle twin below and the traced
# ``repro.core.policy_api.LearnedKeepaliveFamily`` evaluate literally the
# same arithmetic; ``repro.opt.learned`` trains ``theta`` by ``jax.grad``
# through the chunked scan.

#: keepalive output range (log-interpolated by the network's sigmoid head)
LEARNED_KA_MIN_S = 20.0
LEARNED_KA_MAX_S = 1800.0
#: arrival-rate feature normalization: z = (ln lam - _F_MU) / _F_SD
_F_MU, _F_SD = -4.6, 3.0
_LEARNED_HIDDEN = 4


def init_theta(seed: int = 0) -> dict:
    """Deterministic init with a ZERO output layer: the untrained network
    emits exactly keepalive=600 s for every rate (the paper's default
    ladder point), so at init the learned family is bit-identical to a
    plain sync keepalive on BOTH engines and passes the parity gate before
    any training.  ``w2=0`` also zeroes the first-step gradient into
    ``w1``/``b1`` (standard zero-init-head trick); ``w2`` moves first and
    unfreezes them."""
    rng = np.random.default_rng(seed)
    h = _LEARNED_HIDDEN
    span = math.log(LEARNED_KA_MAX_S / LEARNED_KA_MIN_S)
    s0 = math.log(600.0 / LEARNED_KA_MIN_S) / span       # target sigmoid out
    return {
        "w1": (0.3 * rng.standard_normal(h)).astype(np.float32),
        "b1": np.zeros(h, np.float32),
        "w2": np.zeros(h, np.float32),
        "b2": np.float32(math.log(s0 / (1.0 - s0))),
    }


def learned_keepalive(theta, lam, xp=np):
    """Per-function keepalive from the arrival rate ``lam`` (scalar or (F,)).

    ka = KA_MIN * (KA_MAX/KA_MIN) ** sigmoid(MLP(z)),  z = (ln lam - mu)/sd

    ``xp`` selects the array namespace: numpy for the oracle / control plane,
    ``jax.numpy`` for the traced scan — one formula, two engines.
    """
    lam = xp.maximum(xp.asarray(lam, xp.float32), 1e-9)
    z = (xp.log(lam) - _F_MU) / _F_SD
    h = xp.tanh(z[..., None] * theta["w1"] + theta["b1"])
    u = h @ theta["w2"] + theta["b2"]
    s = 1.0 / (1.0 + xp.exp(-u))
    log_span = xp.log(LEARNED_KA_MAX_S / LEARNED_KA_MIN_S)
    return LEARNED_KA_MIN_S * xp.exp(s * log_span)


@dataclasses.dataclass
class LearnedKeepalivePolicy(Policy):
    """Oracle twin of the learned family: sync creation path, keepalive from
    the SAME network over the function's observed arrival rate.

    The rate estimate is arrivals-so-far over elapsed time with a one-minute
    prior window, which converges to the stationary mean the fluid engine
    feeds the network (``lam0``); the measurement window starts at T/2, so
    the early-estimate transient is excluded from parity metrics.
    """
    theta: Optional[dict] = None
    container_concurrency: int = 1
    synchronous: bool = True

    def __post_init__(self):
        Policy.__init__(self)
        if self.theta is None:
            self.theta = init_theta()
        self._arrivals = 0
        self._last_t = 0.0

    def _rate(self) -> float:
        return max(self._arrivals, 1) / max(self._last_t, 60.0)

    def on_arrival(self, t, idle, busy_slots, starting, queued):
        self._arrivals += 1
        self._last_t = max(self._last_t, t)
        if idle == 0 and busy_slots == 0:
            return PolicyDecision(create=1)
        return PolicyDecision()

    def keepalive(self, t):
        self._last_t = max(self._last_t, t)
        return float(learned_keepalive(self.theta, self._rate()))


def make_policy(name: str, **kw) -> Policy:
    return {
        "sync": SyncKeepalivePolicy,
        "async": AsyncConcurrencyPolicy,
        "hybrid": HybridHistogramPolicy,
        "learned": LearnedKeepalivePolicy,
        "spot_aware": SpotAwarePolicy,
    }[name](**kw)
