"""Policy-as-pytree: the pluggable autoscaling-policy API, in torch.

The port of ``repro.core.policy_api``.  A policy FAMILY is a registered,
self-describing object: its declared axes (``AxisSpec``: bounds, sweepable
/ learnable flags), a pure ``decide(params, PolicyObs) -> JaxDecision`` step
that the fluid engine (``repro_torch.core.simtorch``) calls once a tick, an
``oracle_factory`` lowering the same spec to the discrete-event oracle's
per-function ``Policy`` objects, and the metadata the engine reads
(``synchronous_tail``, ``cold_factor``, ``uses_window``).

The port keeps its own registry, with the same five families and the same
metadata as the JAX package's.  ``decide`` takes torch tensors.  Where the
JAX engine vmaps a family over policy points, the port gives every tensor a
leading point axis P: the observation is (P, F), a scalar knob (P, 1), and a
weight leaf of the learned family (P, ...).  The same ``decide`` also takes
one point, with (F,) observations and 0-d knobs.  The arithmetic is the JAX
package's, in float32.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.policies import (_F_MU, _F_SD, LEARNED_KA_MAX_S,
                                       LEARNED_KA_MIN_S,
                                       SPOT_HEADROOM_HORIZON_S,
                                       AsyncConcurrencyPolicy,
                                       HybridHistogramPolicy,
                                       LearnedKeepalivePolicy, Policy,
                                       SpotAwarePolicy, SyncKeepalivePolicy,
                                       init_theta)
from repro_torch.core.trace import KA_GRID

# hybrid floor on the adaptive keepalive, mirroring HybridHistogramPolicy
# .min_s (its max_s cap maps to the ``keepalive_s`` axis)
HYBRID_MIN_KA_S = 30.0


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """One declared policy parameter: its bounds and its role.

    ``sweepable`` axes are grid axes the frontier engine may batch over;
    ``learnable`` axes are leaves that autograd trains through the engine.
    Bounds are validated at ``JaxPolicy`` construction and on every sweep
    point."""
    name: str
    lo: float
    hi: float
    sweepable: bool = True
    learnable: bool = False
    doc: str = ""


class PolicyObs(NamedTuple):
    """What one simulated tick shows a policy: (F,) tensors for one point,
    (P, F) for a batch of points (``lam`` and ``gap_p99`` may stay (F,) or
    (1, F); the two gap tables are (F, K) and shared by every point, or
    (P, F, K), one a row, as the cells layer gives them)."""
    arr: Any            # arrivals this tick
    queue: Any          # backlog after dispatch
    inst: Any           # warm instances
    pending: Any        # instances still cold-starting
    idle: Any           # integral idle count (async retire cap)
    idle_frac: Any      # expected fractional idle mass (sync expiry flux)
    free: Any           # free warm slots before this tick's dispatch
    avg: Any            # window-averaged concurrency
    demand: Any         # unserved demand requesting creation
    lam: Any            # long-run mean arrival rate per function
    gap_p99: Any        # empirical p99 inter-arrival gap per function
    alive_tab: Any      # (F, K) E[min(gap, KA_GRID[k])] per function
    tail_tab: Any       # (F, K) P(gap > KA_GRID[k]) per function
    dt: float           # tick length (static)


class JaxDecision(NamedTuple):
    """A policy step's output: instances to create / retire per function,
    plus how many seconds of the cold start the family hides (the hybrid's
    pre-warm lead; charged back as standing pre-warmed memory)."""
    create: Any
    retire: Any
    cold_hide: Any = 0.0


@functools.lru_cache(maxsize=None)
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    """A float32 0-d constant on ``device``, made once."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _max(x, c: float):
    """``jnp.maximum(x, c)``: a tie passes half the gradient to each side,
    as JAX's does (``torch.clamp`` would pass all of it)."""
    return torch.maximum(x, _scalar(c, x.device))


def _min(x, c: float):
    """``jnp.minimum(x, c)``, ties as in ``_max``."""
    return torch.minimum(x, _scalar(c, x.device))


def renewal_expiry_rate(lam_inst, ka, dt_cap: float = 60.0):
    """Fluid keepalive expiry, renewal-matched for Poisson gaps: rate
    lam/(e^{lam*ka}-1) per idle instance (the analytic reference of
    ``empirical_expiry_rate``)."""
    return lam_inst / torch.expm1(_min(lam_inst * ka, dt_cap))


_KA_GRID32 = KA_GRID.astype(np.float32)
_GRID_LO, _GRID_HI = float(_KA_GRID32[0]), float(_KA_GRID32[-1])


@functools.lru_cache(maxsize=None)
def _ka_grid(device: torch.device) -> torch.Tensor:
    """KA_GRID in float32 on ``device``, made once per device."""
    return torch.as_tensor(_KA_GRID32, device=device)


def _interp_weights(n_fn: int, ka, device):
    """The shared half of ``_interp_table``: the grid cell and the weight
    inside it of each function's keepalive, broadcast to (..., F)."""
    grid = _ka_grid(device)
    ka_c = _min(_max(ka, _GRID_LO), _GRID_HI)
    ka_c = ka_c.expand(torch.broadcast_shapes(ka_c.shape, (n_fn,))).contiguous()
    idx = torch.clamp(torch.searchsorted(grid, ka_c, right=True) - 1,
                      0, len(_KA_GRID32) - 2)
    idx1 = idx + 1
    w = (ka_c - grid[idx]) / (grid[idx1] - grid[idx])
    return idx.unsqueeze(-1), idx1.unsqueeze(-1), w


def _interp_at(tab, idx, idx1, w):
    rows = tab.expand(*idx.shape[:-1], tab.shape[-1])
    e0 = rows.gather(-1, idx).squeeze(-1)
    e1 = rows.gather(-1, idx1).squeeze(-1)
    return e0 + w * (e1 - e0)


def _interp_table(tab, ka):
    """Per-function linear interpolation of a (F, K) gap table over KA_GRID
    at the keepalive ``ka`` (0-d, (F,), (P, 1) or (P, F)); piecewise-linear,
    so the expiry flux stays differentiable w.r.t. the keepalive."""
    return _interp_at(tab, *_interp_weights(tab.shape[-2], ka, tab.device))


def empirical_expiry_rate(obs: PolicyObs, ka):
    """Fluid keepalive expiry matched to the EMPIRICAL gap distribution:
    r = P(gap > ka) / E[min(gap, ka)] per idle instance, both tables read
    at ka/inst (instance thinning).  See ``repro.core.policy_api``."""
    inst = _max(obs.inst, 1.0)
    ka_arg = ka / inst
    # both tables are read at the same keepalive: one grid lookup
    at = _interp_weights(obs.alive_tab.shape[-2], ka_arg, inst.device)
    e_alive = inst * _interp_at(obs.alive_tab, *at)
    p_tail = _interp_at(obs.tail_tab, *at)
    return p_tail / _max(e_alive, 1e-9)


#: ln(KA_MAX / KA_MIN) in float32, as the JAX engine computes it
_LOG_SPAN = float(np.log(np.float32(LEARNED_KA_MAX_S / LEARNED_KA_MIN_S)))


def learned_keepalive(theta: Mapping, lam):
    """The torch twin of ``repro_torch.core.policies.learned_keepalive``:

        ka = KA_MIN * (KA_MAX/KA_MIN) ** sigmoid(MLP(z)),  z = (ln lam - mu)/sd

    ``theta`` holds tensors: ``w1``, ``b1``, ``w2`` of shape (h,) and a 0-d
    ``b2`` for one point, or (P, h) and (P,) / (P, 1) for a batch, in which
    case ``lam`` (F,) or (1, F) gives (P, F).  (The numpy version's
    ``xp.asarray(lam, xp.float32)`` has no torch spelling.)"""
    lam = _max(lam.to(torch.float32), 1e-9)
    z = (torch.log(lam) - _F_MU) / _F_SD
    w1, b1, w2, b2 = theta["w1"], theta["b1"], theta["w2"], theta["b2"]
    if w1.dim() == 2:                        # a leading point axis
        w1, b1, w2 = w1[:, None, :], b1[:, None, :], w2[:, :, None]
        b2 = b2.reshape(-1, 1)
        h = torch.tanh(z[..., None] * w1 + b1)             # (P, F, h)
        u = torch.matmul(h, w2).squeeze(-1) + b2            # (P, F)
    else:
        h = torch.tanh(z[..., None] * w1 + b1)
        u = h @ w2 + b2
    s = 1.0 / (1.0 + torch.exp(-u))
    return LEARNED_KA_MIN_S * torch.exp(s * _LOG_SPAN)


class PolicyFamily:
    """Base class: metadata + the two lowering directions (torch decide,
    oracle factory).  Subclass and ``register_family`` to add a policy."""

    #: registry key (selects the decide branch)
    name: str = ""
    #: legacy integer id (``JaxPolicy.kind``); None for post-redesign families
    kind: Optional[int] = None
    #: per-request latency tails are iid (sync cold starts) rather than
    #: correlated backlog episodes — drives the finite-sample percentile
    #: correction in the slowdown estimator
    synchronous_tail: bool = True
    #: multiplier on the modelled cold-start wait (an async reconciler adds
    #: the reconcile-tick delay before the sandbox is even requested)
    cold_factor: float = 1.0
    #: reads the window-averaged concurrency: the engine carries a real
    #: window buffer (length window_s/dt) instead of a depth-1 stub
    uses_window: bool = False
    axes: Tuple[AxisSpec, ...] = ()

    # -- declarations ------------------------------------------------------

    def axis(self, name: str) -> AxisSpec:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(f"policy family {self.name!r} has no axis {name!r}")

    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def sweepable_axes(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes if a.sweepable)

    def learnable_axes(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes if a.learnable)

    # -- lowering ----------------------------------------------------------

    def init_params(self, policy) -> dict:
        """The params pytree for one ``JaxPolicy`` — {axis name: leaf}.
        Default: pull each declared axis off the policy's field of the same
        name, falling back to the policy's ``extra`` mapping."""
        out = {}
        extra = getattr(policy, "extra", None) or {}
        for a in self.axes:
            if hasattr(policy, a.name):
                out[a.name] = float(getattr(policy, a.name))
            elif a.name in extra:
                out[a.name] = float(extra[a.name])
            else:
                raise ValueError(
                    f"policy family {self.name!r}: no value for axis "
                    f"{a.name!r} — pass it via JaxPolicy(extra={{...}})")
        return out

    def decide(self, params: Mapping, obs: PolicyObs) -> JaxDecision:
        raise NotImplementedError

    def oracle_factory(self, spec) -> Callable[[int], Policy]:
        """Lower an engine-neutral ``PolicySpec`` to per-function oracle
        policy objects (the ``eventsim`` / ``control_plane`` side)."""
        raise NotImplementedError

    # -- validation --------------------------------------------------------

    def validate(self, params: Mapping) -> None:
        """Reject NaN / out-of-bounds leaves at construction time."""
        for a in self.axes:
            if a.name not in params:
                raise ValueError(f"policy family {self.name!r}: missing "
                                 f"param {a.name!r}")
            for leaf in _leaves(params[a.name]):
                vals = np.asarray(_numpy(leaf), np.float64)
                if not np.all(np.isfinite(vals)):
                    raise ValueError(
                        f"policy family {self.name!r}: non-finite value in "
                        f"param {a.name!r} ({vals!r})")
                if np.any(vals < a.lo) or np.any(vals > a.hi):
                    raise ValueError(
                        f"policy family {self.name!r}: param {a.name!r} out "
                        f"of bounds [{a.lo}, {a.hi}] (got {vals!r})")
        extra = set(params) - set(self.axis_names())
        if extra:
            raise ValueError(f"policy family {self.name!r}: unknown params "
                             f"{sorted(extra)}; declared axes are "
                             f"{sorted(self.axis_names())}")


def _numpy(leaf):
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf


def _leaves(x):
    if isinstance(x, Mapping):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


# every family shares the container-concurrency axis: the ENGINE reads it
# (slot capacity, memory packing), so ``register_family`` requires it
CC_AXIS = AxisSpec("cc", 1.0, 64.0, doc="container concurrency (slots per "
                   "instance; engine-level packing knob)")
_CC_AXIS = CC_AXIS


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_FAMILIES: dict[str, PolicyFamily] = {}
_BY_KIND: dict[int, PolicyFamily] = {}


def register_family(family: PolicyFamily) -> PolicyFamily:
    if not family.name:
        raise ValueError("policy family needs a name")
    if family.name in _FAMILIES:
        raise ValueError(f"duplicate policy family {family.name!r}")
    if "cc" not in family.axis_names():
        raise ValueError(
            f"policy family {family.name!r} must declare a 'cc' axis — the "
            f"engine reads params['cc'] for slot capacity and memory "
            f"packing (reuse policy_api.CC_AXIS)")
    _FAMILIES[family.name] = family
    if family.kind is not None:
        if family.kind in _BY_KIND:
            raise ValueError(f"duplicate legacy kind {family.kind}")
        _BY_KIND[family.kind] = family
    return family


def get_family(key: Union[str, int]) -> PolicyFamily:
    """Look a family up by registry name (or legacy integer kind)."""
    if isinstance(key, (int, np.integer)) and not isinstance(key, bool):
        try:
            return _BY_KIND[int(key)]
        except KeyError:
            raise KeyError(f"unknown policy kind {key}; registered kinds: "
                           f"{sorted(_BY_KIND)}") from None
    try:
        return _FAMILIES[key]
    except KeyError:
        raise KeyError(f"unknown policy family {key!r}; registered: "
                       f"{sorted(_FAMILIES)}") from None


def list_families() -> list[str]:
    return sorted(_FAMILIES)


def sweepable_policy_axes() -> set:
    """Union of every registered family's sweepable axes."""
    out: set = set()
    for fam in _FAMILIES.values():
        out |= set(fam.sweepable_axes())
    return out


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------


class SyncKeepaliveFamily(PolicyFamily):
    """AWS-Lambda-like (paper §2.1.1): create on the request critical path,
    retire idle instances by the renewal-matched keepalive expiry flux."""
    name = "sync"
    kind = 0
    synchronous_tail = True
    axes = (AxisSpec("keepalive_s", 1.0, 86_400.0,
                     doc="idle-instance retention"), _CC_AXIS)

    def _ka_eff(self, params, obs):
        return params["keepalive_s"]

    def decide(self, params, obs):
        ka_eff = self._ka_eff(params, obs)
        r = empirical_expiry_rate(obs, ka_eff)
        # survival form of the expiry flux: saturates at the idle mass
        retire = obs.idle_frac * -torch.expm1(-r * obs.dt)
        return JaxDecision(create=obs.demand, retire=retire)

    def oracle_factory(self, spec):
        return lambda f: SyncKeepalivePolicy(
            keepalive_s=spec.keepalive_s,
            container_concurrency=spec.container_concurrency)


class AsyncWindowFamily(PolicyFamily):
    """Knative-KPA-like (paper §2.1.2): reconcile instance count to
    ceil(window_avg(concurrency) / (target * cc)) each tick."""
    name = "async"
    kind = 1
    synchronous_tail = False     # backlog episodes correlate request tails
    cold_factor = 1.5            # reconcile tick precedes the sandbox request
    uses_window = True
    axes = (AxisSpec("target", 0.05, 4.0, doc="utilization target"), _CC_AXIS)

    def decide(self, params, obs):
        desired = torch.ceil(obs.avg / (params["target"] * params["cc"]) - 1e-9)
        have = obs.inst + obs.pending
        create = _max(desired - have, 0.0)
        retire = torch.minimum(_max(have - desired, 0.0), obs.idle)
        return JaxDecision(create=create, retire=retire)

    def oracle_factory(self, spec):
        return lambda f: AsyncConcurrencyPolicy(
            window_s=spec.window_s, target=spec.target,
            container_concurrency=spec.container_concurrency,
            tick_s=spec.tick_s)


class HybridHistogramFamily(SyncKeepaliveFamily):
    """Shahrad'20 hybrid histogram: keepalive ~ 1.1 x the p99 of the
    function's idle gap (clipped to [HYBRID_MIN_KA_S, keepalive_s]) plus a
    pre-warm lead that hides part of the cold start."""
    name = "hybrid"
    kind = 2
    axes = (AxisSpec("keepalive_s", 1.0, 86_400.0,
                     doc="cap on the adaptive keepalive (maps to max_s)"),
            _CC_AXIS,
            AxisSpec("prewarm_s", 0.0, 300.0, doc="pre-warm lead"))

    def _ka_eff(self, params, obs):
        return torch.minimum(_max(1.1 * obs.gap_p99, HYBRID_MIN_KA_S),
                             params["keepalive_s"])

    def decide(self, params, obs):
        base = super().decide(params, obs)
        return base._replace(cold_hide=params["prewarm_s"])

    def oracle_factory(self, spec):
        return lambda f: HybridHistogramPolicy(
            max_s=spec.keepalive_s,
            container_concurrency=spec.container_concurrency)


class LearnedKeepaliveFamily(SyncKeepaliveFamily):
    """Per-function adaptive keepalive as a tiny MLP over the observed
    arrival rate (``learned_keepalive``); ``theta`` is a learnable leaf."""
    name = "learned"
    kind = 3
    axes = (_CC_AXIS,
            AxisSpec("theta", -1e3, 1e3, sweepable=False, learnable=True,
                     doc="MLP weights: per-function keepalive from rate"))

    def init_params(self, policy) -> dict:
        theta = policy.theta if policy.theta is not None else init_theta()
        return {"cc": float(policy.cc), "theta": theta}

    def _ka_eff(self, params, obs):
        return learned_keepalive(params["theta"], obs.lam)

    def oracle_factory(self, spec):
        theta = getattr(spec, "theta", None)
        return lambda f: LearnedKeepalivePolicy(
            theta=theta, container_concurrency=spec.container_concurrency)


class SpotAwareFamily(SyncKeepaliveFamily):
    """Sync keepalive scaling for a fleet buying ``spot_fraction`` of its
    nodes on a preemptible tier with ``hazard_per_hour`` reclaims per
    node-hour: the engine reads the two spot axes, and the policy tops idle
    capacity up to the expected eviction loss over
    ``SPOT_HEADROOM_HORIZON_S``, in whole instances."""
    name = "spot_aware"
    kind = None                      # post-redesign family: no legacy id
    axes = (AxisSpec("keepalive_s", 1.0, 86_400.0,
                     doc="idle-instance retention"), _CC_AXIS,
            AxisSpec("spot_fraction", 0.0, 1.0,
                     doc="share of the node fleet bought on the spot tier"),
            AxisSpec("hazard_per_hour", 0.0, 60.0,
                     doc="spot preemption rate (reclaims per node-hour)"))

    def decide(self, params, obs):
        base = super().decide(params, obs)
        target = torch.round(obs.inst * params["spot_fraction"]
                             * params["hazard_per_hour"] / 3600.0
                             * SPOT_HEADROOM_HORIZON_S)
        extra = _max(target - obs.idle - obs.pending, 0.0)
        return base._replace(create=base.create + extra)

    def oracle_factory(self, spec):
        extra = dict(getattr(spec, "extra", None) or {})
        sf = float(extra.get("spot_fraction", 0.0))
        hz = float(extra.get("hazard_per_hour", 0.0))
        return lambda f: SpotAwarePolicy(
            keepalive_s=spec.keepalive_s,
            container_concurrency=spec.container_concurrency,
            spot_fraction=sf, hazard_per_hour=hz)


register_family(SyncKeepaliveFamily())
register_family(AsyncWindowFamily())
register_family(HybridHistogramFamily())
register_family(LearnedKeepaliveFamily())
register_family(SpotAwareFamily())

__all__ = ["AxisSpec", "PolicyObs", "JaxDecision", "PolicyFamily", "CC_AXIS",
           "HYBRID_MIN_KA_S", "renewal_expiry_rate", "empirical_expiry_rate",
           "learned_keepalive", "register_family", "get_family",
           "list_families", "sweepable_policy_axes"]
