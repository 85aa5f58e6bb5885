"""Gradient-learned autoscaling policies through the differentiable fluid step.

The policy-as-pytree redesign makes the policy itself the optimization
variable: a family's ``learnable`` axes (e.g. the learned family's MLP
weight pytree ``theta``) ride the fluid engine's tick as leaves that require
grad, so the gradient of a scalar objective w.r.t. those leaves runs through
every simulated tick — the ROADMAP's "learned policies" item.

The objective is a SMOOTH SURROGATE of the frontier axes, not the frontier
metrics themselves: the reported p99 slowdown runs through a histogram
scatter-add and a host-side bisection (zero/undefined gradients), so
training minimizes

    loss = cost_per_million_proxy + w_lat * slowdown_proxy

where the cost proxy bills the run's node-seconds, master-CPU, billed
GB-s, idle-memory and completion sums through a ``repro_torch.fleet.billing``
profile (bitwise the old node+master repricing under ``ideal``; provider
profiles add the per-request / per-GB-s / warm-pool terms so training
optimizes the SAME dollars the frontier ranks on), and the slowdown proxy
replaces the per-function p99 with a differentiable tail estimate: per
function, 1 + (mean wait + delay-weighted mean wait + warm hop) / mean
duration, geometric-averaged with arrival weights.  The delay-weighted mean
(sum w*d^2 / sum w*d) up-weights exactly the long-delay mass that drives
the p99, without sorting.

Trained policies are CLAIMS until the oracle confirms them: ``confirm``
replays the trained configuration through the discrete-event oracle and
judges the standard parity band, reusing the same spot-check/demotion
contract the frontier engine applies to swept winners.

The port of ``repro.opt.learned``.  Where the JAX package takes
``jax.value_and_grad`` of a jitted ``lax.scan``, the port runs the engine's
eager step (``simtorch._make_step``) tick by tick with autograd recording
and takes ``torch.autograd.grad`` of the loss:

* the carried state is detached at every ``trunc_ticks`` boundary (the JAX
  loss's ``stop_gradient``), the four accumulators are not;
* the run ends at its last tick, where the JAX loss pads the last chunk with
  ticks of zero arrivals and zero weight: those add nothing to the loss or
  its gradient, as in the chunked engine;
* the warm-up ticks advance the state and add nothing to the sums (the JAX
  loss multiplies them by a zero mask);
* every ``jnp.minimum``/``jnp.maximum`` inside the differentiated function
  is ``torch.minimum``/``torch.maximum`` (``policy_api._min``/``_max``
  against a constant), which split a tie's gradient in half as JAX does.

Adam's state and update are float32 in ``_adam_update``'s order of
arithmetic.  Every entry point takes ``device=None`` (CUDA by default,
raising without it; the CPU only when named).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.eventsim import SimConfig
from repro_torch.core.policies import init_theta
from repro_torch.core.policy_api import _max, get_family
from repro_torch.core.runspec import RunSpec
from repro_torch.core.simtorch import (_PFLEET, F32, JaxPolicy, _arrivals_on,
                                       _init_state, _make_step, _prep_static,
                                       _upload)
from repro_torch.core.trace import Trace, gap_statistics, rate_matrix
from repro_torch.device import resolve_device
from repro_torch.fleet.billing import (BillingProfile, apply_throttle,
                                       resolve_profile)
from repro_torch.fleet.nodes import NodeType
from repro_torch.opt.search import default_fleet, evaluate_scenario
from repro_torch.scenarios.registry import get_scenario
from repro_torch.scenarios.runner import parity_report, run_scenario
from repro_torch.scenarios.spec import Scenario


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped nested dicts."""
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _tree_leaves(tree) -> list:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``_tree_leaves`` order)."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _point_leaf(x, device) -> torch.Tensor:
    """One params leaf as the engine reads a single policy point: float32 on
    ``device`` with a leading point axis ((1, 1) for a scalar knob, (1, h)
    for a weight vector).  A tensor that requires grad keeps its graph."""
    t = x if isinstance(x, torch.Tensor) \
        else torch.as_tensor(np.asarray(x, np.float32))
    t = t.to(device=device, dtype=F32)
    return t.reshape(1, 1) if t.dim() == 0 else t.unsqueeze(0)


def _detached(state: tuple) -> tuple:
    return tuple(x.detach() if isinstance(x, torch.Tensor) else x for x in state)


def make_loss(trace: Trace, policy: JaxPolicy, sim: SimConfig = SimConfig(),
              dt: float = 1.0, num_nodes: int = 8, fleet=None,
              warmup_frac: float = 0.5, w_lat: float = 4.0,
              trunc_ticks: int = 64, node_type: NodeType = NodeType(),
              billing: Union[str, BillingProfile, None] = None, *,
              device=None):
    """Build ``(loss_fn, params0)``: a scalar objective over the policy's
    params PYTREE (numbers, arrays or tensors; leaves that require grad are
    differentiated), differentiable w.r.t. every leaf (a learned family's
    weights, but equally a sync policy's ``keepalive_s`` — the
    gradient-correctness test differentiates exactly that).

    The loss runs the same tick as ``simulate_chunked``, with one addition:
    the carried state is detached at every ``trunc_ticks`` boundary
    (truncated backprop-through-time).  Full-horizon BPTT through this
    recurrence amplifies the adjoint by a few percent per tick — by ~100
    ticks the float32 cotangents overflow to NaN — while the policy's causal
    influence on cost/latency is concentrated well inside a minute;
    truncation keeps the gradient both finite and informative.  Per-tick
    statistics are accumulated as sums (no (T, F) histories).  The run
    happens on ``device`` (CUDA by default), where the trace's matrices are
    uploaded once."""
    dev = resolve_device(device)
    arr_np = rate_matrix(trace, dt)
    n_ticks, f = arr_np.shape
    trunc = max(1, min(int(trunc_ticks), n_ticks))
    arr = _arrivals_on(arr_np, dev)
    dur_np, mem_np, cold_ticks, wbuf, cpu_consts = _prep_static(trace, policy,
                                                                sim, dt)
    dur, mem = _upload(dur_np, dev), _upload(mem_np, dev)
    lam0 = _upload(arr_np.mean(axis=0) / dt, dev)
    gq, alive_tab, tail_tab = gap_statistics(trace)
    gaps = _upload(gq, dev)
    gap_tab = (_upload(alive_tab, dev), _upload(tail_tab, dev))
    has_fleet = fleet is not None
    prov_ticks = max(1, int(round((fleet.provision_s if has_fleet else 0.0)
                                  / dt)))
    fl = _upload([fleet.params() if has_fleet else np.zeros(len(_PFLEET))], dev)
    warm_tick = int(n_ticks * warmup_frac)
    # per-TIER node rates: the spot discount applies only to the run's spot
    # node-seconds (ys[12]), exactly as repro_torch.fleet.costs bills —
    # discounting the whole fleet would overstate any partial-spot savings
    prof = resolve_profile(billing)
    od_rate = node_type.price_per_hour
    spot_rate = od_rate * (1.0 - prof.spot_discount)
    billed_w = _upload(prof.billed_weights(trace.profile), dev)
    family = policy.family

    def loss_fn(params) -> torch.Tensor:
        pol = _tree_map(lambda x: _point_leaf(x, dev), params)
        step = _make_step(arr, dur, mem, billed_w, lam0, gaps, gap_tab, pol,
                          fl, cpu_consts, float(num_nodes), family=family,
                          dt=dt, cold_ticks=cold_ticks, wbuf=wbuf,
                          prov_ticks=prov_ticks, has_fleet=has_fleet)
        init_nodes = fl[:, :1] if has_fleet else float(num_nodes)
        st = _init_state(f, cold_ticks, wbuf, prov_ticks, init_nodes,
                         device=dev)
        a_tot = torch.zeros(1, f, dtype=F32, device=dev)
        d1, d2 = torch.zeros_like(a_tot), torch.zeros_like(a_tot)
        scalars = torch.zeros(1, 6, dtype=F32, device=dev)
        for t in range(n_ticks):
            if t % trunc == 0:
                st = _detached(st)                # truncated BPTT
            st, ys = step(st, t)
            if t < warm_tick:
                continue
            delay, arr_t, w = ys[0], ys[1], ys[2]
            scalars = scalars + torch.cat(
                [ys[10], ys[8], ys[11], ys[12], ys[13], ys[4] - ys[5]], 1)
            # ^ nodes, cpu_master, completed, spot nodes, billed GB-s,
            #   idle (warm-pool) MB
            a_tot = a_tot + arr_t
            d1 = d1 + w * delay
            d2 = d2 + w * delay * delay
        s = scalars[0]

        # $-cost proxy billed through the profile: node-seconds per tier
        # (weighted — serverless profiles zero the node axis), master CPU,
        # plus the provider terms (per-request fee, billed GB-s via
        # ys[13]'s analytic expectation, warm-pool GB-s from the idle
        # memory sum).  Under ``ideal`` every added term is x*0 and the
        # weight is 1.0, so the proxy is bitwise the old node+master math.
        node_seconds, master_s = s[0] * dt, s[1]
        spot_seconds = torch.minimum(s[3] * dt, node_seconds)
        completed = _max(s[2], 1.0)
        warm_gb_s = _max(s[5], 0.0) * dt / 1024.0
        cost = (((node_seconds - spot_seconds) / 3600.0 * od_rate
                 + spot_seconds / 3600.0 * spot_rate)
                * prof.node_hour_weight
                + master_s / 3600.0 * prof.master_vcpu_per_hour
                + prof.per_request * completed
                + prof.per_gb_s * s[4]
                + prof.warm_gb_s_rate * warm_gb_s)
        cost_per_million = cost / completed * 1e6
        # slowdown proxy: mean wait + delay-weighted mean wait per function
        mean_wait = d1[0] / _max(a_tot[0], 1e-9)
        tail_wait = d2[0] / _max(d1[0], 1e-9)
        slow = 1.0 + (mean_wait + tail_wait + sim.warm_latency_s) / dur
        wf = a_tot[0] / (a_tot[0] + 1.0)     # smooth min-request weighting
        slow_geo = torch.exp((wf * torch.log(slow)).sum()
                             / _max(wf.sum(), 1e-9))
        return cost_per_million + w_lat * slow_geo

    return loss_fn, policy.params()


def _value_and_grad(loss_fn, frozen: dict, theta: dict):
    """``(loss, grads)`` at ``theta`` (leaves that require grad), ``frozen``
    held: the loss as a Python float, the gradient tree like ``theta``."""
    loss = loss_fn({**frozen, **theta})
    grads = torch.autograd.grad(loss, _tree_leaves(theta))
    return float(loss.detach()), _tree_unflatten(theta, grads)


def _trainable(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device) \
        .clone().requires_grad_(True)


def _adam_update(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    with torch.no_grad():
        m = _tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, m, g)
        v = _tree_map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ * g_, v, g)

        def upd(m_, v_):
            mh = m_ / (1 - b1 ** t)
            vh = v_ / (1 - b2 ** t)
            return lr * mh / (torch.sqrt(vh) + eps)
        return _tree_map(upd, m, v), m, v


@dataclasses.dataclass
class TrainResult:
    policy: JaxPolicy            # the trained configuration
    scenario: str
    scale: float
    history: list                # loss per step
    wall_s: float

    def summary(self) -> dict:
        return {"scenario": self.scenario, "scale": self.scale,
                "steps": len(self.history) - 1,
                "loss_initial": self.history[0], "loss_final": self.history[-1],
                "wall_s": round(self.wall_s, 3)}


def train_policy(scenario: Union[str, Scenario], family: str = "learned",
                 scale: float = 0.25, steps: int = 80, lr: float = 0.05,
                 seed: int = 0, w_lat: float = 4.0,
                 sim: Optional[SimConfig] = None,
                 log: Optional[Callable[[str], None]] = None,
                 telemetry=None, *, device=None) -> TrainResult:
    """Train a policy family's learnable leaves on one scenario's workload
    by Adam over the surrogate loss's gradient, through the fluid step.

    Only the axes the family declares ``learnable`` move; sweepable scalar
    knobs stay at the spec's values (they belong to the frontier grid).
    ``telemetry`` (a ``repro_torch.obs.RunTelemetry``) receives the full
    training-loss series, one ``train_step`` event per gradient step.  The
    run happens on ``device`` (CUDA by default), resolved before the trace
    is built.
    """
    dev = resolve_device(device)
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    say = log or (lambda s: None)
    tel = telemetry.emit if telemetry is not None else (lambda *a, **k: None)
    fam = get_family(family)
    learnable = set(fam.learnable_axes())
    if not learnable:
        raise ValueError(f"policy family {family!r} declares no learnable "
                         f"axes; registered learnable families train here")
    sim = sim or SimConfig(tick_s=sc.policy.tick_s)
    # the learned family's weight pytree gets its deterministic init here;
    # other families' learnable axes start from the spec/extra values
    spec = dataclasses.replace(sc.policy, kind=family,
                               theta=init_theta(seed)
                               if "theta" in learnable else sc.policy.theta)
    policy = spec.to_jax()
    # train on the workload as the scenario's provider actually runs it
    # (cpu-throttled durations; identity under ``ideal``)
    trace = apply_throttle(sc.build_trace(scale), sc.billing)
    fleet = default_fleet(sc)
    loss_fn, params0 = make_loss(trace, policy, sim=sim, dt=sim.tick_s,
                                 fleet=fleet, w_lat=w_lat,
                                 billing=sc.billing, device=dev)

    frozen = {k: v for k, v in params0.items() if k not in learnable}
    theta = {k: _tree_map(lambda x: _trainable(x, dev), v)
             for k, v in params0.items() if k in learnable}

    t0 = time.time()
    m = _tree_map(torch.zeros_like, theta)
    v = _tree_map(torch.zeros_like, theta)
    history: list = []
    best, best_theta = float("inf"), theta
    for t in range(1, steps + 1):
        val, g = _value_and_grad(loss_fn, frozen, theta)  # loss AT theta
        history.append(val)
        tel("train_step", scenario=sc.name, step=t, loss=val)
        if val < best:
            best, best_theta = val, theta
        delta, m, v = _adam_update(g, m, v, t, lr)
        with torch.no_grad():
            theta = _tree_map(lambda p, d: (p - d).requires_grad_(True),
                              theta, delta)
        if t % max(1, steps // 5) == 0:
            say(f"train[{sc.name}] step {t}/{steps}: loss {val:.4f}")
    val, _ = _value_and_grad(loss_fn, frozen, theta)  # the final point races
    history.append(val)
    if val < best:
        best, best_theta = val, theta
    # write EVERY trained leaf back into the spec, whatever its axis name:
    # spec fields (theta, keepalive_s, ...) are replaced directly, novel
    # axes land in the ``extra`` mapping — a family is never silently
    # returned untrained because its learnable axis isn't called "theta"
    vals = {k: _tree_map(lambda x: x.detach().cpu().numpy(), v)
            for k, v in best_theta.items()}
    spec_fields = {f.name for f in dataclasses.fields(spec)}
    spec_map = {"cc": "container_concurrency"}
    rep, extra_new = {}, dict(spec.extra or {})
    for k, v in vals.items():
        fk = spec_map.get(k, k)
        if fk in spec_fields:
            rep[fk] = v
        else:
            extra_new[k] = v
    trained = dataclasses.replace(spec, extra=extra_new or None, **rep)
    return TrainResult(policy=trained.to_jax(), scenario=sc.name, scale=scale,
                       history=history, wall_s=time.time() - t0)


def refine_leaves(scenario: Union[str, Scenario], point: dict,
                  axes: Sequence[str], scale: float = 0.25, steps: int = 6,
                  lr: float = 0.08, w_lat: float = 4.0,
                  sim: Optional[SimConfig] = None,
                  billing: Union[str, BillingProfile, None] = None, *,
                  device=None) -> dict:
    """Gradient-refine the named CONTINUOUS policy axes of one searched
    point on one scenario: a few Adam steps over the gradient of the same
    surrogate loss ``train_policy`` minimizes, differentiating the scalar
    leaves (keepalive_s, target, prewarm_s, ...) instead of a weight
    pytree — the local-polish move the evo engine applies to elite
    individuals, reaching configurations BETWEEN any grid's rungs.

    Returns a new point dict: ``point`` with each refined axis replaced by
    its best-loss value, clipped into the family's declared AxisSpec
    bounds (so a refined elite is always re-evaluable).  Axes the pinned
    policy's params pytree does not carry are skipped; with nothing to
    refine the point is returned unchanged.  The run happens on ``device``
    (CUDA by default)."""
    from repro_torch.opt.search import point_scenario
    dev = resolve_device(device)
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    sc_pin = point_scenario(sc, point)
    fam = get_family(sc_pin.policy.kind)
    sim = sim or SimConfig(tick_s=sc_pin.policy.tick_s)
    prof = resolve_profile(billing, sc.billing)
    policy = sc_pin.policy.to_jax()
    fleet = default_fleet(sc_pin)
    fleet = dataclasses.replace(fleet, **{k: float(v)
                                          for k, v in point.items()
                                          if k in _PFLEET})
    trace = apply_throttle(sc_pin.build_trace(scale), prof)
    loss_fn, params0 = make_loss(trace, policy, sim=sim, dt=sim.tick_s,
                                 fleet=fleet, w_lat=w_lat, billing=prof,
                                 device=dev)
    live = [a for a in axes
            if a in params0 and np.ndim(params0[a]) == 0
            and a in fam.axis_names()]
    if not live:
        return dict(point)
    frozen = {k: v for k, v in params0.items() if k not in live}
    theta = {k: _trainable(params0[k], dev) for k in live}

    m = _tree_map(torch.zeros_like, theta)
    v = _tree_map(torch.zeros_like, theta)
    best, best_theta = float("inf"), theta

    def clip(th):
        # a gradient step must not leave the declared envelope: clip each
        # leaf into its AxisSpec bounds after every update
        return {k: torch.clamp(t, fam.axis(k).lo, fam.axis(k).hi)
                .requires_grad_(True) for k, t in th.items()}

    for t in range(1, steps + 1):
        val, g = _value_and_grad(loss_fn, frozen, theta)
        if val < best:
            best, best_theta = val, theta
        # relative step: the leaves live on wildly different scales
        # (keepalive in seconds vs target in [0, 4]), so Adam's unit step
        # is rescaled by each leaf's magnitude
        delta, m, v = _adam_update(g, m, v, t, lr)
        with torch.no_grad():
            theta = clip({k: theta[k] - delta[k] * torch.clamp(
                torch.abs(theta[k]), min=1.0) for k in theta})
    val, _ = _value_and_grad(loss_fn, frozen, theta)
    if val < best:
        best, best_theta = val, theta
    return {**point, **{k: float(np.clip(float(v_.detach()), fam.axis(k).lo,
                                         fam.axis(k).hi))
                        for k, v_ in best_theta.items()}}


def learned_scenario(sc: Scenario, result: TrainResult) -> Scenario:
    """The scenario re-specced to run the trained policy (both engines)."""
    pol = result.policy
    spec = dataclasses.replace(
        sc.policy, kind=pol.family, keepalive_s=pol.keepalive_s,
        window_s=pol.window_s, target=pol.target,
        container_concurrency=pol.cc, prewarm_s=pol.prewarm_s,
        theta=pol.theta, extra=pol.extra)
    return dataclasses.replace(sc, policy=spec)


def evaluate_trained(scenario: Union[str, Scenario], result: TrainResult,
                     scale: float = 1.0,
                     billing: Union[str, BillingProfile, None] = None, *,
                     device=None) -> dict:
    """One frontier-style metric row (cost, p99, memory, ...) for the
    trained policy at the given scale — comparable against swept rows
    billed on the same basis.  The run happens on ``device`` (CUDA by
    default)."""
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    return evaluate_scenario(learned_scenario(sc, result), [{}],
                             spec=RunSpec(scale=scale, billing=billing),
                             device=device)[0]


def confirm(scenario: Union[str, Scenario], result: TrainResult,
            scale: float = 0.25, tol: float = 0.15, *, device=None) -> dict:
    """Oracle spot-check of the trained policy: replay the learned
    configuration through BOTH engines and judge the parity band — the
    same trust gate swept frontier winners pass before being shipped.  The
    fluid leg runs on ``device`` (CUDA by default), the oracle on the
    host."""
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    rows = run_scenario(learned_scenario(sc, result),
                        spec=RunSpec(scale=scale, force_oracle=True),
                        device=device)
    gaps = parity_report(rows)
    ok = bool(gaps) and all(g <= tol for g in gaps.values())
    return {"scenario": sc.name, "scale": scale, "gaps": gaps, "pass": ok}
