"""Vectorized cluster simulator: the whole fleet, one tick at a time, in torch.

The port of ``repro.core.simjax`` (the fluid engine behind every paper
figure, scenario, frontier search and learned policy).  The step math is the
JAX package's, in float32, and so are the public names: ``JaxPolicy``,
``JaxFleet``, ``JaxSimResult``, ``JaxDecision``, ``stack_params``,
``simulate``, ``summarize`` and ``simulate_chunked``.  They keep their names
so that the layers built on this engine (scenarios, cells, the optimizer)
port line for line.

Where the JAX engine compiles one ``lax.scan`` and vmaps it over policy
points, the port runs the tick eagerly in a Python loop over a leading point
axis P:

* per-function state is (P, F), the cold-start pipeline (P, F, cold_ticks)
  and the concurrency window (P, F, wbuf); the node fleet's scalars are
  (P, 1) and its provisioning pipelines (P, prov_ticks);
* a scalar policy knob is a (P, 1) tensor, the learned family's weights
  carry a leading point axis, and the fleet vector is (P, 7) (``_PFLEET``);
* everything that depends on the tick only (the window slot, the warm-up
  and measurement masks, the telemetry slot) is a Python int, so nothing in
  the tick loop reads a tensor back to the host.

Within a time chunk the summary sums are float32; across chunks they are
float64 on the device, as the JAX host loop adds each chunk's float32
partials into float64 numpy accumulators.  A run is read back once.

The step writes no tensor in place (the window ring is rebuilt each tick),
so autograd can differentiate through it: the learned policy's training
(ROADMAP Queue 1 item 10) takes this engine's gradient.  The chunk's
histogram and telemetry slots lie outside the step and take their adds in
place; those adds stay differentiable, as their backward reads no input.

Entry points take ``device=None`` and then run on CUDA, raising without
it; the CPU runs only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.eventsim import SimConfig
from repro_torch.core.policy_api import (HYBRID_MIN_KA_S, JaxDecision,  # noqa: F401
                                         PolicyObs, _max, _min, get_family)
from repro_torch.core.trace import Trace, gap_statistics, rate_matrix
from repro_torch.device import resolve_device
from repro_torch.obs.telemetry import TELEM_ATTR, TELEM_SERIES, assemble_telemetry

F32 = torch.float32

# XLA's float32 arithmetic flushes subnormal results to zero (on the CPU, the
# GPU and the TPU alike); torch's kernels keep them.  Where that changes the
# dynamics, the step flushes as XLA does:
# * the service flux in_service * dt / dur: flushed, it stops the decay of a
#   function's in-flight mass at a tiny normal value, whose ceil keeps one
#   instance busy — the JAX engine's async policies never retire that last
#   instance, and the port must not either;
# * in_service / cc, whose ceil is the integral busy count;
# * the tick's creates, which the delay estimator tests for ``> 0``.
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _ftz(x):
    """Non-negative ``x`` with its subnormal values flushed to zero.  As in
    XLA, the flush touches values only: under autograd the gradient passes
    as through the identity (``jnp.maximum``'s half-gradient at a tie of
    zeros reaches the creates, for one)."""
    if x.requires_grad:
        return x - torch.where(x < _FLT_MIN, x, 0.0).detach()
    return torch.where(x < _FLT_MIN, 0.0, x)


@dataclasses.dataclass(frozen=True)
class JaxPolicy:
    """One policy configuration: a registered FAMILY plus its params.

    ``family`` names a ``repro_torch.core.policy_api`` registry entry
    ("sync", "async", "hybrid", "learned", "spot_aware"); the legacy integer
    ``kind`` is kept as an alias (0/1/2/3) and either selector may be given.
    ``params()`` lowers the declared axes to the params pytree the engine
    consumes.  Only ``family`` and ``window_s`` (the window buffer depth)
    are structural.  Knob values are validated against the family's
    declared bounds at construction."""
    kind: int = -1
    keepalive_s: float = 600.0
    window_s: float = 60.0
    target: float = 0.7
    cc: int = 1
    prewarm_s: float = 0.0
    family: str = ""
    theta: Any = None          # learnable pytree (learned family)
    extra: Any = None          # {axis: value} for axes beyond these fields

    def __post_init__(self):
        if not self.family:
            if self.kind < 0:
                raise ValueError("JaxPolicy needs a family name or a "
                                 "legacy kind")
            object.__setattr__(self, "family", get_family(self.kind).name)
        fam = get_family(self.family)      # raises KeyError on unknown names
        if fam.kind is not None:
            object.__setattr__(self, "kind", fam.kind)
        for nm in ("keepalive_s", "window_s", "target", "cc", "prewarm_s"):
            if not np.isfinite(float(getattr(self, nm))):
                raise ValueError(f"JaxPolicy.{nm} is not finite: "
                                 f"{getattr(self, nm)!r}")
        if self.window_s <= 0:
            raise ValueError(f"JaxPolicy.window_s must be > 0, got "
                             f"{self.window_s!r}")
        fam.validate(self.params())

    def params(self) -> dict:
        """The params pytree ({axis name: leaf}), as numpy / Python values."""
        return get_family(self.family).init_params(self)


@dataclasses.dataclass(frozen=True)
class JaxFleet:
    """Node-fleet layer parameters (mirrors UtilizationFleetPolicy +
    NodeFleet).  ``provision_s`` is structural (pipeline depth); the rest
    ride the (P, 7) fleet vector.  ``reclaim_notice_s`` acts only when the
    policy family declares the spot axes."""
    node_memory_mb: float = 192_000.0
    provision_s: float = 60.0
    min_nodes: float = 1.0
    max_nodes: float = 64.0
    util_target: float = 0.7
    warm_frac: float = 0.25
    cooldown_s: float = 120.0
    reclaim_notice_s: float = 120.0

    def params(self) -> np.ndarray:
        """The parameter vector (see _PFLEET indices)."""
        return np.asarray([self.min_nodes, self.max_nodes, self.util_target,
                           self.warm_frac, self.cooldown_s,
                           self.node_memory_mb, self.reclaim_notice_s],
                          np.float32)


# fleet parameter vector layout
_PFLEET = ("min_nodes", "max_nodes", "util_target", "warm_frac",
           "cooldown_s", "node_memory_mb", "reclaim_notice_s")


def _init_state(f, cold_ticks, wbuf, prov_ticks, init_nodes, *, points: int = 1,
                device=None):
    """The engine's state for ``points`` policy points; ``init_nodes`` is a
    number or a (P, 1) tensor.  The four trailing leaves are the spot tier
    (node count, provisioning pipeline, instance mass resident on spot
    capacity, evicted-warm deficit); they stay zero unless the policy family
    declares the spot axes.  The window cursor is a Python int."""
    def z(*shape):
        return torch.zeros(*shape, dtype=F32, device=device)
    return (z(points, f), z(points, f), z(points, f),
            z(points, f, cold_ticks), z(points, f, wbuf), 0,
            init_nodes * torch.ones(points, 1, dtype=F32, device=device),
            z(points, prov_ticks), z(points, 1), z(points, 1),
            z(points, prov_ticks), z(points, f), z(points, f))


def _make_step(arrivals, dur, mem, billed_w, lam0, gaps, gap_tab, pol, fleet,
               cpu_consts,
               static_nodes, *, family: str, dt: float, cold_ticks: int,
               wbuf: int, prov_ticks: int, has_fleet: bool,
               telem: bool = False, weights=None):
    """One simulated tick for every policy point, shared by the
    full-history loop (``_sim_impl``) and the chunked-summary loop
    (``_chunk_impl``) so the policy math exists once.

    ``arrivals`` is the (T, F) float32 count matrix on the device and the
    step's ``tick`` a Python int row of it; ``dur``, ``mem``, ``billed_w``,
    ``lam0`` and ``gaps`` are (F,), ``gap_tab`` the two (F, K) tables,
    ``pol`` the params tree with a leading point axis ((P, 1) knobs),
    ``fleet`` (P, 7), ``cpu_consts`` and ``static_nodes`` Python floats.
    ``weights`` (F,) is the super-function multiplicity of a clustered
    trace: every cross-function sum is weighted by it (``None`` emits the
    unweighted ops).  See ``repro.core.simjax._make_step`` for the model."""
    f = dur.shape[0]
    points = fleet.shape[0]
    dev = dur.device
    fam = get_family(family)
    ccf = pol["cc"]
    has_spot = has_fleet and "spot_fraction" in pol

    def ws(v):
        return v if weights is None else v * weights

    def fsum(v):                       # weighted sum over functions -> (P, 1)
        return ws(v).sum(-1, keepdim=True)

    def x_dt(v):                       # v * dt (exact to skip at dt = 1)
        return v if dt == 1.0 else v * dt

    # per-run constants: the same float32 values the JAX step recomputes
    # every tick
    omc = 1.0 - 1.0 / ccf                       # (1 - 1/cc) of the packing
    dmin = _min(dur / dt, 1.0)
    nvalid = torch.arange(1, wbuf + 1, dtype=F32, device=dev)
    zeros_pf = torch.zeros(points, f, dtype=F32, device=dev)
    zeros_p1 = torch.zeros(points, 1, dtype=F32, device=dev)
    (c_cw, c_cm, c_tw, c_tm, c_rq, c_idle, c_wfloor_node, c_mfloor) = cpu_consts
    if has_fleet:
        min_n, max_n, util_t, warm_f, cool_s, node_mem = (
            fleet[:, i:i + 1] for i in range(6))
        unit = util_t * node_mem
        cool_reset = torch.ceil(cool_s / dt)
    else:
        static_billed = torch.full((points, 1), float(static_nodes), dtype=F32,
                                   device=dev)
        wfloor = c_wfloor_node * static_billed * dt
    if has_spot:
        notice = fleet[:, 6:7]
        hazard = pol["hazard_per_hour"] / torch.full((), 3600.0, dtype=F32, device=dev)
        h_tick = -torch.expm1(-hazard * dt)
        survive = torch.exp(-notice / dur)          # work outliving the notice
        lam_drain = -torch.expm1(-lam0 * dt)
        overshoot = 1.0 + lam0 * cold_ticks * dt

    def shift(pipe):                   # drop slot 0, append an empty slot
        return torch.cat([pipe[..., 1:], torch.zeros_like(pipe[..., :1])], -1)

    def add_last(pipe, v):             # pipe[..., -1:] += v (the slot is empty)
        return torch.cat([pipe[..., :-1], v], -1)

    def step(state, tick):
        (inst, in_service, queue, starting, win, wcur,
         nodes, pipe, cool, nodes_spot, pipe_spot, spot_inst,
         evict_deficit) = state
        arr = arrivals[tick]

        if has_fleet:
            # provisioning completes
            nodes = nodes + pipe[:, :1]
            pipe = shift(pipe)
            if has_spot:
                nodes_spot = nodes_spot + pipe_spot[:, :1]
                pipe_spot = shift(pipe_spot)

        # instances finishing cold start
        inst = inst + starting[..., 0]
        starting = None if cold_ticks == 1 else shift(starting)

        # dispatch + fluid service (within-tick slot turnover credited)
        slots = inst * ccf
        turnover = torch.minimum(_ftz(x_dt(in_service) / dur), in_service)
        free = _max(slots - in_service, 0.0)
        qa = queue + arr
        dispatch = torch.minimum(qa, free + turnover)
        arr_delayed = arr - _max(dispatch - queue, 0.0)
        in_service = in_service + dispatch
        queue = qa - dispatch
        completions = torch.minimum(_ftz(x_dt(in_service) / dur), in_service)
        in_service = in_service - completions

        # busy memory: expected busy instances over the tick, packed at cc
        served_avg = in_service + completions * dmin
        packed = served_avg / ccf - omc * torch.expm1(-served_avg)
        busy_inst = torch.minimum(inst, packed)
        # expected (fractional) and integral idle views
        ipc = _ftz(in_service / ccf)
        idle_frac = _max(inst - torch.minimum(inst, ipc), 0.0)
        idle = _max(inst - torch.minimum(inst, torch.ceil(ipc)), 0.0)
        concurrency = in_service + queue

        # ---- instance-level policy: registry dispatch ----
        if wbuf > 1:
            slot = wcur % wbuf
            win = torch.cat([win[..., :slot], concurrency.unsqueeze(-1),
                             win[..., slot + 1:]], -1)
            avg = win.sum(-1) / nvalid[min(wcur, wbuf - 1)]
        else:
            # a depth-1 window's mean is the tick's concurrency
            avg = concurrency

        # with one cold-start tick the pipeline is empty after the shift
        pending = zeros_pf if starting is None else starting.sum(-1)
        if has_fleet:
            # queued demand not already covered by in-flight cold starts
            demand = _max(queue if starting is None
                                     else queue - pending * ccf, 0.0)
        else:
            demand = _max(arr - (free if starting is None
                                            else free + pending), 0.0)
        obs = PolicyObs(arr=arr, queue=queue, inst=inst, pending=pending,
                        idle=idle, idle_frac=idle_frac, free=free, avg=avg,
                        demand=demand, lam=lam0, gap_p99=gaps,
                        alive_tab=gap_tab[0], tail_tab=gap_tab[1], dt=dt)
        dec = fam.decide(pol, obs)
        create, retire = dec.create, dec.retire

        inst = inst - retire

        def with_create(starting, create):
            """The pipeline with this tick's creates in its last slot, and
            its total (the instances still starting)."""
            if starting is None:
                return create.unsqueeze(-1), create
            starting = add_last(starting, create.unsqueeze(-1))
            return starting, starting.sum(-1)

        # ---- node-fleet layer ----
        killed = None
        if has_fleet:
            if has_spot:
                # spot eviction flux (see repro.core.simjax._make_step)
                evict = nodes_spot * h_tick
                spot_inst = spot_inst * _min(_max(
                    1.0 - retire / _max(inst + retire, 1e-9), 0.0), 1.0)
                spot_inst = torch.minimum(spot_inst, inst)
                killed = spot_inst * h_tick
                spot_inst = spot_inst - killed
                inst = inst - killed
                evict_frac = killed / _max(inst + killed, 1e-9)
                requeue = in_service * evict_frac * survive
                in_service = in_service - requeue
                queue = queue + requeue
                pool = evict_deficit + killed
                a = _ftz(in_service / ccf)
                free_cond = _max(inst + pool - 1.0 + pending - a, 0.0)
                p_need = (a / (1.0 + a)) ** free_cond
                drain = pool * lam_drain
                rec = drain * p_need
                evict_deficit = pool - rec
                evict_rec = rec * overshoot
                create = create + evict_rec
                nodes_spot = nodes_spot - evict
                evict_bill = evict * notice / dt
                capacity_mb = (nodes + nodes_spot) * node_mem
            else:
                capacity_mb = nodes * node_mem

            committed = fsum((inst if starting is None else inst + pending) * mem)
            free_mb = _max(capacity_mb - committed, 0.0)
            req_mb = fsum(create * mem)
            scale = _min(free_mb / _max(req_mb, 1e-9), 1.0)
            create = _ftz(create * scale)
            starting, pending = with_create(starting, create)
            if has_spot:
                cap_share = nodes_spot / _max(nodes + nodes_spot, 1e-9)
                spot_inst = spot_inst + create * cap_share

            # reconcile: used memory plus unplaceable pressure -> nodes
            used = fsum((inst + pending) * mem)
            pressure = _max(req_mb * (1.0 - scale), 0.0)
            needed = torch.ceil((used + pressure) / unit - 1e-9)
            warm = torch.ceil(warm_f * _max(needed, 1.0) - 1e-9)
            desired_n = torch.minimum(torch.maximum(needed + warm, min_n), max_n)
            if has_spot:
                desired_spot = torch.round(desired_n * pol["spot_fraction"])
                desired_od = desired_n - desired_spot
            else:
                desired_od = desired_n
            have_od = nodes + pipe.sum(-1, keepdim=True)
            pipe = add_last(pipe, _max(desired_od - have_od, 0.0))
            down_want = _max(have_od - desired_od, 0.0)
            up_nodes = nodes + nodes_spot if has_spot else nodes
            max_down = _max(up_nodes - torch.ceil(used / node_mem), 0.0)
            gate = cool <= 0.0
            if has_spot:
                have_spot = nodes_spot + pipe_spot.sum(-1, keepdim=True)
                pipe_spot = add_last(pipe_spot,
                                     _max(desired_spot - have_spot, 0.0))
                down_want_spot = _max(have_spot - desired_spot, 0.0)
                down_spot = torch.where(gate, torch.minimum(
                    torch.minimum(down_want_spot, max_down), nodes_spot), 0.0)
                down = torch.where(gate, torch.minimum(
                    torch.minimum(down_want, max_down - down_spot), nodes), 0.0)
                nodes_spot = nodes_spot - down_spot
                down_all = down + down_spot
            else:
                down = torch.where(gate, torch.minimum(
                    torch.minimum(down_want, max_down), nodes), 0.0)
                down_all = down
            nodes = nodes - down
            cool = torch.where(down_all > 0.0, cool_reset,
                               _max(cool - 1.0, 0.0))
            if has_spot:
                spot_pipe = pipe_spot.sum(-1, keepdim=True)
                nodes_billed = nodes + nodes_spot + pipe.sum(-1, keepdim=True) \
                    + spot_pipe + evict_bill
                spot_billed = nodes_spot + spot_pipe + evict_bill
            else:
                nodes_billed = nodes + pipe.sum(-1, keepdim=True)
                spot_billed = zeros_p1
        else:
            create = _ftz(create)
            starting, pending = with_create(starting, create)
            nodes_billed = static_billed
            spot_billed = zeros_p1

        # queue-delay estimator for this tick's delayed arrivals
        future_slots = (inst + pending) * ccf
        drain = _max(future_slots / dur, 1e-6)
        prewarm_hide = dec.cold_hide
        if isinstance(prewarm_hide, torch.Tensor):
            cold_full = _max(
                fam.cold_factor * cold_ticks * dt - prewarm_hide, 0.0)
            cold_empty = _max(2.0 * cold_ticks * dt - prewarm_hide, 0.0)
            cold_wait = torch.where(pending > 0, cold_full, torch.where(
                future_slots < 0.5, cold_empty, zeros_p1))
        else:
            cold_full = max(fam.cold_factor * cold_ticks * dt - prewarm_hide, 0.0)
            cold_empty = max(2.0 * cold_ticks * dt - prewarm_hide, 0.0)
            cold_wait = torch.where(pending > 0, cold_full, torch.where(
                future_slots < 0.5, cold_empty, 0.0))
        queue_pos = _max(queue - 0.5 * arr_delayed, 0.0)
        delay = queue_pos / drain + cold_wait

        # eviction-drained instances cost teardown CPU like a policy retire
        teard = fsum(retire) + fsum(killed) if has_spot else fsum(retire)
        create_sum = fsum(create)
        idle_cpu = fsum(idle) * c_idle * dt
        if has_fleet:
            wfloor_t = c_wfloor_node * nodes_billed * dt
        else:
            wfloor_t = wfloor
        cpu_worker = create_sum * c_cw + teard * c_tw + idle_cpu + wfloor_t
        cpu_master = create_sum * c_cm + teard * c_tm \
            + fsum(dispatch) * c_rq + c_mfloor * dt
        useful = fsum(completions * dur)

        # allocated memory counts still-starting sandboxes and the hybrid's
        # standing pre-warmed mass (creations/s x prewarm_s)
        mem_total = fsum((inst + pending) * mem)
        if isinstance(prewarm_hide, torch.Tensor):
            prewarm_mass = fsum(create * mem) * prewarm_hide / dt
            mem_total = mem_total + prewarm_mass
        else:
            prewarm_mass = None        # 0 x a finite sum: adds nothing
        ys = (delay, arr, arr_delayed, fsum(inst), mem_total,
              fsum(busy_inst * mem),
              create_sum, cpu_worker, cpu_master, useful, nodes_billed,
              fsum(completions), spot_billed, fsum(completions * billed_w))
        if telem:
            # ys[14]: the TELEM_SERIES vector, ys[15]: the TELEM_ATTR vector
            # (repro.obs.telemetry; see repro.core.simjax._make_step)
            if has_spot:
                ev_create = fsum(evict_rec * scale)
                ev_kill = fsum(killed)
                cpu_creation = (create_sum - ev_create) * (c_cw + c_cm)
            else:
                ev_create = ev_kill = zeros_p1
                cpu_creation = create_sum * (c_cw + c_cm)
            cpu_evict = ev_create * (c_cw + c_cm)
            mem_pipe = fsum(pending * mem)
            if prewarm_mass is not None:
                mem_pipe = mem_pipe + prewarm_mass
            tser = torch.cat([
                fsum(inst), fsum(busy_inst), fsum(queue),
                create_sum, ev_kill, ys[4], ys[5], mem_pipe, nodes_billed,
                spot_billed, cpu_worker, cpu_master], 1)
            tattr = torch.cat([cpu_creation, cpu_evict, idle_cpu, mem_pipe,
                               ev_kill, ev_create], 1)
            ys = ys + (tser, tattr)
        return (inst, in_service, queue, starting, win, wcur + 1,
                nodes, pipe, cool, nodes_spot, pipe_spot, spot_inst,
                evict_deficit), ys

    return step


def _sim_impl(arrivals, dur, mem, billed_w, lam0, gaps, gap_tab, pol, fleet,
              cpu_consts,
              static_nodes, *, family: str, n_ticks: int, dt: float,
              cold_ticks: int, wbuf: int, prov_ticks: int, has_fleet: bool):
    """The full-history run: every tick's outputs, stacked over time ->
    (delay (T, P, F), arr_delayed (T, P, F), the 11 scalar series
    (T, P, 11) in ``_YS_NAMES[3:]`` order)."""
    step = _make_step(arrivals, dur, mem, billed_w, lam0, gaps, gap_tab,
                      pol, fleet, cpu_consts,
                      static_nodes, family=family, dt=dt,
                      cold_ticks=cold_ticks, wbuf=wbuf, prov_ticks=prov_ticks,
                      has_fleet=has_fleet)
    init_nodes = fleet[:, :1] if has_fleet else float(static_nodes)
    st = _init_state(dur.shape[0], cold_ticks, wbuf, prov_ticks, init_nodes,
                     points=fleet.shape[0], device=dur.device)
    delay, delayed, scalars = [], [], []
    for t in range(n_ticks):
        st, ys = step(st, t)
        delay.append(ys[0])
        delayed.append(ys[2])
        scalars.append(torch.cat(ys[3:], 1))
    return torch.stack(delay), torch.stack(delayed), torch.stack(scalars)


@dataclasses.dataclass
class JaxSimResult:
    delay: np.ndarray      # (T, F) per-tick queue delay estimate
    arrivals: np.ndarray   # (T, F)
    arr_delayed: np.ndarray  # (T, F) arrivals NOT served warm this tick
    instances: np.ndarray  # (T,)
    mem_total: np.ndarray  # (T,)
    mem_busy: np.ndarray   # (T,)
    creations: np.ndarray  # (T,)
    cpu_worker: np.ndarray
    cpu_master: np.ndarray
    useful: np.ndarray
    nodes: np.ndarray      # (T,) billable node count (static fleet: constant)
    completions: np.ndarray  # (T,) fluid request completions
    spot_nodes: np.ndarray  # (T,) billable SPOT share of nodes (0 w/o spot)
    billed_gb_s: np.ndarray  # (T,) billed GB-s (repro_torch.fleet.billing weights)
    dt: float
    dur: np.ndarray        # (F,)
    fleet: Optional[JaxFleet] = None
    # per-request duration distribution (for the slowdown mixture); falls
    # back to a near-degenerate lognormal at the mean when absent
    dur_median: Optional[np.ndarray] = None   # (F,)
    dur_sigma: Optional[np.ndarray] = None    # (F,)
    warm_latency_s: float = 0.008
    # sync policies produce iid per-request cold-start tails (finite-sample
    # percentile correction applies); async tails are backlog episodes
    sync_tail: bool = True


_YS_NAMES = ["delay", "arrivals", "arr_delayed", "instances", "mem_total",
             "mem_busy", "creations", "cpu_worker", "cpu_master", "useful",
             "nodes", "completions", "spot_nodes", "billed_gb_s"]


def _prep_static(trace: Trace, policy: JaxPolicy, sim: SimConfig, dt: float):
    """Everything the engine needs except the (T, F) arrivals matrix, on the
    host: dur and mem as float32 numpy, the structural depths, the CPU
    constants."""
    dur_mean = trace.profile.dur_median * np.exp(trace.profile.dur_sigma ** 2 / 2)
    dur = np.asarray(np.maximum(dur_mean, dt * 0.25), np.float32)
    mem = np.asarray(trace.profile.memory_mb + sim.instance_overhead_mb, np.float32)
    cold_ticks = max(1, int(round(sim.cold_start_s / dt)))
    wbuf = max(1, int(round(policy.window_s / dt))) \
        if get_family(policy.family).uses_window else 1
    cpu_consts = (sim.cpu_create_worker_s, sim.cpu_create_master_s,
                  sim.cpu_teardown_worker_s, sim.cpu_teardown_master_s,
                  sim.cpu_request_s, sim.cpu_idle_per_s,
                  sim.cpu_worker_floor_per_node_s,
                  sim.cpu_master_floor_per_s)
    return dur, mem, cold_ticks, wbuf, cpu_consts


def _billed_weights(trace: Trace, billing) -> np.ndarray:
    """(F,) expected billed GB-s per completion under a billing profile
    (default: the ``ideal`` profile), float32.  Imported lazily:
    ``repro_torch.core`` stays free of a hard ``repro_torch.fleet``
    dependency."""
    from repro_torch.fleet.billing import get_profile
    prof = get_profile(billing if billing is not None else "ideal")
    return np.asarray(prof.billed_weights(trace.profile), np.float32)


def stack_params(param_trees: "list[dict]") -> dict:
    """Stack per-point params pytrees into one batched pytree: every leaf
    (scalar knob or weight array) gains a leading point axis, as float32
    numpy."""
    first = param_trees[0]
    if isinstance(first, dict):
        return {k: stack_params([t[k] for t in param_trees]) for k in first}
    return np.stack([np.asarray(lf, np.float32) for lf in param_trees])


def _params_to(pols: dict, device) -> dict:
    """A stacked params tree on ``device``: a leaf of shape (P,) becomes
    (P, 1), so that it broadcasts against (P, F); weight leaves keep their
    shape (P, ...)."""
    if isinstance(pols, dict):
        return {k: _params_to(v, device) for k, v in pols.items()}
    t = torch.as_tensor(np.asarray(pols, np.float32), device=device)
    return t[:, None] if t.dim() == 1 else t


def _upload(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _arrivals_on(arr_np: np.ndarray, device) -> torch.Tensor:
    """The (T, F) count matrix on ``device`` as float32, uploaded once (the
    per-tick int -> float32 conversion of the JAX engine, done in bulk)."""
    return torch.from_numpy(np.ascontiguousarray(arr_np)).to(device).to(F32)


def simulate(trace: Trace, policy: JaxPolicy, sim: SimConfig = SimConfig(),
             dt: float = 1.0, num_nodes: int = 8,
             fleet: Optional[JaxFleet] = None, billing=None, *,
             device=None) -> JaxSimResult:
    """Every tick's series of one run (see ``repro.core.simjax.simulate``),
    as numpy arrays; the run happens on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    arr_np = np.asarray(rate_matrix(trace, dt))
    dur, mem, cold_ticks, wbuf, cpu_consts = _prep_static(trace, policy, sim, dt)
    billed_w = _billed_weights(trace, billing)
    has_fleet = fleet is not None
    prov_ticks = max(1, int(round((fleet.provision_s if has_fleet else 0.0) / dt)))
    pol = _params_to(stack_params([policy.params()]), dev)
    fl = _upload([fleet.params() if has_fleet else np.zeros(len(_PFLEET))], dev)
    lam0 = _upload(arr_np.mean(axis=0) / dt, dev)
    gq, alive_tab, tail_tab = gap_statistics(trace)
    with torch.no_grad():
        delay, delayed, scalars = _sim_impl(
            _arrivals_on(arr_np, dev), _upload(dur, dev), _upload(mem, dev),
            _upload(billed_w, dev), lam0, _upload(gq, dev),
            (_upload(alive_tab, dev), _upload(tail_tab, dev)), pol, fl,
            cpu_consts, float(num_nodes),
            family=policy.family, n_ticks=arr_np.shape[0], dt=dt,
            cold_ticks=cold_ticks, wbuf=wbuf, prov_ticks=prov_ticks,
            has_fleet=has_fleet)
    scalars = scalars[:, 0].cpu().numpy()
    vals = {"delay": delay[:, 0].cpu().numpy(),
            "arrivals": arr_np.astype(np.float32),
            "arr_delayed": delayed[:, 0].cpu().numpy()}
    vals.update({n: scalars[:, i] for i, n in enumerate(_YS_NAMES[3:])})
    return JaxSimResult(dt=dt, dur=dur, fleet=fleet,
                        dur_median=np.asarray(trace.profile.dur_median),
                        dur_sigma=np.asarray(trace.profile.dur_sigma),
                        warm_latency_s=sim.warm_latency_s,
                        sync_tail=get_family(policy.family).synchronous_tail,
                        **vals)


def summarize(res: JaxSimResult, warmup_frac: float = 0.5,
              nbins: int = 256, *, device=None) -> dict:
    """The metric row of a full-history run (numpy, as the JAX package's);
    ``device`` is where the slowdown solver runs for histograms of at least
    ``_TORCH_SOLVER_MIN_CELLS`` cells."""
    t0 = int(len(res.instances) * warmup_frac)
    sl = slice(t0, None)
    # arrival-weighted per-function delay histogram -> p99 of the
    # per-request slowdown mixture (same estimator as the chunked path):
    # warm-served arrivals land in the zero-delay bin, delayed arrivals
    # carry the tick's delay estimate
    delays, weights = res.delay[sl], res.arrivals[sl]
    delayed = res.arr_delayed[sl]
    f = delays.shape[1]
    edges = _delay_edges(nbins)
    b = np.clip(np.searchsorted(edges, delays, side="right"), 0, nbins - 1)
    hist = np.zeros((f, nbins))
    fn_idx = np.broadcast_to(np.arange(f), delays.shape)
    np.add.at(hist, (fn_idx, b), delayed)
    hist[:, 0] += (weights - delayed).sum(axis=0)
    med = res.dur_median if res.dur_median is not None else np.asarray(res.dur)
    sig = res.dur_sigma if res.dur_sigma is not None else np.zeros(f)
    # delegate to the chunked path's row builder so every metric formula
    # exists exactly once
    sums = np.asarray([res.instances[sl].sum(), res.mem_total[sl].sum(),
                       res.mem_busy[sl].sum(), res.creations[sl].sum(),
                       res.cpu_worker[sl].sum(), res.cpu_master[sl].sum(),
                       res.useful[sl].sum(), res.nodes[sl].sum(),
                       res.completions[sl].sum(), res.spot_nodes[sl].sum(),
                       res.billed_gb_s[sl].sum()])
    return _acc_summary(hist, weights.sum(axis=0), sums,
                        len(res.instances) - t0, edges, med, sig,
                        res.warm_latency_s, res.dt, iid_tail=res.sync_tail,
                        device=device)


# ---------------------------------------------------------------------------
# chunked run: production scale without per-tick histories
# ---------------------------------------------------------------------------
#
# ``simulate`` materializes two (T, F) arrays plus eleven (T,) series.  The
# chunked path runs the SAME ``_make_step`` tick function but keeps only
# summary statistics (per-function arrival-weighted delay histograms + scalar
# sums), accumulated in float32 over a chunk of ticks and in float64 across
# chunks, so device memory is O(P * F * BINS) regardless of trace length.

# scalar per-tick series accumulated post-warmup (order matches ys[3:];
# ys[0:3] are the per-function delay / arrivals / delayed-arrivals vectors)
_ACC_NAMES = ("instances", "mem_total", "mem_busy", "creations", "cpu_worker",
              "cpu_master", "useful", "nodes", "completions", "spot_nodes",
              "billed_gb_s")


def _delay_edges(nbins: int) -> np.ndarray:
    """Log-spaced histogram bin edges over 1 ms .. ~28 h of queueing delay.
    ~1.075x per bin at nbins=256, so histogram p99s land within a few
    percent of the exact per-tick percentile."""
    return np.logspace(-3, 5, nbins - 1, dtype=np.float32)


def _bin_reps(edges: np.ndarray) -> np.ndarray:
    """Representative delay per histogram bin: 0 below the first edge,
    geometric midpoints inside, the top edge above."""
    return np.concatenate([[0.0], np.sqrt(edges[:-1] * edges[1:]),
                           [float(edges[-1])]])


def _phi(z: np.ndarray) -> np.ndarray:
    """Standard normal CDF (Abramowitz–Stegun 7.1.26; |err| < 1.5e-7),
    vectorized."""
    z = np.asarray(z, np.float64)
    t = 1.0 / (1.0 + 0.3275911 * np.abs(z) / np.sqrt(2.0))
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    erf = 1.0 - poly * np.exp(-0.5 * z * z)
    return 0.5 * (1.0 + np.sign(z) * erf)


# per-request service times are clipped lognormals (see trace.synthesize)
_DUR_FLOOR, _DUR_CAP = 0.02, 30.0


def _slowdown_geomean(hist, arrtot, edges, dur_median, dur_sigma, warm,
                      min_requests: int = 5, q: float = 0.99,
                      iid_tail: bool = True, fn_weights=None,
                      device=None) -> float:
    """Geomean over functions of the q-quantile of per-request slowdown
    S = 1 + (W + warm) / D, W the arrival-weighted delay histogram and D an
    independent clipped lognormal, solved for the q-quantile by bisection
    (see ``repro.core.simjax._slowdown_geomean``).

    ``hist`` is numpy or a tensor.  Histograms of at least
    ``_TORCH_SOLVER_MIN_CELLS`` cells go through the float32 torch solver
    (``_slowdown_geomean_torch``) on the tensor's device, or on ``device``
    for numpy; smaller ones keep the float64 numpy path, bit for bit."""
    size = hist.numel() if isinstance(hist, torch.Tensor) else np.asarray(hist).size
    if size >= _TORCH_SOLVER_MIN_CELLS:
        return _slowdown_geomean_torch(hist, arrtot, edges, dur_median,
                                       dur_sigma, warm, min_requests, q,
                                       iid_tail, fn_weights, device)
    if isinstance(hist, torch.Tensor):
        hist = hist.cpu().numpy()
    n_eff = np.asarray(arrtot, np.float64)
    if fn_weights is not None:
        n_eff = n_eff / np.maximum(np.asarray(fn_weights, np.float64), 1e-12)
    keep = n_eff >= min_requests
    if not keep.any():
        return float("nan")
    h = np.asarray(hist)[keep]
    p = h / h.sum(axis=1, keepdims=True)
    w = _bin_reps(edges)[None, :] + warm                      # (F', B)
    log_med = np.log(np.maximum(dur_median[keep], 1e-9))[:, None]
    sig = np.maximum(dur_sigma[keep], 1e-6)[:, None]
    # finite-sample correction: the oracle's empirical percentile over n
    # requests sits near the population quantile (q*(n-1)+1)/(n+1) when the
    # tail events are independent (sync cold starts), not for async backlog
    # episodes (iid_tail=False -> raw q)
    n = n_eff[keep]
    q_eff = (q * (n - 1.0) + 1.0) / (n + 1.0) if iid_tail \
        else np.full(len(n), q)
    lo = np.full(h.shape[0], 1.0)
    hi = np.full(h.shape[0], 1.0 + w.max() / _DUR_FLOOR + 1.0)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        x = w / np.maximum(mid - 1.0, 1e-12)[:, None]
        sf = np.where(x <= _DUR_FLOOR, 1.0,
                      np.where(x >= _DUR_CAP, 0.0,
                               1.0 - _phi((np.log(np.maximum(x, 1e-300))
                                           - log_med) / sig)))
        ok = (p * sf).sum(axis=1) >= q_eff
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid)
    logs = np.log(np.maximum(0.5 * (lo + hi), 1.0))
    if fn_weights is None:
        return float(np.exp(np.mean(logs)))
    return float(np.exp(np.average(
        logs, weights=np.asarray(fn_weights, np.float64)[keep])))


#: histogram cell count at which the slowdown bisection switches from the
#: float64 numpy solver to the float32 torch one: above the 2000-function
#: fig9 replay (512k cells stays numpy) and below fig9_planet (25.6M)
_TORCH_SOLVER_MIN_CELLS = 1 << 22

_SQRT2_F32 = float(np.sqrt(2.0).astype(np.float32))


def _phi_torch(z):
    """float32 torch port of `_phi` (A&S 7.1.26 normal CDF)."""
    t = 1.0 / (1.0 + 0.3275911 * torch.abs(z) / _SQRT2_F32)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
                + t * (-1.453152027 + t * 1.061405429))))
    erf = 1.0 - poly * torch.exp(-0.5 * z * z)
    return 0.5 * (1.0 + torch.sign(z) * erf)


def _bisect_slowdown(p, wrow, q_eff, log_med, sig, hi0: float, iters: int = 60):
    """The q-quantile of every row's slowdown mixture, by ``iters`` halvings
    of [1, hi0], float32 on ``p``'s device (no host read inside)."""
    lo = torch.ones(p.shape[0], dtype=F32, device=p.device)
    hi = torch.full((p.shape[0],), hi0, dtype=F32, device=p.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        x = wrow[None, :] / torch.clamp_min(mid - 1.0, 1e-12)[:, None]
        z = (torch.log(torch.clamp_min(x, 1e-30)) - log_med) / sig
        sf = torch.where(x <= _DUR_FLOOR, 1.0,
                         torch.where(x >= _DUR_CAP, 0.0, 1.0 - _phi_torch(z)))
        ok = (p * sf).sum(1) >= q_eff
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return 0.5 * (lo + hi)


def _slowdown_geomean_torch(hist, arrtot, edges, dur_median, dur_sigma, warm,
                            min_requests, q, iid_tail, fn_weights,
                            device=None) -> float:
    """Planet-scale twin of the numpy bisection: the same mixture, float32
    on the device.  A tensor ``hist`` stays where it is (no host round trip
    of a float64 histogram); numpy goes to ``device``.  The float32
    interval bottoms out near 1e-7 relative, far below the ~7% bin width."""
    dev = hist.device if isinstance(hist, torch.Tensor) else resolve_device(device)
    n_eff = np.asarray(arrtot, np.float64)
    w_np = None if fn_weights is None else np.asarray(fn_weights, np.float64)
    if w_np is not None:
        n_eff = n_eff / np.maximum(w_np, 1e-12)
    keep = n_eff >= min_requests
    if not keep.any():
        return float("nan")
    h = torch.as_tensor(hist, device=dev)[torch.as_tensor(keep, device=dev)].to(F32)
    p = h / torch.clamp_min(h.sum(1, keepdim=True), 1e-30)
    wrow = _upload(_bin_reps(edges) + warm, dev)
    log_med = _upload(np.log(np.maximum(np.asarray(dur_median)[keep], 1e-9)),
                      dev)[:, None]
    sig = _upload(np.maximum(np.asarray(dur_sigma)[keep], 1e-6), dev)[:, None]
    n = n_eff[keep]
    q_np = (q * (n - 1.0) + 1.0) / (n + 1.0) if iid_tail \
        else np.full(len(n), q)
    hi0 = float(np.float32(1.0 + (float(_bin_reps(edges)[-1]) + warm)
                           / _DUR_FLOOR + 1.0))
    s = _bisect_slowdown(p, wrow, _upload(q_np, dev), log_med, sig, hi0)
    logs = np.log(np.maximum(s.cpu().numpy().astype(np.float64), 1.0))
    if w_np is None:
        return float(np.exp(np.mean(logs)))
    return float(np.exp(np.average(logs, weights=w_np[keep])))


def _chunk_impl(state, arr_chunk, lam0, gaps, gap_tab, dur, mem, billed_w,
                pol, fleet,
                cpu_consts, static_nodes, edges, tick0, *, warm_tick: int,
                total_ticks: int, family: str, dt: float,
                cold_ticks: int, wbuf: int, prov_ticks: int, has_fleet: bool,
                telem_slots: int = 0, weights=None):
    """Advance every point by one time chunk (``arr_chunk`` (T_c, F) float32
    rows of the count matrix; ``tick0`` the Python int index of its first
    tick); return the state and this chunk's float32 partials:
    (hist (P, F, nbins), arrtot (P, F), sums (P, 11), n) and, with
    ``telem_slots > 0``, (tser (P, S, 12), tcnt (S,) numpy, tattr (P, 6)).
    ``n`` and ``tcnt`` count ticks and are host numbers.  Ticks at global
    index < warm_tick (warmup) or >= total_ticks (padding) advance the state
    but add nothing to the statistics.  With telemetry off the step and the
    sums are exactly the telemetry-free ones."""
    f = arr_chunk.shape[1]
    points = fleet.shape[0]
    dev = arr_chunk.device
    nbins = edges.shape[0] + 1
    telem = telem_slots > 0
    step = _make_step(arr_chunk, dur, mem, billed_w, lam0, gaps, gap_tab,
                      pol, fleet,
                      cpu_consts, static_nodes, family=family, dt=dt,
                      cold_ticks=cold_ticks, wbuf=wbuf, prov_ticks=prov_ticks,
                      has_fleet=has_fleet, telem=telem, weights=weights)
    hist = torch.zeros(points, f, nbins, dtype=F32, device=dev)
    arrtot = torch.zeros(f, dtype=F32, device=dev)
    sums = torch.zeros(points, len(_ACC_NAMES), dtype=F32, device=dev)
    n = 0
    if telem:
        tser = torch.zeros(points, telem_slots, len(TELEM_SERIES), dtype=F32,
                           device=dev)
        tcnt = np.zeros(telem_slots)
        tattr = torch.zeros(points, len(TELEM_ATTR), dtype=F32, device=dev)
    for i in range(arr_chunk.shape[0]):
        state, ys = step(state, i)
        g = tick0 + i
        if telem and g < total_ticks:             # timeline: warmup in
            slot = min(max(g * telem_slots // total_ticks, 0), telem_slots - 1)
            tser[:, slot] += ys[14]
            tcnt[slot] += 1.0
        if not warm_tick <= g < total_ticks:
            continue
        delay, arr, arr_delayed = ys[0], ys[1], ys[2]
        if weights is not None:
            # super-function multiplicity: the histogram counts REQUESTS,
            # so the representative's arrivals weigh in once per member
            arr, arr_delayed = arr * weights, arr_delayed * weights
        b = torch.clamp(torch.searchsorted(edges, delay, right=True), 0, nbins - 1)
        # one delayed add a row (no two adds meet in a cell: deterministic),
        # then the warm arrivals into bin 0, in the JAX engine's order
        hist.view(points * f, nbins).scatter_add_(
            1, b.view(-1, 1), arr_delayed.reshape(-1, 1))
        hist[..., 0] += arr - arr_delayed
        arrtot = arrtot + arr
        sums = sums + torch.cat(ys[3:3 + len(_ACC_NAMES)], 1)
        n += 1
        if telem:
            tattr = tattr + ys[15]                # attribution: not
    out = (hist, arrtot.expand(points, f), sums, n)
    if telem:
        out = out + (tser, tcnt, tattr)
    return state, out


def _acc_summary(hist, arrtot, sums, n, edges, dur_median, dur_sigma, warm,
                 dt, iid_tail: bool = True, fn_weights=None, device=None) -> dict:
    """Build the ``summarize``-compatible metric row from the accumulated
    statistics (``sums`` float64 numpy; ``hist`` numpy or a tensor)."""
    geo = _slowdown_geomean(hist, arrtot, edges, dur_median, dur_sigma, warm,
                            iid_tail=iid_tail, fn_weights=fn_weights,
                            device=device)
    s = dict(zip(_ACC_NAMES, sums))
    n = max(float(n), 1e-9)
    window = n * dt
    useful = max(s["useful"], 1e-9)
    w, m = s["cpu_worker"], s["cpu_master"]
    return {
        "slowdown_geomean_p99": geo,
        "normalized_memory": float(s["mem_total"] / max(s["mem_busy"], 1e-9)),
        "creation_rate": float(s["creations"] / window),
        "cpu_overhead": float((w + m) / useful),
        "worker_share": float(w / max(w + m, 1e-9)),
        "instances_mean": float(s["instances"] / n),
        "nodes_mean": float(s["nodes"] / n),
        "node_seconds": float(s["nodes"] * dt),
        "spot_nodes_mean": float(s["spot_nodes"] / n),
        "spot_node_seconds": float(s["spot_nodes"] * dt),
        "completed": float(s["completions"]),
        "cpu_useful_s": float(s["useful"]),
        "cpu_worker_s": float(w),
        "cpu_master_s": float(m),
        "mem_total_mean": float(s["mem_total"] / n),
        "mem_busy_mean": float(s["mem_busy"] / n),
        "billed_gb_s": float(s["billed_gb_s"]),
        "ticks_measured": float(n),
    }


#: what ``RunSpec(devices=d)`` with d > 1 needs and the port does not have yet
_MULTI_DEVICE = ("RunSpec(devices={d}) shards the chunked run over {d} devices "
                 "(repro.core.simjax._chunk_batch_fnshard_impl and the point-axis "
                 "mesh); the port runs on one device until that is ported "
                 "(ROADMAP Queue 1 item 11)")


@dataclasses.dataclass
class _ChunkedRun:
    """A chunked run's inputs on the device: the (T, F) arrivals, the
    initial state, and the keyword arguments of every ``_chunk_impl`` call
    but the state, the chunk and its first tick."""
    arr: torch.Tensor
    state: tuple
    chunk_kw: dict
    n_ticks: int
    chunk_ticks: int


def _chunked_setup(trace, policy: JaxPolicy, pols: dict, fleets: np.ndarray, *,
                   sim: SimConfig, dt: float, num_nodes: float, provision_s: float,
                   has_fleet: bool, chunk_ticks: int, warmup_frac: float, nbins: int,
                   telemetry: int = 0, billing=None, device=None) -> _ChunkedRun:
    """The host preparation of ``_chunked_summaries`` (the rate matrix, the
    gap statistics, the static per-function vectors) and its one upload."""
    dev = resolve_device(device)
    arr_np = np.asarray(rate_matrix(trace, dt))
    n_ticks, f = arr_np.shape
    dur, mem, cold_ticks, wbuf, cpu_consts = _prep_static(trace, policy, sim, dt)
    billed_w = _billed_weights(trace, billing)
    weights_np = getattr(trace, "weights", None)
    prov_ticks = max(1, int(round(provision_s / dt)))
    gq, alive_tab, tail_tab = gap_statistics(trace)
    fleets_t = _upload(fleets, dev)
    init_nodes = fleets_t[:, :1] if has_fleet else float(num_nodes)
    state = _init_state(f, cold_ticks, wbuf, prov_ticks, init_nodes,
                        points=fleets.shape[0], device=dev)
    chunk_kw = dict(
        lam0=_upload(arr_np.mean(axis=0) / dt, dev), gaps=_upload(gq, dev),
        gap_tab=(_upload(alive_tab, dev), _upload(tail_tab, dev)),
        dur=_upload(dur, dev), mem=_upload(mem, dev), billed_w=_upload(billed_w, dev),
        pol=_params_to(pols, dev), fleet=fleets_t, cpu_consts=cpu_consts,
        static_nodes=float(num_nodes),
        edges=torch.as_tensor(_delay_edges(nbins), device=dev),
        warm_tick=int(n_ticks * warmup_frac), total_ticks=n_ticks,
        family=policy.family, dt=dt, cold_ticks=cold_ticks, wbuf=wbuf,
        prov_ticks=prov_ticks, has_fleet=has_fleet, telem_slots=int(telemetry),
        weights=None if weights_np is None else _upload(weights_np, dev))
    return _ChunkedRun(arr=_arrivals_on(arr_np, dev), state=state, chunk_kw=chunk_kw,
                       n_ticks=n_ticks, chunk_ticks=max(1, min(chunk_ticks, n_ticks)))


def _chunked_summaries(trace, policy: JaxPolicy, pols: dict,
                       fleets: np.ndarray, *, sim: SimConfig, dt: float,
                       num_nodes: float, provision_s: float, has_fleet: bool,
                       chunk_ticks: int, warmup_frac: float,
                       nbins: int, telemetry: int = 0,
                       billing=None, devices: int = 0,
                       device=None) -> list[dict]:
    """Run a batch of policy/fleet parameter points through the chunked
    loop (a leading point axis, a host loop over time chunks) and return one
    ``summarize``-style dict per point.  ``pols`` is a stacked params pytree
    (``stack_params``); ``policy`` supplies the family and the structural
    knobs.  The run happens on ``device`` (CUDA by default); ``devices``
    above 1 raises ``NotImplementedError`` (no multi-device run yet)."""
    devices = int(devices)
    if devices > 1:
        raise NotImplementedError(_MULTI_DEVICE.format(d=devices))
    run = _chunked_setup(trace, policy, pols, fleets, sim=sim, dt=dt,
                         num_nodes=num_nodes, provision_s=provision_s,
                         has_fleet=has_fleet, chunk_ticks=chunk_ticks,
                         warmup_frac=warmup_frac, nbins=nbins, telemetry=telemetry,
                         billing=billing, device=device)
    n_points, f = fleets.shape[0], run.arr.shape[1]
    dev = run.arr.device
    f64 = dict(dtype=torch.float64, device=dev)
    hist = torch.zeros(n_points, f, nbins, **f64)
    arrtot = torch.zeros(n_points, f, **f64)
    sums = torch.zeros(n_points, len(_ACC_NAMES), **f64)
    n = 0.0
    telemetry = int(telemetry)
    tser = torch.zeros(n_points, max(telemetry, 1), len(TELEM_SERIES), **f64)
    tcnt = np.zeros(max(telemetry, 1))
    tattr = torch.zeros(n_points, len(TELEM_ATTR), **f64)
    state = run.state
    # The JAX engine pads the last chunk to chunk_ticks with masked ticks;
    # those advance a state nobody reads and add nothing, so the port ends
    # the last chunk at the last tick.
    with torch.no_grad():
        for t0 in range(0, run.n_ticks, run.chunk_ticks):
            state, out = _chunk_impl(state, run.arr[t0:t0 + run.chunk_ticks],
                                     tick0=t0, **run.chunk_kw)
            hist += out[0]
            arrtot += out[1]
            sums += out[2]
            n += out[3]
            if telemetry:
                tser += out[4]
                tcnt += out[5]
                tattr += out[6]
    iid = get_family(policy.family).synchronous_tail
    edges = _delay_edges(nbins)
    dur_median = np.asarray(trace.profile.dur_median)
    dur_sigma = np.asarray(trace.profile.dur_sigma)
    weights_np = getattr(trace, "weights", None)
    # one read back of the run: the histograms stay on the device where the
    # torch solver takes them (planet scale), else come over with the rest
    on_device = f * nbins >= _TORCH_SOLVER_MIN_CELLS
    hist_rows = hist if on_device else hist.cpu().numpy()
    arrtot, sums = arrtot.cpu().numpy(), sums.cpu().numpy()

    def row(i):
        return _acc_summary(hist_rows[i], arrtot[i], sums[i], n, edges, dur_median,
                            dur_sigma, sim.warm_latency_s, dt, iid_tail=iid,
                            fn_weights=weights_np)
    # the rows' slowdown solves are independent, and numpy's float64
    # bisection leaves the interpreter lock, so they run side by side
    # (a 64-point sweep's solves: PERF.md, tools/fluid_sweep_split.py)
    with ThreadPoolExecutor(min(n_points, os.cpu_count() or 1)) as pool:
        rows = list(pool.map(row, range(n_points)))
    if telemetry:
        tser, tattr = tser.cpu().numpy(), tattr.cpu().numpy()
        for i, r in enumerate(rows):
            r["telemetry"] = assemble_telemetry(tser[i], tcnt, tattr[i], run.n_ticks, dt)
    return rows


def simulate_chunked(trace, policy: JaxPolicy, sim: SimConfig = SimConfig(),
                     dt: float = 1.0, num_nodes: int = 8,
                     fleet: Optional[JaxFleet] = None, chunk_ticks: int = 512,
                     warmup_frac: float = 0.5, nbins: int = 256,
                     *, spec=None, device=None) -> dict:
    """Memory-bounded twin of ``summarize(simulate(...))``: same step math,
    same metric keys, summary statistics accumulated chunk by chunk so long
    or wide traces never materialize (T, F) histories.  ``trace`` may be an
    event-level ``Trace`` or a pre-binned ``RateTrace`` (optionally
    clustered into weighted super-functions).

    ``spec`` (a ``repro_torch.core.runspec.RunSpec``) carries the run knobs
    this engine consumes: ``telemetry`` slots (0 = off: exactly the
    telemetry-free row), the ``billing`` profile (default ``ideal``), and
    ``devices`` (above 1 raises ``NotImplementedError``).  The run happens
    on ``device`` (CUDA by default)."""
    from repro_torch.core.runspec import RunSpec
    spec = spec if spec is not None else RunSpec()
    if not isinstance(spec, RunSpec):
        raise TypeError("simulate_chunked() spec= must be a RunSpec, got "
                        f"{type(spec).__name__}")
    has_fleet = fleet is not None
    pols = stack_params([policy.params()])
    fleets = np.asarray([fleet.params() if has_fleet
                         else np.zeros(len(_PFLEET))], np.float32)
    return _chunked_summaries(
        trace, policy, pols, fleets, sim=sim, dt=dt, num_nodes=num_nodes,
        provision_s=fleet.provision_s if has_fleet else 0.0,
        has_fleet=has_fleet, chunk_ticks=chunk_ticks,
        warmup_frac=warmup_frac, nbins=nbins, telemetry=spec.telemetry,
        billing=spec.billing, devices=spec.devices, device=device)[0]
