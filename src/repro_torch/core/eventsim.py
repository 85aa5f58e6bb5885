"""Discrete-event cluster simulator — the oracle for the paper's experiments.

A copy of ``repro.core.eventsim`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Replays a Trace against a Cluster under a Policy (per function), modelling:
(policies are lowered from ``repro_torch.core.policy_api`` family registrations
via ``PolicySpec.factory()`` — the oracle leg every registered policy
family, hand-written or gradient-learned, must hold the parity band on)
  instance lifecycle (cold start, busy/idle, keepalive expiry, teardown),
  container concurrency slots, request queueing (sync buffers per new
  instance, async queues until any instance frees), node failures with
  re-queued requests, straggler nodes, and the CPU/memory accounting behind
  the paper's four metrics.

Two-level autoscaling: pass a ``repro_torch.fleet.NodeFleet`` and the node list
itself becomes elastic — nodes are provisioned (latency ≫ cold start),
drained before termination (in-flight work finishes first), and billed by
the second for the cost model in ``repro_torch.fleet.costs``.  A placement
failure then *defers* the instance creation and feeds the fleet reconciler
as scale-up pressure, instead of dropping the request.  A
``repro_torch.fleet.spot.SpotNodeFleet`` adds preemptible capacity: the market
announces reclaims, the node drains through its notice window, and the
``node_evict`` event force-kills whatever is still running — its in-flight
requests re-queue and recreate capacity (the eviction cold-start storm).

CPU overhead model (calibrated against the paper's Fig. 5/6 in
EXPERIMENTS.md):  churn dominates — a create+teardown pair costs ~8 CPU-s
(80% on the worker: sandbox setup, CNI, queue-proxy, probes; 20% master),
plus a small per-request data-plane cost, a per-idle-instance keepalive cost
(probes/metrics), and a constant control-plane floor.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cluster import DRAINING, GONE, UP, Cluster
from repro_torch.core.policies import Policy
from repro_torch.core.trace import Trace


@dataclasses.dataclass(frozen=True)
class SimConfig:
    cold_start_s: float = 1.0            # Knative-like; 0.3 approximates Lambda
    cold_start_jitter: float = 0.15
    warm_latency_s: float = 0.008        # data-plane hop on every dispatch
    teardown_s: float = 0.2
    tick_s: float = 2.0
    # CPU accounting (cpu-seconds)
    cpu_create_worker_s: float = 5.2
    cpu_create_master_s: float = 1.3
    cpu_teardown_worker_s: float = 1.2
    cpu_teardown_master_s: float = 0.3
    cpu_request_s: float = 0.02          # activator/queue-proxy per request
    cpu_idle_per_s: float = 0.002        # probes+metrics per warm instance
    cpu_master_floor_per_s: float = 1.5  # apiserver/controllers/prometheus
    cpu_worker_floor_per_node_s: float = 0.3   # kubelet/containerd/node-exporter
    num_worker_nodes_hint: int = 8
    instance_overhead_mb: float = 10.0   # per-sandbox memory overhead
    seed: int = 0
    warmup_s: Optional[float] = None     # measurement starts here (default T/2)


@dataclasses.dataclass
class RequestRecord:
    fn: int
    arrival: float
    start: float = math.nan
    end: float = math.nan
    dur: float = 0.0
    cold: bool = False
    requeued: int = 0
    # span bookkeeping (repro_torch.obs): ids of this request's open request /
    # queue / execute spans; -1 when tracing is off or the span is closed
    sid: int = dataclasses.field(default=-1, repr=False, compare=False)
    qsid: int = dataclasses.field(default=-1, repr=False, compare=False)
    xsid: int = dataclasses.field(default=-1, repr=False, compare=False)


class _Instance:
    __slots__ = ("iid", "fn", "node", "cc", "in_flight", "state", "idle_since",
                 "expire_version", "memory_mb", "csid")

    def __init__(self, iid, fn, node, cc, memory_mb):
        self.iid, self.fn, self.node, self.cc = iid, fn, node, cc
        self.in_flight = 0
        self.state = "starting"            # starting | up | dead
        self.idle_since = math.nan
        self.expire_version = 0
        self.memory_mb = memory_mb
        self.csid = -1                     # open instance_create span id


class _FnState:
    __slots__ = ("instances", "queue", "starting", "policy")

    def __init__(self, policy: Policy):
        self.instances: list[_Instance] = []
        self.queue: deque = deque()
        self.starting = 0
        self.policy = policy

    @property
    def idle_count(self):
        return sum(1 for i in self.instances if i.state == "up" and i.in_flight == 0)

    @property
    def busy_free_slots(self):
        """Spare slots on instances that are already serving traffic — the
        ``busy_slots`` argument of ``Policy.on_arrival``.  Instances on
        draining nodes take no new dispatches, so their slots don't count."""
        return sum(i.cc - i.in_flight for i in self.instances
                   if i.state == "up" and i.in_flight > 0
                   and i.node.state == UP)

    @property
    def concurrency(self):
        return sum(i.in_flight for i in self.instances) + len(self.queue)


@dataclasses.dataclass
class SimResult:
    records: list[RequestRecord]
    creations: int
    teardowns: int
    cpu_useful_s: float
    cpu_worker_overhead_s: float
    cpu_master_overhead_s: float
    mem_samples_total_mb: np.ndarray
    mem_samples_busy_mb: np.ndarray
    sample_times: np.ndarray
    measure_window_s: float
    dropped: int = 0
    # node-fleet accounting (zero / static when no fleet is attached)
    node_seconds: float = 0.0
    node_samples: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    node_provisions: int = 0
    node_terminations: int = 0
    nodes_hint: int = 0
    # spot-tier accounting (zero for an on-demand-only fleet)
    spot_node_seconds: float = 0.0
    node_evictions: int = 0
    # overhead attribution (repro_torch.obs.ledger): the measured-window CPU
    # split into creation churn / eviction storms / keepalive idle (the
    # control-plane remainder is the residual), plus the still-starting
    # memory samples behind the pipeline share of normalized memory
    mem_samples_starting_mb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    cpu_churn_creation_s: float = 0.0
    cpu_evict_storm_s: float = 0.0
    cpu_keepalive_idle_s: float = 0.0

    def billed_duration_totals(self, granularity_s: float = 0.0,
                               min_billed_s: float = 0.0):
        """Per-request billed-duration totals over the measured window's
        ``records``: each recorded duration is rounded UP to the billing
        granularity and censored at the minimum billed duration EXACTLY
        (no expectation) — the oracle-side input ``repro_torch.fleet.billing``
        meters GB-s against.  Returns ``(fn_ids, billed_seconds)``
        aggregated per function; identity rounding when both knobs are 0.
        (``records`` already covers only the measured window, so these
        totals align with ``len(records)`` completions.)"""
        if not self.records:
            return np.zeros(0, np.int64), np.zeros(0)
        fn = np.asarray([r.fn for r in self.records], np.int64)
        d = np.asarray([r.dur for r in self.records], np.float64)
        if granularity_s > 0.0:
            # the 1e-9 guard keeps exact multiples of the granularity
            # from rounding up an extra step through d/g float noise
            d = np.ceil(d / granularity_s - 1e-9) * granularity_s
        if min_billed_s > 0.0:
            d = np.maximum(d, min_billed_s)
        uniq = np.unique(fn)
        tot = np.bincount(fn, weights=d)
        return uniq, tot[uniq]


class EventSim:
    def __init__(self, trace: Trace, cluster: Cluster, policy_factory: Callable[[int], Policy],
                 cfg: SimConfig = SimConfig(),
                 failures: Optional[list[tuple[float, int]]] = None,
                 fleet=None, obs=None):
        self.trace = trace
        self.cluster = cluster
        self.cfg = cfg
        self.fleet = fleet                 # Optional[repro_torch.fleet.NodeFleet]
        self.obs = obs                     # Optional[repro_torch.obs.SpanRecorder]
        self.rng = np.random.default_rng(cfg.seed)
        self.fns = [_FnState(policy_factory(f)) for f in range(trace.num_functions)]
        self.failures = sorted(failures or [])
        self._events: list = []
        self._counter = itertools.count()
        self._iid = itertools.count()
        self._rid = itertools.count()      # request span track ids
        # deferred creations per function, clamped to real queued demand so
        # level-based policies re-issuing creates every tick can't stack
        # duplicate deferrals (and duplicate scale-up pressure)
        self._pending_creates: dict[int, int] = {}
        self.records: list[RequestRecord] = []
        self.creations = 0
        self.teardowns = 0
        self.cpu_useful = 0.0
        self.cpu_worker = 0.0
        self.cpu_master = 0.0
        self.mem_total: list[float] = []
        self.mem_busy: list[float] = []
        self.mem_start: list[float] = []
        self.sample_t: list[float] = []
        self.node_samples: list[int] = []
        self.node_seconds = 0.0
        self.dropped = 0
        # overhead attribution (repro_torch.obs.ledger): measured-window CPU by
        # cause; ``_evict_debt`` counts eviction-killed instances per
        # function whose recreate (the next cold start) belongs to the
        # eviction storm, not to ordinary creation churn — the discrete
        # twin of the fluid engine's ``evict_deficit`` carry
        self.att_create = 0.0
        self.att_evict = 0.0
        self.att_idle = 0.0
        self._evict_debt: dict[int, int] = {}
        self._drain_sids: dict[int, int] = {}   # node_id -> open drain span
        self._measure_from = cfg.warmup_s if cfg.warmup_s is not None \
            else trace.duration_s / 2

    # -- event machinery -----------------------------------------------------------

    def _push(self, t: float, kind: str, payload=None):
        heapq.heappush(self._events, (t, next(self._counter), kind, payload))

    def run(self) -> SimResult:
        cfg = self.cfg
        for t, fn, dur in zip(self.trace.t, self.trace.fn, self.trace.dur):
            rec = RequestRecord(int(fn), float(t), dur=float(dur))
            self._push(float(t), "arrival", rec)
        for t in np.arange(0, self.trace.duration_s, cfg.tick_s):
            self._push(float(t), "tick")
        for t, node in self.failures:
            self._push(t, "fail", node)
        end_t = self.trace.duration_s
        while self._events:
            t, _, kind, payload = heapq.heappop(self._events)
            if t > end_t and kind in ("tick",):
                continue
            getattr(self, f"_on_{kind}")(t, payload)
        if self.obs:
            # requests still queued / instances still starting when the
            # trace ends close here, tagged ``truncated``
            self.obs.finish(end_t)
        fl = self.fleet
        return SimResult(
            self.records, self.creations, self.teardowns, self.cpu_useful,
            self.cpu_worker, self.cpu_master,
            np.asarray(self.mem_total), np.asarray(self.mem_busy),
            np.asarray(self.sample_t), end_t - self._measure_from, self.dropped,
            node_seconds=self.node_seconds,
            node_samples=np.asarray(self.node_samples),
            node_provisions=fl.provisions if fl else 0,
            node_terminations=fl.terminations if fl else 0,
            nodes_hint=sum(1 for n in self.cluster.nodes if n.billable),
            spot_node_seconds=fl.spot_node_seconds if fl else 0.0,
            node_evictions=fl.evictions if fl else 0,
            mem_samples_starting_mb=np.asarray(self.mem_start),
            cpu_churn_creation_s=self.att_create,
            cpu_evict_storm_s=self.att_evict,
            cpu_keepalive_idle_s=self.att_idle)

    def _measuring(self, t) -> bool:
        return t >= self._measure_from

    def _node_evicting(self, node) -> bool:
        """Is this node under an announced (not yet enforced) spot reclaim?
        Teardowns on announced nodes belong to the eviction storm."""
        return self.fleet is not None \
            and node.node_id in getattr(self.fleet, "announced_ids", ())

    # -- instance lifecycle ----------------------------------------------------------

    def _create_instance(self, t: float, fn: int):
        fs = self.fns[fn]
        mem = self.trace.profile.memory_mb[fn] + self.cfg.instance_overhead_mb
        node = self.cluster.place(mem)
        if node is None:
            if self.fleet is not None:
                # placement failure -> the create is deferred and retried when
                # capacity appears (scale-up pressure is metered per tick from
                # the deferred level), not dropped
                demand = max(1, len(fs.queue))
                self._pending_creates[fn] = min(
                    self._pending_creates.get(fn, 0) + 1, demand)
            else:
                self.dropped += 1          # static cluster full: creation fails
            return
        inst = _Instance(next(self._iid), fn, node, fs.policy.container_concurrency, mem)
        fs.instances.append(inst)
        fs.starting += 1
        # an eviction-killed instance's recreate is eviction-storm CPU, not
        # ordinary churn: each kill registers one debt unit, drained by the
        # next create (the fluid twin drains ``evict_deficit`` identically)
        evict_recreate = self._evict_debt.get(fn, 0) > 0
        if evict_recreate:
            self._evict_debt[fn] -= 1
            if self._evict_debt[fn] <= 0:
                del self._evict_debt[fn]
        if self._measuring(t):
            self.creations += 1
            self.cpu_worker += self.cfg.cpu_create_worker_s
            self.cpu_master += self.cfg.cpu_create_master_s
            cpu = self.cfg.cpu_create_worker_s + self.cfg.cpu_create_master_s
            if evict_recreate:
                self.att_evict += cpu
            else:
                self.att_create += cpu
        delay = self.cfg.cold_start_s * (1 + self.cfg.cold_start_jitter * self.rng.uniform(-1, 1))
        delay *= inst.node.slowdown
        if self.obs:
            inst.csid = self.obs.begin(
                "instance_create", "instance", t, pid="instances",
                tid=inst.iid, fn=fn, node=node.node_id,
                evict_recreate=evict_recreate)
        self._push(t + delay, "ready", inst)

    def _teardown(self, t: float, inst: _Instance, reason: str = "keepalive"):
        if inst.state == "dead":
            return
        if inst.state == "starting":
            self.fns[inst.fn].starting -= 1
        inst.state = "dead"
        fs = self.fns[inst.fn]
        if inst in fs.instances:
            fs.instances.remove(inst)
        self.cluster.release(inst.node, inst.memory_mb)
        evicting = self._node_evicting(inst.node)
        if self._measuring(t):
            self.teardowns += 1
            # graceful-teardown CPU stays in the master_control residual of
            # the attribution ledger (it is control-plane/kubelet work, and
            # the engines disagree on WHEN idle mass sheds around the
            # measurement boundary — pairing it with creation would
            # concentrate that timing skew in one component)
            self.cpu_worker += self.cfg.cpu_teardown_worker_s
            self.cpu_master += self.cfg.cpu_teardown_master_s
        if self.obs:
            if inst.csid >= 0:
                self.obs.end(inst.csid, t, aborted=True)
                inst.csid = -1
            self.obs.emit("teardown", "instance", t,
                          t + self.cfg.teardown_s, pid="instances",
                          tid=inst.iid, fn=inst.fn,
                          reason="evict_notice" if evicting else reason)

    def _schedule_expire(self, t: float, inst: _Instance):
        fs = self.fns[inst.fn]
        ka = fs.policy.keepalive(t)
        if math.isinf(ka):
            return
        inst.expire_version += 1
        self._push(t + ka, "expire", (inst, inst.expire_version))

    # -- dispatch ----------------------------------------------------------------------

    def _free_inst(self, fs: _FnState) -> Optional[_Instance]:
        return next((i for i in fs.instances
                     if i.state == "up" and i.in_flight < i.cc
                     and i.node.state == UP), None)

    def _dispatch(self, t: float, inst: _Instance, rec: RequestRecord):
        rec.start = t + self.cfg.warm_latency_s
        inst.in_flight += 1
        inst.idle_since = math.nan
        service = rec.dur * inst.node.slowdown + self.cfg.warm_latency_s
        self._push(t + service, "done", (inst, rec))
        if self._measuring(t):
            self.cpu_master += self.cfg.cpu_request_s
        if self.obs and rec.sid >= 0:
            if rec.qsid >= 0:
                self.obs.end(rec.qsid, rec.start)
                rec.qsid = -1
            rec.xsid = self.obs.begin(
                "execute", "request", rec.start, pid="requests",
                tid=self.obs.spans[rec.sid].tid, parent=rec.sid,
                fn=rec.fn, cold=rec.cold, instance=inst.iid)

    def _drain_queue(self, t: float, fs: _FnState):
        while fs.queue:
            inst = self._free_inst(fs)
            if inst is None:
                return
            self._dispatch(t, inst, fs.queue.popleft())

    # -- event handlers ----------------------------------------------------------------

    def _on_arrival(self, t: float, rec: RequestRecord):
        fs = self.fns[rec.fn]
        if self.obs:
            rec.sid = self.obs.begin("request", "request", t, pid="requests",
                                     tid=next(self._rid), fn=rec.fn)
        decision = fs.policy.on_arrival(
            t, fs.idle_count, fs.busy_free_slots, fs.starting, len(fs.queue))
        for _ in range(decision.create):
            self._create_instance(t, rec.fn)
        inst = self._free_inst(fs)
        if inst is not None:
            self._dispatch(t, inst, rec)
        else:
            rec.cold = True
            if self.obs and rec.sid >= 0:
                rec.qsid = self.obs.begin(
                    "queue", "request", t, pid="requests",
                    tid=self.obs.spans[rec.sid].tid, parent=rec.sid,
                    fn=rec.fn)
            fs.queue.append(rec)

    def _on_ready(self, t: float, inst: _Instance):
        if inst.state == "dead":
            return
        fs = self.fns[inst.fn]
        inst.state = "up"
        fs.starting -= 1
        inst.idle_since = t
        if self.obs and inst.csid >= 0:
            self.obs.end(inst.csid, t)
            inst.csid = -1
        self._drain_queue(t, fs)
        if inst.in_flight == 0:
            if inst.node.state == DRAINING:
                self._teardown(t, inst, reason="node_drain")
            else:
                self._schedule_expire(t, inst)

    def _on_done(self, t: float, payload):
        inst, rec = payload
        rec.end = t
        if self.obs and rec.sid >= 0:
            if rec.xsid >= 0:
                self.obs.end(rec.xsid, t)
                rec.xsid = -1
            self.obs.end(rec.sid, t, requeued=rec.requeued)
            rec.sid = -1
        if self._measuring(rec.arrival) and not math.isnan(rec.start):
            self.cpu_useful += rec.dur
        if self._measuring(rec.arrival):
            self.records.append(rec)
        if inst.state == "dead":
            return
        inst.in_flight -= 1
        fs = self.fns[inst.fn]
        self._drain_queue(t, fs)
        if inst.in_flight == 0 and inst.state == "up":
            if inst.node.state == DRAINING:
                self._teardown(t, inst, reason="node_drain")
            else:
                inst.idle_since = t
                self._schedule_expire(t, inst)

    def _on_expire(self, t: float, payload):
        inst, version = payload
        if inst.state != "up" or inst.in_flight > 0 or inst.expire_version != version:
            return
        idle_for = t - inst.idle_since
        if self.fns[inst.fn].policy.on_idle_expired(t, idle_for):
            self._teardown(t, inst)

    def _retry_pending_creates(self, t: float):
        pend, self._pending_creates = self._pending_creates, {}
        for fn, count in pend.items():
            for _ in range(count):
                self._create_instance(t, fn)

    def _pending_pressure_mb(self) -> float:
        return sum(count * (self.trace.profile.memory_mb[fn]
                            + self.cfg.instance_overhead_mb)
                   for fn, count in self._pending_creates.items())

    def _on_node_ready(self, t: float, node):
        if self.fleet is None or not node.alive:
            return
        self.fleet.node_ready(node)
        self._retry_pending_creates(t)
        for fs in self.fns:
            self._drain_queue(t, fs)

    def _on_tick(self, t: float, _):
        total_mb = busy_mb = start_mb = 0.0
        n_idle = 0
        for fidx, fs in enumerate(self.fns):
            dec = fs.policy.on_tick(t, fs.concurrency,
                                    len(fs.instances) - fs.starting,
                                    fs.starting, fs.idle_count)
            for _ in range(dec.create):
                self._create_instance(t, fidx)
            if dec.retire:
                idles = sorted((i for i in fs.instances
                                if i.state == "up" and i.in_flight == 0),
                               key=lambda i: i.idle_since)
                for inst in idles[:dec.retire]:
                    self._teardown(t, inst, reason="retire")
            for i in fs.instances:
                total_mb += i.memory_mb
                if i.in_flight > 0:
                    busy_mb += i.memory_mb
                elif i.state == "up":
                    n_idle += 1
                elif i.state == "starting":
                    start_mb += i.memory_mb
        if self.fleet is not None:
            self._fleet_tick(t)
        if self._measuring(t):
            alive_nodes = self.cluster.billable_count
            self.cpu_worker += (n_idle * self.cfg.cpu_idle_per_s
                                + alive_nodes * self.cfg.cpu_worker_floor_per_node_s
                                ) * self.cfg.tick_s
            self.cpu_master += self.cfg.cpu_master_floor_per_s * self.cfg.tick_s
            self.att_idle += n_idle * self.cfg.cpu_idle_per_s * self.cfg.tick_s
            self.mem_total.append(total_mb)
            self.mem_busy.append(busy_mb)
            self.mem_start.append(start_mb)
            self.sample_t.append(t)

    def _fleet_tick(self, t: float):
        fleet = self.fleet
        # retry deferrals against existing capacity first; what still cannot
        # place is this tick's scale-up pressure
        if self._pending_creates:
            self._retry_pending_creates(t)
        fleet.note_pressure(self._pending_pressure_mb())
        provisioned, draining = fleet.reconcile(t, self.cluster)
        for node in provisioned:
            if self.obs:
                self.obs.emit("node_provision", "node", t,
                              t + fleet.node_type.provision_s, pid="nodes",
                              tid=node.node_id, spot=node.spot)
            self._push(t + fleet.node_type.provision_s, "node_ready", node)
        if draining:
            if self.obs:
                for node in draining:
                    if node.node_id not in self._drain_sids:
                        self._drain_sids[node.node_id] = self.obs.begin(
                            "node_drain", "node", t, pid="nodes",
                            tid=node.node_id,
                            evict=self._node_evicting(node))
            # idle and still-starting instances on a draining node are torn
            # down now (busy ones finish via _on_done); demand they were
            # covering re-registers as a deferred create so it lands on a
            # kept node
            drain_set = set(id(n) for n in draining)
            for fidx, fs in enumerate(self.fns):
                for inst in [i for i in fs.instances
                             if id(i.node) in drain_set and i.in_flight == 0
                             and i.state in ("up", "starting")]:
                    was_starting = inst.state == "starting"
                    if self._node_evicting(inst.node):
                        # an evicted warm/starting instance's replacement
                        # cold start is eviction-storm work
                        self._evict_debt[fidx] = \
                            self._evict_debt.get(fidx, 0) + 1
                    self._teardown(t, inst, reason="scale_down")
                    if was_starting and fs.queue:
                        self._pending_creates[fidx] = min(
                            self._pending_creates.get(fidx, 0) + 1,
                            len(fs.queue))
        # spot preemptions announced this tick: the node is already
        # draining (idle instances torn down above); whatever is still
        # busy at the notice deadline is force-evicted
        for node, deadline in fleet.pop_evictions():
            self._push(deadline, "node_evict", node)
        for node in (fleet.maybe_reclaim(self.cluster) or ()):
            sid = self._drain_sids.pop(node.node_id, -1)
            if self.obs and sid >= 0:
                self.obs.end(sid, t, reclaimed=True)
        if self._measuring(t):
            billed = fleet.bill(self.cluster, self.cfg.tick_s)
            self.node_seconds += billed * self.cfg.tick_s
            self.node_samples.append(billed)

    def _kill_node_instances(self, t: float, node, evict: bool = False):
        """Mark every instance on ``node`` dead (abrupt death: teardowns
        counted, no graceful-teardown CPU) — shared by node failures and
        forced spot evictions.  An eviction registers one unit of
        ``_evict_debt`` per kill so the replacement cold start is
        attributed to the storm."""
        for fs in self.fns:
            dead = [i for i in fs.instances if i.node is node]
            for inst in dead:
                if inst.state == "starting":
                    fs.starting -= 1
                inst.state = "dead"
                fs.instances.remove(inst)
                if evict:
                    self._evict_debt[inst.fn] = \
                        self._evict_debt.get(inst.fn, 0) + 1
                if self._measuring(t):
                    self.teardowns += 1
                if self.obs:
                    if inst.csid >= 0:
                        self.obs.end(inst.csid, t, aborted=True)
                        inst.csid = -1
                    self.obs.instant(
                        "instance_evicted" if evict else "instance_failed",
                        "instance", t, pid="instances", tid=inst.iid,
                        fn=inst.fn)

    def _requeue_inflight(self, t: float, node):
        """Re-queue the in-flight requests of ``node``'s dead instances
        (their pending 'done' events are dropped); scanning the event heap
        is O(E) but failures/evictions are rare events."""
        new_events = []
        for ev in self._events:
            tt, c, kind, payload = ev
            if kind == "done" and payload[0].node is node \
                    and payload[0].state == "dead":
                rec = payload[1]
                rec.requeued += 1
                if self.obs and rec.sid >= 0:
                    if rec.xsid >= 0:
                        self.obs.end(rec.xsid, t, evicted=True)
                        rec.xsid = -1
                    rec.qsid = self.obs.begin(
                        "queue", "request", t, pid="requests",
                        tid=self.obs.spans[rec.sid].tid, parent=rec.sid,
                        fn=rec.fn, requeue=rec.requeued)
                fs = self.fns[rec.fn]
                dec = fs.policy.on_arrival(t, fs.idle_count,
                                           fs.busy_free_slots, fs.starting,
                                           len(fs.queue))
                for _ in range(dec.create):
                    self._create_instance(t, rec.fn)
                fs.queue.append(rec)
            else:
                new_events.append(ev)
        heapq.heapify(new_events)
        self._events = new_events

    def _on_node_evict(self, t: float, node):
        """The reclaim notice expired: the provider takes the spot node
        back.  Instances still on it die abruptly; their in-flight
        requests re-queue and re-trigger creation — the eviction-driven
        cold-start storm."""
        fleet = self.fleet
        if fleet is None or not node.alive or node.state == GONE:
            return                      # drained empty and reclaimed already
        self._kill_node_instances(t, node, evict=True)
        self._requeue_inflight(t, node)
        fleet.force_evict(node, self.cluster)
        if self.obs:
            sid = self._drain_sids.pop(node.node_id, -1)
            if sid >= 0:
                self.obs.end(sid, t, evicted=True)
            self.obs.instant("node_evict", "node", t, pid="nodes",
                             tid=node.node_id)
        for fs in self.fns:
            self._drain_queue(t, fs)

    def _on_fail(self, t: float, node_id: int):
        node = self.cluster.fail_node(node_id)
        self._kill_node_instances(t, node)
        self._requeue_inflight(t, node)
        for fs in self.fns:
            self._drain_queue(t, fs)
