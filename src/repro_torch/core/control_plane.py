"""The REAL control plane: router + queue + autoscaler reconciler.

Counterpart of ``repro.core.control_plane``: the same control plane over the
same policy objects (``repro_torch.core.policies``, a copy of the JAX
package's), with torch replicas as the real workers.  Workers are pluggable
(paper §3.4's KWOK methodology):

* ``SimWorkerBackend``  — virtual-clock workers (instance creation latency,
  per-request service times); the control plane logic is real, the workers
  are simulated.  This scales the control plane to thousands of instances.
* ``TorchWorkerBackend`` — real ``ModelReplica``s running actual torch model
  decode steps on one device (CUDA unless told otherwise); cold start =
  real weight init + first decode step.

The control plane is tick-driven and clock-agnostic: pass wall-clock now for
real serving, virtual now for simulation.

Two-level autoscaling: pass a fleet object (``repro.fleet.FleetManager`` in
the JAX package; anything with ``tick``, ``can_create`` and ``snapshot``)
and live instances are capped by current node capacity — creates beyond capacity are
deferred (never dropped) while placement pressure scales the node fleet up,
and billable node-seconds are metered for the cost model.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from collections import deque
from typing import Optional, Protocol

from repro_torch.core.policies import Policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.engine import ModelReplica, ServeRequest


class WorkerBackend(Protocol):
    def create_instance(self, fn: int, now: float) -> int: ...
    def poll_ready(self, now: float) -> list[int]: ...
    def dispatch(self, iid: int, req: ServeRequest, now: float) -> None: ...
    def poll_completions(self, now: float) -> list[tuple[int, ServeRequest]]: ...
    def teardown(self, iid: int, now: float) -> None: ...
    def memory_bytes(self, iid: int) -> int: ...


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------


class SimWorkerBackend:
    """KWOK-style simulated workers under a virtual clock."""

    def __init__(self, cold_start_s: float = 1.0, instance_mem_bytes: int = 256 << 20,
                 service_time: Optional[dict] = None, default_service_s: float = 0.5):
        self._iid = itertools.count()
        self._ready_at: dict[int, float] = {}
        self._ready: set[int] = set()
        self._running: list[tuple[float, int, ServeRequest]] = []
        self.cold_start_s = cold_start_s
        self.mem = instance_mem_bytes
        self.service_time = service_time or {}
        self.default_service_s = default_service_s
        self.creations = 0
        self.teardowns = 0

    def create_instance(self, fn, now):
        iid = next(self._iid)
        self._ready_at[iid] = now + self.cold_start_s
        self.creations += 1
        return iid

    def poll_ready(self, now):
        out = [i for i, t in self._ready_at.items() if t <= now]
        for i in out:
            del self._ready_at[i]
            self._ready.add(i)
        return out

    def dispatch(self, iid, req, now):
        dur = self.service_time.get(req.fn, self.default_service_s)
        self._running.append((now + dur, iid, req))

    def poll_completions(self, now):
        done = [(i, r) for t, i, r in self._running if t <= now]
        self._running = [(t, i, r) for t, i, r in self._running if t > now]
        for _, r in done:
            r.done_t = now
        return done

    def teardown(self, iid, now):
        self._ready.discard(iid)
        self._ready_at.pop(iid, None)
        self.teardowns += 1

    def memory_bytes(self, iid):
        return self.mem


class TorchWorkerBackend:
    """Real replicas running real models (cold start = init + first step)."""

    def __init__(self, cfg, *, max_slots: int = 4, max_seq: int = 128,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self._iid = itertools.count()
        self.replicas: dict[int, ModelReplica] = {}
        self._fresh: list[int] = []
        self.creations = 0
        self.teardowns = 0
        self.cold_start_times: list[float] = []
        self._retired_steps = 0

    @property
    def decode_steps(self) -> int:
        """Decode steps run by every replica so far, torn-down ones included."""
        return self._retired_steps + sum(r.decode_steps for r in self.replicas.values())

    def create_instance(self, fn, now):
        iid = next(self._iid)
        rep = ModelReplica(self.cfg, max_slots=self.max_slots, max_seq=self.max_seq,
                           seed=iid, device=self.device)
        self.replicas[iid] = rep
        self._fresh.append(iid)
        self.creations += 1
        self.cold_start_times.append(rep.cold_start_s)
        return iid

    def poll_ready(self, now):
        out, self._fresh = self._fresh, []
        return out

    def dispatch(self, iid, req, now):
        if not self.replicas[iid].add(req, now):
            raise RuntimeError(f"instance {iid} has no free slot for request {req.rid}")

    def poll_completions(self, now):
        done = []
        for iid, rep in self.replicas.items():
            for r in rep.step(now):
                done.append((iid, r))
        return done

    def teardown(self, iid, now):
        rep = self.replicas.pop(iid, None)
        if rep is not None:
            self._retired_steps += rep.decode_steps
        self.teardowns += 1

    def memory_bytes(self, iid):
        rep = self.replicas.get(iid)
        return rep.memory_bytes() if rep else 0


# ---------------------------------------------------------------------------
# control plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Inst:
    iid: int
    fn: int
    state: str = "starting"        # starting | up
    in_flight: int = 0
    idle_since: float = math.nan


class ControlPlane:
    def __init__(self, backend: WorkerBackend, policy_factory, num_functions: int,
                 tick_s: float = 0.5, fleet=None, obs=None):
        self.backend = backend
        self.tick_s = tick_s
        self.fleet = fleet             # Optional fleet (tick/can_create/snapshot)
        self.obs = obs                 # Optional[repro_torch.obs.SpanRecorder]
        self.policies: list[Policy] = [policy_factory(f) for f in range(num_functions)]
        self.queues: list[deque] = [deque() for _ in range(num_functions)]
        self.instances: dict[int, _Inst] = {}
        self.by_fn: list[list[_Inst]] = [[] for _ in range(num_functions)]
        self.completed: list[ServeRequest] = []
        self._deferred_creates: deque = deque()
        self._last_tick = -math.inf
        # span bookkeeping: req.rid -> [request sid, queue sid, execute sid]
        # (-1 = closed/absent), iid -> open instance_create sid
        self._rspans: dict = {}
        self._cspans: dict[int, int] = {}
        self._rtid = itertools.count()

    # -- helpers ------------------------------------------------------------------

    def _idle(self, fn):
        return [i for i in self.by_fn[fn] if i.state == "up" and i.in_flight == 0]

    def _busy_free_slots(self, fn):
        """Spare request slots on instances already serving traffic."""
        cc = self.policies[fn].container_concurrency
        return sum(cc - i.in_flight for i in self.by_fn[fn]
                   if i.state == "up" and 0 < i.in_flight < cc)

    def _free_slot_inst(self, fn):
        cc = self.policies[fn].container_concurrency
        for i in self.by_fn[fn]:
            if i.state == "up" and i.in_flight < cc:
                return i
        return None

    def _create(self, fn, now):
        if self.fleet is not None and not self.fleet.can_create(len(self.instances)):
            # at node capacity: defer (retried each tick once the fleet has
            # scaled up) rather than over-committing the backend; clamp to
            # real queued demand so level-based policies re-issuing creates
            # every tick can't stack duplicate deferrals
            if self._deferred_creates.count(fn) < max(1, len(self.queues[fn])):
                self._deferred_creates.append(fn)
            return
        iid = self.backend.create_instance(fn, now)
        inst = _Inst(iid, fn)
        self.instances[iid] = inst
        self.by_fn[fn].append(inst)
        if self.obs:
            self._cspans[iid] = self.obs.begin(
                "instance_create", "instance", now, pid="instances",
                tid=iid, fn=fn)

    def _teardown(self, inst, now):
        self.backend.teardown(inst.iid, now)
        self.instances.pop(inst.iid, None)
        self.by_fn[inst.fn].remove(inst)
        if self.obs:
            sid = self._cspans.pop(inst.iid, -1)
            if sid >= 0:
                self.obs.end(sid, now, aborted=True)
            self.obs.instant("teardown", "instance", now, pid="instances",
                             tid=inst.iid, fn=inst.fn)

    def _dispatch(self, inst, req: ServeRequest, now: float):
        inst.in_flight += 1
        self.backend.dispatch(inst.iid, req, now)
        if self.obs and req.rid in self._rspans:
            sp = self._rspans[req.rid]
            if sp[1] >= 0:
                self.obs.end(sp[1], now)
                sp[1] = -1
            sp[2] = self.obs.begin(
                "execute", "request", now, pid="requests",
                tid=self.obs.spans[sp[0]].tid, parent=sp[0], fn=req.fn,
                cold=req.cold, instance=inst.iid)

    # -- API ------------------------------------------------------------------------

    def submit(self, req: ServeRequest, now: float):
        fn = req.fn
        pol = self.policies[fn]
        if self.obs:
            sid = self.obs.begin("request", "request", now, pid="requests",
                                 tid=next(self._rtid), fn=fn)
            self._rspans[req.rid] = [sid, -1, -1]
        starting = sum(1 for i in self.by_fn[fn] if i.state == "starting")
        dec = pol.on_arrival(now, len(self._idle(fn)), self._busy_free_slots(fn),
                             starting, len(self.queues[fn]))
        for _ in range(dec.create):
            self._create(fn, now)
        inst = self._free_slot_inst(fn)
        if inst is not None:
            self._dispatch(inst, req, now)
        else:
            req.cold = True
            if self.obs and req.rid in self._rspans:
                sp = self._rspans[req.rid]
                sp[1] = self.obs.begin(
                    "queue", "request", now, pid="requests",
                    tid=self.obs.spans[sp[0]].tid, parent=sp[0], fn=fn)
            self.queues[fn].append(req)

    def tick(self, now: float):
        # 0. node fleet: advance provisioning, reconcile capacity, then retry
        #    creates that were deferred at the old capacity
        if self.fleet is not None:
            self.fleet.tick(now, len(self.instances))
            deferred, self._deferred_creates = self._deferred_creates, deque()
            for fn in deferred:
                self._create(fn, now)
        # 1. newly ready instances
        for iid in self.backend.poll_ready(now):
            inst = self.instances.get(iid)
            if inst is None:
                continue
            inst.state = "up"
            inst.idle_since = now
            if self.obs:
                sid = self._cspans.pop(iid, -1)
                if sid >= 0:
                    self.obs.end(sid, now)
        # 2. completions free slots
        for iid, req in self.backend.poll_completions(now):
            self.completed.append(req)
            inst = self.instances.get(iid)
            if inst is not None:
                inst.in_flight = max(0, inst.in_flight - 1)
                if inst.in_flight == 0:
                    inst.idle_since = now
            if self.obs:
                sp = self._rspans.pop(req.rid, None)
                if sp is not None:
                    if sp[2] >= 0:
                        self.obs.end(sp[2], now)
                    self.obs.end(sp[0], now)
        # 3. drain queues into free slots
        for fn, q in enumerate(self.queues):
            while q:
                inst = self._free_slot_inst(fn)
                if inst is None:
                    break
                self._dispatch(inst, q.popleft(), now)
        # 4. policy reconciliation + keepalive expiry
        for fn, pol in enumerate(self.policies):
            conc = sum(i.in_flight for i in self.by_fn[fn]) + len(self.queues[fn])
            starting = sum(1 for i in self.by_fn[fn] if i.state == "starting")
            up = sum(1 for i in self.by_fn[fn] if i.state == "up")
            idle = self._idle(fn)
            dec = pol.on_tick(now, conc, up, starting, len(idle))
            for _ in range(dec.create):
                self._create(fn, now)
            for inst in sorted(idle, key=lambda i: i.idle_since)[:dec.retire]:
                self._teardown(inst, now)
            ka = pol.keepalive(now)
            if not math.isinf(ka):
                for inst in list(self._idle(fn)):
                    if now - inst.idle_since > ka \
                            and pol.on_idle_expired(now, now - inst.idle_since):
                        self._teardown(inst, now)
        self._last_tick = now

    # -- observability -----------------------------------------------------------------

    def snapshot(self) -> dict:
        total_mem = sum(self.backend.memory_bytes(i) for i in self.instances)
        busy_mem = sum(self.backend.memory_bytes(iid)
                       for iid, inst in self.instances.items() if inst.in_flight > 0)
        snap = {
            "instances": len(self.instances),
            "starting": sum(1 for i in self.instances.values() if i.state == "starting"),
            "queued": sum(len(q) for q in self.queues),
            "deferred_creates": len(self._deferred_creates),
            "memory_bytes": total_mem,
            "busy_memory_bytes": busy_mem,
        }
        if self.fleet is not None:
            snap["fleet"] = self.fleet.snapshot()
        return snap
