"""Request-lifecycle and node-lifecycle spans for the discrete-event oracle.

A copy of ``repro.obs.spans`` (no jax), kept so that the port's
``ControlPlane(obs=...)`` works without importing ``repro``.

A ``Span`` is one timed interval on a named track: a request's queue wait,
an instance's cold start, a node's provision/drain window.  ``SpanRecorder``
collects them with near-zero cost when disabled (the instrumented code
guards every call behind ``if rec:``, and a disabled recorder is falsy), and
exports the collected tree as Chrome-trace / Perfetto JSON
(``chrome_trace``): load ``trace.json`` at https://ui.perfetto.dev or
chrome://tracing.

Span trees are real trees — each span carries a ``parent`` span id — so
``validate`` can check structural invariants (every span closed,
non-negative duration, children nested inside their parent) independent of
the track layout the viewer shows.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

# nesting tolerance: the oracle timestamps children at event granularity,
# so a child may start/end within float rounding of its parent's bounds
_EPS = 1e-6


@dataclasses.dataclass
class Span:
    sid: int
    name: str
    cat: str                    # request | instance | node
    t0: float
    t1: Optional[float]         # None while open
    pid: str                    # process track ("requests", "instances", ...)
    tid: int                    # thread track within the process
    parent: Optional[int]       # parent span id (the tree edge)
    args: dict

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else float("nan")


class SpanRecorder:
    """Collects spans; a disabled recorder is falsy so instrumented code
    pays one truthiness check per site (``if rec: rec.begin(...)``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.spans: list[Span] = []
        self._open: dict[int, Span] = {}
        self._next = 0

    def __bool__(self) -> bool:
        return self.enabled

    def begin(self, name: str, cat: str, t: float, *, pid: str, tid: int,
              parent: Optional[int] = None, **args) -> int:
        sid = self._next
        self._next += 1
        sp = Span(sid, name, cat, float(t), None, pid, int(tid), parent, args)
        self.spans.append(sp)
        self._open[sid] = sp
        return sid

    def end(self, sid: int, t: float, **args) -> None:
        sp = self._open.pop(sid, None)
        if sp is None:
            return                       # already closed (or never opened)
        sp.t1 = float(t)
        if args:
            sp.args.update(args)

    def emit(self, name: str, cat: str, t0: float, t1: float, *, pid: str,
             tid: int, parent: Optional[int] = None, **args) -> int:
        sid = self.begin(name, cat, t0, pid=pid, tid=tid, parent=parent,
                         **args)
        self.end(sid, t1)
        return sid

    def instant(self, name: str, cat: str, t: float, *, pid: str, tid: int,
                **args) -> None:
        # represented as a zero-duration span; chrome_trace exports "i"
        sid = self.emit(name, cat, t, t, pid=pid, tid=tid, **args)
        self.spans[sid].args["_instant"] = True

    def finish(self, t: float) -> int:
        """Close every still-open span at ``t`` (end of run), tagging it
        ``truncated`` — a request still queued when the trace ends, an
        instance still starting.  Returns how many were closed."""
        n = len(self._open)
        for sid in list(self._open):
            self.end(sid, t, truncated=True)
        return n

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object ({"traceEvents": [...]}):
        "X" complete events (timestamps in microseconds), one Perfetto
        process per ``pid`` string, named via metadata events."""
        pids: dict[str, int] = {}
        events = []
        for sp in self.spans:
            pid = pids.setdefault(sp.pid, len(pids) + 1)
            args = {k: v for k, v in sp.args.items() if k != "_instant"}
            base = {"name": sp.name, "cat": sp.cat, "pid": pid,
                    "tid": sp.tid, "ts": sp.t0 * 1e6, "args": args}
            if sp.args.get("_instant"):
                events.append({**base, "ph": "i", "s": "t"})
            else:
                t1 = sp.t1 if sp.t1 is not None else sp.t0
                events.append({**base, "ph": "X",
                               "dur": max(t1 - sp.t0, 0.0) * 1e6})
        meta = [{"name": "process_name", "ph": "M", "pid": i, "tid": 0,
                 "args": {"name": name}} for name, i in pids.items()]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def write_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)


def validate(rec: SpanRecorder) -> list[str]:
    """Structural invariants of the span tree; returns problem strings
    (empty = well-formed): every span closed, durations non-negative,
    children nested inside their parent's interval."""
    problems = []
    by_id = {sp.sid: sp for sp in rec.spans}
    for sp in rec.spans:
        if sp.t1 is None:
            problems.append(f"span {sp.sid} ({sp.name}) never closed")
            continue
        if sp.t1 < sp.t0 - _EPS:
            problems.append(f"span {sp.sid} ({sp.name}) negative duration "
                            f"{sp.t1 - sp.t0:.6g}")
        if sp.parent is not None:
            par = by_id.get(sp.parent)
            if par is None:
                problems.append(f"span {sp.sid} ({sp.name}) dangling parent "
                                f"{sp.parent}")
            elif par.t1 is not None and (sp.t0 < par.t0 - _EPS
                                         or sp.t1 > par.t1 + _EPS):
                problems.append(
                    f"span {sp.sid} ({sp.name}) [{sp.t0:.6g},{sp.t1:.6g}] "
                    f"outside parent {par.sid} ({par.name}) "
                    f"[{par.t0:.6g},{par.t1:.6g}]")
    return problems
