"""Pareto machinery for the frontier engine (pure, engine-agnostic).

A copy of ``repro.opt.frontier`` (pure Python), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Three reducers over metric rows (dicts), all minimizing both axes:

* ``pareto_front``      — the non-dominated subset (the canonical
  implementation; ``repro_torch.fleet.sweep`` builds on it);
* ``epsilon_survivors`` — the front plus every point within a relative
  ``eps`` band of it, capped — the successive-halving survivor rule;
* ``robust_front``      — given per-scenario row sets sharing point ids,
  the points dominated in NO scenario (the cross-scenario frontier: a
  config you can deploy without knowing which workload you'll get).

Rows with non-finite values on either axis are ignored: a NaN slowdown
(e.g. a shrunk trace where no function clears the minimum request count)
compares False against everything and would otherwise pollute the front.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

X_DEFAULT = "cost_per_million"
Y_DEFAULT = "slowdown_geomean_p99"


def _finite(rows: Sequence[dict], x: str, y: str) -> list[dict]:
    return [r for r in rows
            if math.isfinite(r.get(x, math.nan))
            and math.isfinite(r.get(y, math.nan))]


def pareto_front(rows: Sequence[dict], x: str = X_DEFAULT,
                 y: str = Y_DEFAULT) -> list[dict]:
    """Non-dominated subset (minimize both axes), sorted by x.  Ties on both
    axes survive together (neither strictly improves on the other)."""
    rows = _finite(rows, x, y)
    out = [r for r in rows
           if not any(o[x] <= r[x] and o[y] <= r[y]
                      and (o[x] < r[x] or o[y] < r[y]) for o in rows)]
    return sorted(out, key=lambda r: (r[x], r[y]))


def frontier_slack(row: dict, front: Sequence[dict], x: str = X_DEFAULT,
                   y: str = Y_DEFAULT) -> float:
    """How far a row sits from a front, as the smallest uniform relative
    inflation that makes some front point dominate it: min over front of
    max(r.x/f.x, r.y/f.y).  1.0 on the front; 1.2 = within 20%.  Assumes
    positive metrics (cost > 0, slowdown >= 1).  An EMPTY front (every
    candidate demoted or NaN) yields ``inf`` — nothing is "on" a front
    that does not exist, so downstream on_front checks read False instead
    of silently passing."""
    if not front:
        return math.inf
    return min(max(row[x] / max(f[x], 1e-12), row[y] / max(f[y], 1e-12))
               for f in front)


def epsilon_survivors(rows: Sequence[dict], x: str = X_DEFAULT,
                      y: str = Y_DEFAULT, eps: float = 0.15,
                      cap: int = 12) -> list[dict]:
    """Successive-halving survivor rule: every point within ``eps`` relative
    slack of the Pareto front, nearest-first, at most ``cap`` points.  The
    band keeps coarse-stage near-ties alive — a point 5% off the 0.1x front
    may win at full scale, where transients the shrunk trace cannot express
    (provisioning pipelines, burst widths) are resolved."""
    rows = _finite(rows, x, y)
    front = pareto_front(rows, x, y)
    ranked = sorted(rows, key=lambda r: frontier_slack(r, front, x, y))
    return [r for r in ranked
            if frontier_slack(r, front, x, y) <= 1.0 + eps][:cap]


def hypervolume(rows: Sequence[dict], x_ref: float, y_ref: float,
                x: str = X_DEFAULT, y: str = Y_DEFAULT) -> float:
    """Dominated-area hypervolume of the rows' Pareto front w.r.t. the
    reference point ``(x_ref, y_ref)`` (both axes minimized).

    One scalar that shrinks when the frontier retreats ANYWHERE — the
    multi-objective regression signal bench-smoke tracks per scenario over
    time (ROADMAP: "multi-objective CI tracking"): a point-wise metric gate
    misses a front that got strictly worse in the middle while its
    endpoints held.  Points at or beyond the reference contribute nothing;
    0.0 means no row dominates the reference point at all.

    An empty or all-non-finite row set returns ``nan`` — PR 7's
    zero-completion convention: "the measurement does not exist" must
    stay distinguishable from "a frontier exists but dominates nothing"
    (a genuine 0.0), or a scenario whose every candidate failed would
    read as a mere regression instead of a broken run."""
    if not _finite(rows, x, y):
        return math.nan
    front = [r for r in pareto_front(rows, x, y)
             if r[x] < x_ref and r[y] < y_ref]
    hv, y_prev = 0.0, y_ref
    for r in front:                       # sorted by x ascending, y descending
        hv += (x_ref - r[x]) * (y_prev - r[y])
        y_prev = r[y]
    return hv


def robust_front(rows_by_scenario: Mapping[str, Sequence[dict]],
                 x: str = X_DEFAULT, y: str = Y_DEFAULT,
                 key: str = "point_id") -> list:
    """Cross-scenario robust frontier: the point ids evaluated in EVERY
    scenario that are dominated in NONE of them.

    Per-scenario fronts answer "what is optimal for this workload"; their
    intersection-of-non-dominance answers "what is never a mistake" — the
    paper's closing object, a configuration whose cost/performance trade
    cannot be strictly beaten no matter which scenario materializes.
    Dominance inside each scenario is judged against that scenario's FULL
    row set, so a robust point must survive specialists it will never see
    elsewhere.  Returns ids sorted for determinism; [] when the scenario
    sets share no points."""
    if not rows_by_scenario:
        return []
    per = {name: _finite(rows, x, y)
           for name, rows in rows_by_scenario.items()}
    common = None
    for rows in per.values():
        ids = {r[key] for r in rows}
        common = ids if common is None else common & ids
    out = []
    for pid in common or ():
        dominated = False
        for rows in per.values():
            r = next(rr for rr in rows if rr[key] == pid)
            if any(o[x] <= r[x] and o[y] <= r[y]
                   and (o[x] < r[x] or o[y] < r[y]) for o in rows):
                dominated = True
                break
        if not dominated:
            out.append(pid)
    return sorted(out)
