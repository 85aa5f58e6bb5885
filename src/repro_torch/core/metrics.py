"""The paper's metric suite (§3.6).

A copy of ``repro.core.metrics`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

* end-to-end performance: geometric mean over functions of the per-function
  99th-percentile slowdown ((end - arrival) / pure duration); 1.0 = unloaded.
* normalized memory usage: time-averaged total instance memory / time-averaged
  memory of instances actively serving a request.
* instance creation rate (events/s over the measurement window).
* normalized CPU overhead: system CPU (worker + master) / useful function CPU,
  plus the worker/master breakdown (paper: ~80/20).

Beyond-paper: when a node fleet (repro_torch.fleet) is attached, the result also
carries node-hours and the mean billable node count, the inputs to the
dollar-cost model in ``repro_torch.fleet.costs``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.eventsim import SimResult


@dataclasses.dataclass
class Metrics:
    slowdown_geomean_p99: float
    normalized_memory: float
    creation_rate: float
    cpu_overhead: float
    cpu_overhead_worker: float
    cpu_overhead_master: float
    worker_share: float
    queueing_p50: float
    queueing_p99: float
    cold_fraction: float
    completed: int
    # requests the static cluster refused (creation failed, nothing queued
    # them).  Non-zero dropped explains NaN queueing/cold columns: an
    # all-drop run has no records at all, which would otherwise read as
    # silently "no data".
    dropped: int = 0
    # node-fleet layer (NaN/0 when simulating a static cluster)
    nodes_mean: float = math.nan
    node_hours: float = 0.0
    node_provisions: int = 0
    node_terminations: int = 0
    # spot tier (0 for an on-demand-only fleet)
    spot_node_hours: float = 0.0
    node_evictions: int = 0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def per_function_p99_slowdown(result: SimResult, min_requests: int = 5) -> np.ndarray:
    """Vectorized sort/groupby: one lexsort over (fn, slowdown), then each
    function's p99 by linear interpolation inside its sorted run — exactly
    ``np.percentile(v, 99)`` per group, without the per-record Python loop
    (the fig9-scale oracle replay has ~3.5M records)."""
    n = len(result.records)
    if n == 0:
        return np.zeros(0)
    fn = np.fromiter((r.fn for r in result.records), np.int64, n)
    arrival = np.fromiter((r.arrival for r in result.records), np.float64, n)
    end = np.fromiter((r.end for r in result.records), np.float64, n)
    dur = np.fromiter((r.dur for r in result.records), np.float64, n)
    ok = ~np.isnan(end)
    slow = np.maximum((end[ok] - arrival[ok]) / np.maximum(dur[ok], 1e-6), 1.0)
    fn = fn[ok]
    if not len(fn):
        return np.zeros(0)
    order = np.lexsort((slow, fn))
    fn, slow = fn[order], slow[order]
    starts = np.flatnonzero(np.r_[True, fn[1:] != fn[:-1]])
    counts = np.diff(np.r_[starts, len(fn)])
    keep = counts >= min_requests
    starts, counts = starts[keep], counts[keep]
    pos = starts + 0.99 * (counts - 1)       # percentile index, per group
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, starts + counts - 1)
    frac = pos - lo
    return slow[lo] * (1.0 - frac) + slow[hi] * frac


def compute(result: SimResult) -> Metrics:
    slows = per_function_p99_slowdown(result)
    geo = float(np.exp(np.mean(np.log(np.maximum(slows, 1.0))))) if len(slows) else math.nan

    total = result.mem_samples_total_mb
    busy = result.mem_samples_busy_mb
    norm_mem = float(total.mean() / max(busy.mean(), 1e-9)) if len(total) else math.nan

    window = max(result.measure_window_s, 1e-9)
    rate = result.creations / window

    useful = max(result.cpu_useful_s, 1e-9)
    w = result.cpu_worker_overhead_s
    m = result.cpu_master_overhead_s
    qd = np.asarray([r.start - r.arrival for r in result.records
                     if not math.isnan(r.start)])
    colds = np.asarray([r.cold for r in result.records], dtype=bool)

    return Metrics(
        slowdown_geomean_p99=geo,
        normalized_memory=norm_mem,
        creation_rate=rate,
        cpu_overhead=(w + m) / useful,
        cpu_overhead_worker=w / useful,
        cpu_overhead_master=m / useful,
        worker_share=w / max(w + m, 1e-9),
        queueing_p50=float(np.percentile(qd, 50)) if len(qd) else math.nan,
        queueing_p99=float(np.percentile(qd, 99)) if len(qd) else math.nan,
        cold_fraction=float(colds.mean()) if len(colds) else math.nan,
        completed=len(result.records),
        dropped=result.dropped,
        nodes_mean=float(result.node_samples.mean())
        if len(result.node_samples) else math.nan,
        node_hours=result.node_seconds / 3600.0,
        node_provisions=result.node_provisions,
        node_terminations=result.node_terminations,
        spot_node_hours=result.spot_node_seconds / 3600.0,
        node_evictions=result.node_evictions,
    )


def queueing_cdf(result: SimResult, points: int = 200):
    qd = np.sort(np.asarray([r.start - r.arrival for r in result.records
                             if not math.isnan(r.start)]))
    if len(qd) == 0:
        return np.zeros(0), np.zeros(0)
    idx = np.linspace(0, len(qd) - 1, points).astype(int)
    return qd[idx], (idx + 1) / len(qd)
