"""Composable trace transforms — the algebra under the scenario registry.

Each transform is a small frozen dataclass mapping ``Trace -> Trace``; a
scenario layers several of them on one synthesized base trace.  Positions
and periods are expressed as *fractions of the trace duration* so the same
transform stack survives ``Scenario.build_trace(scale=...)`` shrinking (the
CI smoke path) and full production scale unchanged.

Transforms that need fresh randomness (thinning, replication jitter,
splicing in an alternative arrival realization) draw it from a generator
seeded by the scenario, so scenario traces are reproducible end to end.

A copy of ``repro.scenarios.transforms`` (numpy only); the two must stay
identical in behaviour.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trace import Trace, TraceConfig, merge_traces, synthesize


class Transform:
    """Protocol: ``__call__(trace, cfg, rng) -> Trace`` where *cfg* is the
    (possibly scale-shrunk) TraceConfig the trace was synthesized from."""

    def __call__(self, trace: Trace, cfg: TraceConfig,
                 rng: np.random.Generator) -> Trace:
        raise NotImplementedError


def _resorted(trace: Trace, t, fn, dur, duration_s=None) -> Trace:
    order = np.argsort(t, kind="stable")
    return Trace(np.asarray(t)[order], np.asarray(fn, np.int32)[order],
                 np.asarray(dur)[order], trace.profile,
                 trace.duration_s if duration_s is None else duration_s)


@dataclasses.dataclass(frozen=True)
class TimeWarp(Transform):
    """Monotone remap of arrival times g(t) = t - A sin(2πt/period + φ):
    local arrival rate is multiplied by 1/g'(t) ∈ [1/(1+depth), 1/(1-depth)],
    so the SAME invocations arrive in diurnal waves — total load is
    preserved, only its placement in time changes (Shahrad'20's diurnal
    cycles).  ``phase`` shifts where in the cycle the run starts; the
    multi-region cells layer (repro_torch.cells) staggers it per cell to model
    follow-the-sun offsets.  phase=0 is the historical transform exactly."""
    period_frac: float = 0.5       # cycle length as a fraction of duration
    depth: float = 0.8             # 0 = identity; must stay < 1 for monotone g
    phase: float = 0.0             # radians; per-cell follow-the-sun offset

    def __call__(self, trace, cfg, rng):
        period = max(self.period_frac * trace.duration_s, 1e-9)
        amp = self.depth * period / (2 * np.pi)
        t = trace.t - amp * np.sin(2 * np.pi * trace.t / period + self.phase)
        t = np.clip(t, 0.0, trace.duration_s)
        return _resorted(trace, t, trace.fn, trace.dur)


@dataclasses.dataclass(frozen=True)
class RateScale(Transform):
    """Scale aggregate load by ``factor``: < 1 thins arrivals Bernoulli-wise,
    > 1 replicates each arrival (integer part + Bernoulli fraction) with a
    small time jitter so replicas don't collide on one tick."""
    factor: float = 1.0
    jitter_s: float = 1.0

    def __call__(self, trace, cfg, rng):
        if self.factor == 1.0:
            return trace
        n = len(trace)
        copies = np.full(n, int(self.factor), np.int64)
        copies += rng.uniform(size=n) < (self.factor - int(self.factor))
        idx = np.repeat(np.arange(n), copies)
        t = trace.t[idx].copy()
        # the first copy of each arrival keeps its time; replicas get jitter
        extra = np.concatenate([[False], idx[1:] == idx[:-1]])
        t[extra] += rng.uniform(0, self.jitter_s, int(extra.sum()))
        t = np.clip(t, 0.0, trace.duration_s)
        return _resorted(trace, t, trace.fn[idx], trace.dur[idx])


@dataclasses.dataclass(frozen=True)
class Splice(Transform):
    """Head/tail splice: keep arrivals before ``at_frac`` from the base
    trace and replace everything after with an independent arrival
    realization of the SAME function population (seed offset) — a regime
    change mid-experiment that breaks window-average assumptions."""
    at_frac: float = 0.5
    seed_offset: int = 104729

    def __call__(self, trace, cfg, rng):
        cut = self.at_frac * trace.duration_s
        alt = synthesize(dataclasses.replace(cfg, seed=cfg.seed + self.seed_offset),
                         profile=trace.profile)
        head = trace.t < cut
        tail = alt.t >= cut
        return _resorted(trace,
                         np.concatenate([trace.t[head], alt.t[tail]]),
                         np.concatenate([trace.fn[head], alt.fn[tail]]),
                         np.concatenate([trace.dur[head], alt.dur[tail]]))


@dataclasses.dataclass(frozen=True)
class BurstInject(Transform):
    """Flash crowd: inside [at_frac, at_frac + width_frac) the ``top_k``
    highest-rate functions receive ``factor``x their arrivals — existing
    window invocations are replicated with jitter, modelling a sudden
    external traffic spike concentrated on the popular head."""
    at_frac: float = 0.6
    width_frac: float = 0.05
    factor: float = 8.0
    top_k: int = 20

    def __call__(self, trace, cfg, rng):
        t0 = self.at_frac * trace.duration_s
        t1 = t0 + self.width_frac * trace.duration_s
        hot = np.argsort(trace.profile.rate)[-self.top_k:]
        in_burst = ((trace.t >= t0) & (trace.t < t1)
                    & np.isin(trace.fn, hot))
        reps = int(round(self.factor)) - 1
        if reps <= 0 or not in_burst.any():
            return trace
        idx = np.repeat(np.nonzero(in_burst)[0], reps)
        t = np.concatenate([trace.t, rng.uniform(t0, t1, len(idx))])
        fn = np.concatenate([trace.fn, trace.fn[idx]])
        dur = np.concatenate([trace.dur, trace.dur[idx]])
        return _resorted(trace, t, fn, dur)


@dataclasses.dataclass(frozen=True)
class TenantMerge(Transform):
    """Multi-tenant interference: synthesize a second function population
    (``rps_frac`` of the base aggregate rate) and interleave it onto the
    same cluster, re-keying its function ids past the base population."""
    num_functions_frac: float = 0.5
    rps_frac: float = 0.5
    seed_offset: int = 7919

    def __call__(self, trace, cfg, rng):
        other_cfg = dataclasses.replace(
            cfg,
            num_functions=max(1, int(cfg.num_functions * self.num_functions_frac)),
            target_total_rps=cfg.target_total_rps * self.rps_frac,
            seed=cfg.seed + self.seed_offset)
        return merge_traces(trace, synthesize(other_cfg))


def apply_transforms(trace: Trace, cfg: TraceConfig,
                     transforms, seed: int = 0) -> Trace:
    rng = np.random.default_rng(seed ^ 0x5CE7A110)
    for tf in transforms:
        trace = tf(trace, cfg, rng)
    return trace
