"""Azure-Functions-like workload synthesis + In-Vitro-style sampling.

A copy of ``repro.core.trace`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The paper replays a 400-function sample (300k invocations / 80 min) and a
2000-function sample (3.5M invocations) of the Azure Functions trace
[Shahrad'20] produced with In-Vitro [Ustiugov'23].  The real trace is not
shippable here, so we synthesize a workload with its published marginals:

* per-function average rates are heavy-tailed (log-uniform over ~4 decades;
  a small head of functions carries most of the load),
* inter-arrivals per function are bursty (doubly-stochastic: diurnal-ish
  slow modulation x Poisson),
* execution durations are lognormal (median ~600 ms, long tail, capped),
* memory per instance follows the Azure quantiles (~128-512 MB).

``sample_functions`` implements the In-Vitro idea: stratified sampling over
the rate distribution so a small sample preserves the load *shape* of the
full population.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    num_functions: int = 400
    duration_s: float = 4800.0          # 80 minutes
    seed: int = 0
    target_total_rps: float = 62.5      # ~300k invocations / 80 min
    min_rate: float = 1.0 / 900.0       # 1 per 15 min
    max_rate: float = 4.0               # hot functions
    dur_median_s: float = 0.6
    dur_sigma: float = 1.0
    dur_cap_s: float = 30.0
    burst_period_s: float = 300.0
    burst_amp: float = 0.6              # 0 = pure Poisson


@dataclasses.dataclass
class FunctionProfile:
    rate: np.ndarray          # (F,) mean requests/s
    dur_median: np.ndarray    # (F,) seconds
    dur_sigma: np.ndarray     # (F,)
    memory_mb: np.ndarray     # (F,)
    phase: np.ndarray         # (F,) burst phase offset


@dataclasses.dataclass
class Trace:
    """Flat invocation stream, sorted by time."""
    t: np.ndarray             # (N,) arrival seconds
    fn: np.ndarray            # (N,) function ids
    dur: np.ndarray           # (N,) pure execution seconds
    profile: FunctionProfile
    duration_s: float

    @property
    def num_functions(self) -> int:
        return len(self.profile.rate)

    def __len__(self) -> int:
        return len(self.t)


@dataclasses.dataclass
class RateTrace:
    """Pre-binned arrival counts — the planet-scale workload carrier.

    A flat event stream at 100k functions / 50M invocations costs more to
    synthesize and sort than the fluid simulator costs to replay it, and
    the chunked scan only ever consumes per-tick counts anyway.  RateTrace
    holds the (T, F) count matrix directly (synthesized vectorized, Poisson
    per tick) plus the per-function profile; ``weights`` carries the member
    multiplicity when functions have been clustered into super-functions
    (``repro_torch.scenarios.cluster``), in which case ``counts`` columns are the
    bucket-MEAN per-tick arrivals (fractional) of one representative.

    The discrete-event oracle cannot replay a RateTrace (there is no event
    stream); the runner drops the eventsim leg for rate-based scenarios.
    """
    counts: np.ndarray        # (T, F) arrivals per tick (float for clustered)
    tick_s: float
    profile: FunctionProfile
    duration_s: float
    weights: np.ndarray | None = None   # (F,) member multiplicity (None = 1)

    @property
    def num_functions(self) -> int:
        return len(self.profile.rate)

    def __len__(self) -> int:
        w = 1.0 if self.weights is None else self.weights[None, :]
        return int(round(float((self.counts * w).sum())))


def make_profile(cfg: TraceConfig) -> FunctionProfile:
    rng = np.random.default_rng(cfg.seed)
    f = cfg.num_functions
    # log-uniform rates, rescaled to the target aggregate load
    rate = np.exp(rng.uniform(np.log(cfg.min_rate), np.log(cfg.max_rate), f))
    rate *= cfg.target_total_rps / rate.sum()
    dur_median = np.clip(
        np.exp(rng.normal(np.log(cfg.dur_median_s), 0.8, f)), 0.05, cfg.dur_cap_s)
    dur_sigma = np.full(f, cfg.dur_sigma)
    memory_mb = rng.choice([128, 128, 128, 256, 256, 512], size=f).astype(np.float64)
    phase = rng.uniform(0, 2 * np.pi, f)
    return FunctionProfile(rate, dur_median, dur_sigma, memory_mb, phase)


def synthesize(cfg: TraceConfig, profile: FunctionProfile | None = None) -> Trace:
    rng = np.random.default_rng(cfg.seed + 1)
    prof = profile or make_profile(cfg)
    f = len(prof.rate)
    ts, fns, durs = [], [], []
    for i in range(f):
        # doubly-stochastic arrivals: thinned Poisson with sinusoidal intensity
        lam_max = prof.rate[i] * (1 + cfg.burst_amp)
        n = rng.poisson(lam_max * cfg.duration_s)
        if n == 0:
            continue
        t = np.sort(rng.uniform(0, cfg.duration_s, n))
        intensity = (1 + cfg.burst_amp * np.sin(
            2 * np.pi * t / cfg.burst_period_s + prof.phase[i])) / (1 + cfg.burst_amp)
        keep = rng.uniform(size=n) < intensity
        t = t[keep]
        if len(t) == 0:
            continue
        d = np.clip(rng.lognormal(np.log(prof.dur_median[i]), prof.dur_sigma[i],
                                  len(t)), 0.02, cfg.dur_cap_s)
        ts.append(t)
        fns.append(np.full(len(t), i, np.int32))
        durs.append(d)
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return Trace(t[order], np.concatenate(fns)[order],
                 np.concatenate(durs)[order], prof, cfg.duration_s)


def synthesize_rates(cfg: TraceConfig, tick_s: float = 1.0,
                     profile: FunctionProfile | None = None) -> RateTrace:
    """Vectorized counterpart of :func:`synthesize` producing a
    :class:`RateTrace`: per-tick Poisson counts under the same sinusoidal
    intensity modulation, drawn in time blocks so the intermediate
    intensity buffer stays bounded (~32 MB) even at 100k functions.

    The marginals match ``synthesize`` (same profile, same mean intensity
    per tick); the streams are not sample-path identical — rate-based
    scenarios are fluid-engine workloads, not oracle replays."""
    rng = np.random.default_rng(cfg.seed + 1)
    prof = profile or make_profile(cfg)
    f = len(prof.rate)
    t_ticks = int(np.ceil(cfg.duration_s / tick_s))
    counts = np.empty((t_ticks, f), np.int32)
    block = max(1, int(4_000_000 // max(f, 1)))
    for b0 in range(0, t_ticks, block):
        b1 = min(b0 + block, t_ticks)
        t_mid = (np.arange(b0, b1, dtype=np.float64) + 0.5) * tick_s
        mod = 1.0 + cfg.burst_amp * np.sin(
            2 * np.pi * t_mid[:, None] / cfg.burst_period_s + prof.phase[None, :])
        lam = np.clip(prof.rate[None, :] * mod, 0.0, None) * tick_s
        counts[b0:b1] = rng.poisson(lam).astype(np.int32)
    return RateTrace(counts, float(tick_s), prof, float(cfg.duration_s))


def sample_functions(full: FunctionProfile, n: int, seed: int = 0) -> FunctionProfile:
    """In-Vitro-style stratified sample: preserve the rate distribution by
    sampling uniformly within rate quantile strata."""
    rng = np.random.default_rng(seed)
    order = np.argsort(full.rate)
    strata = np.array_split(order, n)
    idx = np.array([rng.choice(s) for s in strata if len(s)])
    # rescale so the sample carries the same load per function on average
    return FunctionProfile(full.rate[idx], full.dur_median[idx],
                           full.dur_sigma[idx], full.memory_mb[idx],
                           full.phase[idx])


def concat_profiles(a: FunctionProfile, b: FunctionProfile) -> FunctionProfile:
    """Stack two function populations; ids of *b* shift by ``len(a.rate)``."""
    return FunctionProfile(*(np.concatenate([getattr(a, f.name),
                                             getattr(b, f.name)])
                             for f in dataclasses.fields(FunctionProfile)))


def merge_traces(a: Trace, b: Trace) -> Trace:
    """Interleave two invocation streams onto one shared cluster, re-keying
    *b*'s function ids past *a*'s population (multi-tenant composition)."""
    t = np.concatenate([a.t, b.t])
    fn = np.concatenate([a.fn, b.fn + a.num_functions]).astype(np.int32)
    dur = np.concatenate([a.dur, b.dur])
    order = np.argsort(t, kind="stable")
    return Trace(t[order], fn[order], dur[order],
                 concat_profiles(a.profile, b.profile),
                 max(a.duration_s, b.duration_s))


def rate_matrix(trace, tick_s: float = 1.0) -> np.ndarray:
    """(T, F) arrival counts per tick — the input format of the vectorized
    simulator (repro_torch.core.simtorch).  RateTraces already ARE count matrices:
    returned as-is at their native tick, sum-pooled when the requested tick
    is an integer multiple, refused otherwise (counts cannot be split)."""
    if isinstance(trace, RateTrace):
        ratio = tick_s / trace.tick_s
        if abs(ratio - round(ratio)) > 1e-9 or round(ratio) < 1:
            raise ValueError(
                f"RateTrace binned at {trace.tick_s}s cannot be re-binned to "
                f"{tick_s}s (only integer multiples of the native tick)")
        r = int(round(ratio))
        counts = trace.counts
        if r == 1:
            return counts
        t = counts.shape[0]
        pad = (-t) % r
        if pad:
            counts = np.concatenate(
                [counts, np.zeros((pad, counts.shape[1]), counts.dtype)])
        return counts.reshape(-1, r, counts.shape[1]).sum(axis=1)
    t_ticks = int(np.ceil(trace.duration_s / tick_s))
    out = np.zeros((t_ticks, trace.num_functions), np.int32)
    tick = np.minimum((trace.t / tick_s).astype(np.int64), t_ticks - 1)
    np.add.at(out, (tick, trace.fn), 1)
    return out


def _function_gaps(trace: Trace):
    """One shared extraction pass behind the gap statistics: per-function
    inter-arrival gaps, time-ordered.  Yields (fn, gaps, gap_end_times)
    per function with >= 2 arrivals — the sort/group work every caller of
    ``gap_quantile``/``gap_tables`` would otherwise redo on multi-million
    event traces."""
    order = np.lexsort((trace.t, trace.fn))
    fn, t = trace.fn[order], trace.t[order]
    gaps = np.diff(t)
    same = np.diff(fn) == 0
    gfn, gv, gt = fn[1:][same], gaps[same], t[1:][same]
    starts = np.flatnonzero(np.r_[True, np.diff(gfn) != 0]) \
        if len(gfn) else np.zeros(0, np.int64)
    bounds = np.r_[starts, len(gfn)]
    for s, e in zip(bounds[:-1], bounds[1:]):
        yield int(gfn[s]), gv[s:e], gt[s:e]


def gap_quantile(trace: Trace, q: float = 0.99, window: int = 256,
                 stride: int = 16, gaps=None) -> np.ndarray:
    """(F,) empirical q-quantile of each function's inter-arrival gap, as
    the oracle hybrid policy OBSERVES it: over a rolling ``window`` of the
    most recent gaps (its histogram is a maxlen-256 deque), averaged across
    the trace's measurement half.

    An adaptive-keepalive fluid model needs the gap distribution the oracle
    sees, not a Poisson quantile at the mean rate — on time-warped / bursty
    traces the two differ severalfold, and for chatty functions the rolling
    window tracks the current phase where a whole-trace quantile would mix
    day and night gaps.  Functions with fewer than two arrivals report the
    trace duration (a gap never observed; callers clip to their keepalive
    cap)."""
    out = np.full(trace.num_functions, trace.duration_s, np.float64)
    half = trace.duration_s / 2
    for i, g, gtime in (gaps if gaps is not None else _function_gaps(trace)):
        if len(g) <= window:
            out[i] = np.quantile(g, q)
            continue
        ends = np.arange(window, len(g) + 1,
                         max(1, min(stride, (len(g) - window) // 8 + 1)))
        # windows the measurement half consults (fall back to the tail)
        meas = ends[gtime[ends - 1] >= half]
        if len(meas) == 0:
            meas = ends[-1:]
        # every consulted window's quantile in one call: the same order
        # statistics and interpolation per row as one call a window (bit
        # for bit), without ~10^5 calls on a fig9-sized trace
        wins = np.lib.stride_tricks.sliding_window_view(g, window)[meas - window]
        out[i] = np.mean(np.quantile(wins, q, axis=1))
    return out


#: keepalive grid for ``gap_tables`` (log-spaced ms .. a day)
KA_GRID = np.geomspace(1e-3, 86_400.0, 56)


def gap_tables(trace: Trace, grid: np.ndarray = KA_GRID,
               gaps=None) -> tuple[np.ndarray, np.ndarray]:
    """Two (F, K) tables over the keepalive grid, per function:

    * ``alive``: E[min(gap, grid[k])] — mean renewal-cycle length under a
      keepalive of grid[k] (the cycle ends at the next arrival or the
      timer, whichever first);
    * ``tail``:  P(gap > grid[k]) — the probability that cycle ends in an
      expiry.

    Their ratio tail/alive is the renewal-exact expiry rate for the
    function's ACTUAL gap distribution (``policy_api
    .empirical_expiry_rate``): the analytic Poisson form under-expires
    strongly bursty traces (diurnal warps, production tails) under short
    keepalives, while matching cycle length alone over-expires burst-heavy
    functions whose clustered gaps shrink the mean cycle without adding
    expiry events.  Interpolating both inside the scan reproduces
    lam/(e^{lam*ka}-1) exactly when gaps ARE exponential and the measured
    truth when they are not.  Functions with fewer than two arrivals get
    alive = ka, tail = 1 (a gap never observed: the pure idle-timer
    limit)."""
    f = trace.num_functions
    alive = np.broadcast_to(grid, (f, len(grid))).copy()
    tail = np.ones((f, len(grid)))
    for i, gv, _ in (gaps if gaps is not None else _function_gaps(trace)):
        g = np.sort(gv)
        csum = np.concatenate([[0.0], np.cumsum(g)])
        k = np.searchsorted(g, grid, side="right")
        # mean of min(gap, ka): gaps below ka contribute themselves,
        # gaps above contribute ka
        alive[i] = (csum[k] + grid * (len(g) - k)) / len(g)
        tail[i] = (len(g) - k) / len(g)
    return alive, tail


def gap_statistics(trace, q: float = 0.99,
                   grid: np.ndarray = KA_GRID):
    """(gap_p99, alive_tab, tail_tab) from ONE extraction pass — what the
    fluid engines consume per simulate/sweep/training call; calling
    ``gap_quantile`` and ``gap_tables`` separately would redo the
    O(N log N) sort+group on multi-million-event traces.

    RateTraces have no event stream to measure, so they get the analytic
    Poisson forms at each function's mean rate (exact for the per-tick
    Poisson counts ``synthesize_rates`` draws): gap quantile
    -ln(1-q)/lam, alive E[min(gap, ka)] = (1 - e^{-lam ka})/lam, tail
    P(gap > ka) = e^{-lam ka}.  Zero-rate functions report the trace
    duration / pure idle-timer limits, matching the empirical convention
    for functions with fewer than two arrivals."""
    if isinstance(trace, RateTrace):
        lam = np.asarray(trace.counts, np.float64).mean(axis=0) / trace.tick_s
        f, k = len(lam), len(grid)
        pos = lam > 0
        gq = np.full(f, trace.duration_s, np.float64)
        gq[pos] = np.minimum(-np.log1p(-q) / lam[pos], trace.duration_s)
        alive = np.broadcast_to(grid, (f, k)).copy()
        tail = np.ones((f, k))
        lg = lam[pos, None] * grid[None, :]
        alive[pos] = -np.expm1(-lg) / lam[pos, None]
        tail[pos] = np.exp(-lg)
        return gq, alive, tail
    per_fn = list(_function_gaps(trace))
    return (gap_quantile(trace, q, gaps=per_fn),
            *gap_tables(trace, grid, gaps=per_fn))
