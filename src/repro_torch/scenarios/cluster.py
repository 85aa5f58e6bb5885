"""Long-tail function clustering: weighted super-functions for the fluid scan.

Production serverless populations are dominated by a long tail of
near-identical, rarely-invoked functions (the Azure trace's bottom decades
carry most of the FUNCTIONS and almost none of the LOAD).  The chunked
scan's cost is linear in the function axis, so at planet scale the tail is
pure overhead: 90k cold functions each simulate the same dynamics.

``cluster_functions`` buckets functions below a mean-rps threshold by
quantized (rate, duration, memory, sigma) and replaces each bucket with ONE
representative — the bucket's rate-MEDOID member's per-tick arrival column —
carrying a ``weights`` entry equal to the member count.  Exactness argument
(see also ``simtorch._make_step``): the fluid scan is deterministic given
per-tick counts, per-function dynamics only couple through reductions that
are LINEAR in per-function contributions, and identical members evolve
identically — so k identical functions equal one representative weighted k,
exactly.  The representative must be a REAL member column, not the
bucket-mean column: averaging k Poisson realizations smooths away the
burstiness that drives cold starts (the mean column under-counts creations
by ~25% on the planet trace), while a medoid realization keeps the gap
statistics of a genuine member.  Real buckets are only NEAR-identical
(finite quantization), so the residual is second-order in the bin width;
the parity test (tests/test_sharding.py) pins it ≤1% on the headline
metrics.

The output is always a :class:`repro_torch.core.trace.RateTrace` (clustered
columns are fractional mean counts); event-level oracle legs are therefore
unavailable on clustered runs — the runner drops them.

A copy of ``repro.scenarios.cluster`` (numpy only); the two must stay
identical in behaviour.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.core.trace import FunctionProfile, RateTrace, Trace, rate_matrix

__all__ = ["cluster_functions"]


def cluster_functions(trace: Union[Trace, RateTrace], below_rps: float,
                      bins_per_octave: int = 10,
                      tick_s: Optional[float] = None) -> RateTrace:
    """Bucket functions with mean rate < ``below_rps`` into weighted
    super-functions; hot functions stay exact with weight 1.

    ``bins_per_octave`` sets the quantization of the (log rate, log
    duration) bucket key — 10 bins per factor-2 keeps members within ~±3.5%
    of their bucket's geometric center (the planet-trace parity sweep:
    6 bins leaves a 3.7% creation-rate gap, 10 bins ≤0.25% on every
    headline metric).  Memory (exact) and dur_sigma (rounded) complete the
    key, so a bucket is homogeneous in every input the scan reads per
    function.  ``tick_s`` is the binning tick when the input is an
    event-level Trace (default 1 s); RateTraces keep theirs.
    """
    if isinstance(trace, RateTrace):
        tick = trace.tick_s
        counts = np.asarray(trace.counts, np.float64)
        base_w = (np.ones(trace.num_functions) if trace.weights is None
                  else np.asarray(trace.weights, np.float64))
    else:
        tick = float(tick_s if tick_s is not None else 1.0)
        counts = rate_matrix(trace, tick).astype(np.float64)
        base_w = np.ones(trace.num_functions)
    prof = trace.profile
    t_ticks, f = counts.shape
    rates = counts.mean(axis=0) / tick

    with np.errstate(divide="ignore"):
        lg_rate = np.round(np.log2(rates) * bins_per_octave)
        lg_dur = np.round(np.log2(np.maximum(prof.dur_median, 1e-9))
                          * bins_per_octave)
    cold = rates < below_rps

    # bucket id per function: hot functions get singleton buckets in their
    # original order, cold functions group by the quantized key
    bucket_of = np.empty(f, np.int64)
    key_to_id: dict = {}
    members: list[list[int]] = []
    for i in range(f):
        if not cold[i]:
            bucket_of[i] = len(members)
            members.append([i])
            continue
        key = (float(lg_rate[i]), float(lg_dur[i]),
               float(prof.memory_mb[i]), round(float(prof.dur_sigma[i]), 6))
        bid = key_to_id.get(key)
        if bid is None:
            bid = key_to_id[key] = len(members)
            members.append([])
        bucket_of[i] = bid
        members[bid].append(i)
    b = len(members)

    # (at 100k functions the python work above is O(F) dict ops; the heavy
    # lifting below is numpy scatter-adds)
    w_out = np.zeros(b)
    np.add.at(w_out, bucket_of, base_w)

    def wmean(v):
        out = np.zeros(b)
        np.add.at(out, bucket_of, np.asarray(v, np.float64) * base_w)
        return out / w_out

    # representative counts = the column of the bucket's rate-MEDOID member
    # (the member whose mean rate is closest to the bucket's weighted mean).
    # A real realization, not the bucket-mean column: averaging Poisson
    # columns smooths the burstiness that drives cold starts.
    mean_rate = wmean(rates)
    rep = np.empty(b, np.int64)
    for bid, mem in enumerate(members):
        idx = np.asarray(mem)
        rep[bid] = idx[np.argmin(np.abs(rates[idx] - mean_rate[bid]))]
    new_counts = counts[:, rep].astype(np.float32)

    # bucket profiles: rate/duration as weighted (geometric for the
    # log-binned duration) means of near-identical members; memory and
    # sigma are constant within a bucket by construction
    new_prof = FunctionProfile(
        rate=wmean(prof.rate),
        dur_median=np.exp(wmean(np.log(np.maximum(prof.dur_median, 1e-9)))),
        dur_sigma=wmean(prof.dur_sigma),
        memory_mb=wmean(prof.memory_mb),
        phase=wmean(prof.phase),
    )
    return RateTrace(new_counts, tick, new_prof, float(trace.duration_s),
                     weights=w_out)
