"""Provider-calibrated billing engine: what a platform actually charges.

A copy of ``repro.fleet.billing`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

``repro_torch.fleet.costs`` bills the IDEAL model — per-second node-hours plus a
managed control-plane rate.  Real serverless bills diverge sharply from
that ("Demystifying Serverless Costs on Public Platforms", "Understanding
Cost Dynamics of Serverless Computing", PAPERS.md): durations are rounded
UP to a billing granularity and censored at a minimum billed duration,
every request pays a flat fee, compute is metered in GB-seconds of BILLED
(not actual) duration, keeping capacity warm is a separate
provisioned-concurrency tier, and CPU share scales with configured memory
so under-provisioned functions run (and bill) longer.

A ``BillingProfile`` captures all of that as data.  Four are registered:

* ``ideal``           — bit-for-bit the ``PriceBook`` math in ``costs.py``
                        (all provider-side rates are exactly 0.0, the
                        node-hour weight exactly 1.0, so every added term
                        is a float-identity ``+ 0.0`` / ``* 1.0``);
* ``aws_lambda``      — AWS Lambda, x86 / us-east-1 public prices;
* ``gcr``             — Google Cloud Run, request billing, tier-1 region;
* ``azure_functions`` — Azure Functions Consumption plan (100 ms minimum
                        bill + per-execution fee).

Both engines bill through one profile: the discrete-event oracle rounds
each request's recorded duration exactly (``billed_seconds`` over
``SimResult.records``), while the fluid scan accumulates the ANALYTIC
expectation of the rounded/min-censored duration under the trace's clipped
lognormal mixture (``expected_billed_seconds``) — the same
quantile-midpoint construction the slowdown mixture uses, so the two
engines' billed totals agree to sampling error (parity-gated ≤15%).

Rates are documented against the public pricing pages in EXPERIMENTS.md
("Billing").
"""

from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np

from repro_torch.fleet.costs import CostReport, PriceBook, cost_report
from repro_torch.fleet.nodes import NodeType

# per-request service times are clipped lognormals — the same clip window
# ``trace.synthesize`` samples from and ``simjax``'s slowdown mixture
# integrates over (keep the three in sync)
_DUR_FLOOR, _DUR_CAP = 0.02, 30.0

# quantile-midpoint grid for the analytic billed-duration expectation;
# 4096 midpoints put the Riemann error well under the rounding granularity
_QUANTILE_GRID = 4096


def _norm_ppf(q: np.ndarray) -> np.ndarray:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |rel err| < 1.15e-9), vectorized — scipy is not a dependency here,
    mirroring ``simjax._phi`` on the forward side."""
    q = np.asarray(q, np.float64)
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    lo, hi = 0.02425, 1.0 - 0.02425
    out = np.empty_like(q)
    m = q < lo
    if m.any():
        u = np.sqrt(-2.0 * np.log(q[m]))
        out[m] = (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                  * u + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u
                                  + d[3]) * u + 1.0)
    m = q > hi
    if m.any():
        u = np.sqrt(-2.0 * np.log(1.0 - q[m]))
        out[m] = -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4])
                   * u + c[5]) / ((((d[0] * u + d[1]) * u + d[2]) * u
                                   + d[3]) * u + 1.0)
    m = (q >= lo) & (q <= hi)
    if m.any():
        u = q[m] - 0.5
        r = u * u
        out[m] = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
                  * r + a[5]) * u / (((((b[0] * r + b[1]) * r + b[2]) * r
                                       + b[3]) * r + b[4]) * r + 1.0)
    return out


@dataclasses.dataclass
class BillReport(CostReport):
    """A ``CostReport`` extended with the provider-side components.  Under
    the ``ideal`` profile every extension is exactly 0.0 and the inherited
    fields are bitwise the ``cost_report`` values (the regression the
    billing tests pin)."""
    billing: str = "ideal"
    request_cost: float = 0.0        # per-request fee x completed
    duration_cost: float = 0.0       # per-GB-s rate x billed GB-s
    warm_pool_cost: float = 0.0      # provisioned-concurrency / idle tier
    billed_gb_s: float = 0.0         # metered GB-s of BILLED duration
    warm_gb_s: float = 0.0           # idle-warm GB-s held over the window


@dataclasses.dataclass(frozen=True)
class BillingProfile:
    """One provider's billing semantics as data.

    The node-denominated side (``node_hour_weight`` x the ``PriceBook``
    math) and the request-denominated side (rounding + minimum + fees +
    GB-s metering + warm-pool tier) coexist so ``ideal`` (weight 1, all
    provider rates 0) and pure-serverless profiles (weight 0) are the two
    ends of one parameterization, not separate code paths.
    """
    name: str = "ideal"
    description: str = "per-second node-hours (the pre-billing cost model)"
    # --- node-denominated (infrastructure) side ------------------------
    node_hour_weight: float = 1.0    # share of the node-hour bill charged
    master_vcpu_per_hour: float = 0.048
    spot_discount: float = 0.0
    # --- request-denominated (provider) side ---------------------------
    rounding_s: float = 0.0          # billed duration rounds UP to this
    min_billed_s: float = 0.0        # minimum billed duration (censoring)
    per_request: float = 0.0         # $ / request
    per_gb_s: float = 0.0            # $ / GB-s of billed duration
    warm_gb_s_rate: float = 0.0      # $ / GB-s of idle-warm capacity
    # --- cpu-throttle term (fluid duration model) ----------------------
    # memory granting a full CPU share; functions configured below it run
    # (and bill) up to ``throttle_cap`` x longer.  0 disables the term.
    throttle_full_mb: float = 0.0
    throttle_cap: float = 2.0

    # -- conversions ----------------------------------------------------

    def prices(self) -> PriceBook:
        """The node-tier subset, for delegating to ``costs.cost_report``."""
        return PriceBook(master_vcpu_per_hour=self.master_vcpu_per_hour,
                         spot_discount=self.spot_discount)

    def with_spot_discount(self, discount: float) -> "BillingProfile":
        """This profile re-specced to a capacity tier's discount (the
        billing analogue of ``runner.apply_tier``'s PriceBook edit)."""
        return dataclasses.replace(self, spot_discount=float(discount))

    # -- duration billing -----------------------------------------------

    def billed_seconds(self, dur) -> np.ndarray:
        """Exact billed duration per request: round UP to ``rounding_s``,
        then censor at ``min_billed_s``.  Identity under ``ideal``."""
        d = np.asarray(dur, np.float64)
        if self.rounding_s > 0.0:
            # the 1e-9 guard keeps exact multiples of the granularity from
            # rounding up one extra step through d/g float noise
            d = np.ceil(d / self.rounding_s - 1e-9) * self.rounding_s
        if self.min_billed_s > 0.0:
            d = np.maximum(d, self.min_billed_s)
        return d

    def expected_billed_seconds(self, dur_median, dur_sigma,
                                n: int = _QUANTILE_GRID) -> np.ndarray:
        """Per-function E[billed(D)] for D ~ clipped LogNormal(log median,
        sigma) — the analytic twin of averaging ``billed_seconds`` over a
        sampled trace, evaluated on a quantile-midpoint grid (exact as
        n -> inf; at n=4096 the gap to the exact integral is far below the
        fluid-vs-oracle sampling noise)."""
        med = np.atleast_1d(np.asarray(dur_median, np.float64))
        sig = np.atleast_1d(np.asarray(dur_sigma, np.float64))
        z = _norm_ppf((np.arange(n) + 0.5) / n)
        d = np.exp(np.log(med)[:, None] + sig[:, None] * z[None, :])
        d = np.clip(d, _DUR_FLOOR, _DUR_CAP)
        return self.billed_seconds(d).mean(axis=1)

    def billed_weights(self, profile) -> np.ndarray:
        """(F,) expected billed GB-s PER COMPLETION for a trace's
        ``FunctionProfile`` — the weight the fluid scan multiplies into its
        per-tick completions vector.  GB is the function's CONFIGURED
        memory (what the provider meters), not the +overhead sandbox size
        both engines use for capacity accounting."""
        e = self.expected_billed_seconds(profile.dur_median,
                                         profile.dur_sigma)
        return e * np.asarray(profile.memory_mb, np.float64) / 1024.0

    # -- cpu throttle ---------------------------------------------------

    def throttle_factor(self, memory_mb) -> np.ndarray:
        """Duration inflation for memory-throttled CPU: full share at
        ``throttle_full_mb``, proportional below, clamped at
        ``throttle_cap`` (burst credits and the fact that measured
        durations already embed partial throttling bound the stretch)."""
        mem = np.asarray(memory_mb, np.float64)
        if self.throttle_full_mb <= 0.0:
            return np.ones_like(mem)
        return np.clip(self.throttle_full_mb / np.maximum(mem, 1.0),
                       1.0, self.throttle_cap)

    # -- the bill -------------------------------------------------------

    def bill(self, *, node_seconds: float, cpu_worker_overhead_s: float,
             cpu_master_overhead_s: float, idle_node_share: float,
             completed: int, node_type: NodeType = NodeType(),
             spot_node_seconds: float = 0.0, billed_gb_s: float = 0.0,
             warm_gb_s: float = 0.0) -> BillReport:
        """The full bill.  The node-denominated fields delegate to
        ``costs.cost_report`` (the math exists once) scaled by
        ``node_hour_weight``; the provider terms add on top.  Under
        ``ideal`` the result is bitwise ``cost_report``'s (x*1.0 and
        x+0.0 are IEEE identities for the non-negative values here)."""
        base = cost_report(
            node_seconds=node_seconds,
            cpu_worker_overhead_s=cpu_worker_overhead_s,
            cpu_master_overhead_s=cpu_master_overhead_s,
            idle_node_share=idle_node_share, completed=completed,
            node_type=node_type, prices=self.prices(),
            spot_node_seconds=spot_node_seconds)
        w = self.node_hour_weight
        node_cost = base.node_cost * w
        churn_cost = base.churn_cost * w
        idle_cost = base.idle_cost * w
        request_cost = self.per_request * completed
        duration_cost = self.per_gb_s * billed_gb_s
        warm_pool_cost = self.warm_gb_s_rate * warm_gb_s
        total = node_cost + base.master_cost + request_cost \
            + duration_cost + warm_pool_cost
        per_million = total / completed * 1e6 if completed > 0 \
            else float("nan")
        return BillReport(
            node_hours=base.node_hours, node_cost=node_cost,
            master_cpu_hours=base.master_cpu_hours,
            master_cost=base.master_cost, churn_cost=churn_cost,
            idle_cost=idle_cost, total_cost=total, completed=completed,
            cost_per_million=per_million, billing=self.name,
            request_cost=request_cost, duration_cost=duration_cost,
            warm_pool_cost=warm_pool_cost, billed_gb_s=billed_gb_s,
            warm_gb_s=warm_gb_s)


# ---------------------------------------------------------------------------
# engine adapters: one profile, two engines
# ---------------------------------------------------------------------------


def apply_throttle(trace, profile: BillingProfile):
    """The trace as the provider's throttled CPU actually runs it: per-
    request durations AND the per-function duration model stretch by the
    same factor, so the oracle (which replays ``trace.dur``) and the fluid
    scan (which derives service rates and the slowdown/billing mixtures
    from ``profile.dur_median/dur_sigma``) see one consistent workload.
    Returns the trace unchanged (same object) when the profile has no
    throttle term — the ``ideal`` bit-for-bit guarantee."""
    f = profile.throttle_factor(trace.profile.memory_mb)
    if not np.any(f > 1.0):
        return trace
    prof = dataclasses.replace(
        trace.profile,
        dur_median=np.minimum(trace.profile.dur_median * f, _DUR_CAP))
    if not hasattr(trace, "dur"):
        # rate-based trace (repro_torch.core.trace.RateTrace): no per-request
        # events, the duration model IS the workload's duration state
        return dataclasses.replace(trace, profile=prof)
    return dataclasses.replace(
        trace, dur=np.minimum(trace.dur * f[trace.fn], _DUR_CAP),
        profile=prof)


def bill_sim(result, trace, profile: BillingProfile,
             node_type: NodeType = NodeType()) -> BillReport:
    """Bill an ``EventSim`` result through a profile: node accounting as
    ``costs.cost_from_sim``, plus EXACT per-request billed GB-s (each
    recorded duration rounded/censored individually — no expectation) and
    the measured idle-warm GB-s for the provisioned/warm tier."""
    node_seconds = result.node_seconds
    if node_seconds <= 0.0 and len(result.sample_times):
        node_seconds = result.measure_window_s * max(result.nodes_hint, 1)
    cap_mb = max(node_seconds / max(result.measure_window_s, 1e-9), 1e-9) \
        * node_type.memory_mb
    idle_mb = 0.0
    if len(result.mem_samples_total_mb):
        idle_mb = float(result.mem_samples_total_mb.mean()
                        - result.mem_samples_busy_mb.mean())
    fn_s, billed_s = result.billed_duration_totals(
        granularity_s=profile.rounding_s, min_billed_s=profile.min_billed_s)
    mem_gb = np.asarray(trace.profile.memory_mb, np.float64)[fn_s] / 1024.0
    billed_gb_s = float((billed_s * mem_gb).sum())
    warm_gb_s = max(idle_mb, 0.0) * result.measure_window_s / 1024.0
    return profile.bill(
        node_seconds=node_seconds,
        cpu_worker_overhead_s=result.cpu_worker_overhead_s,
        cpu_master_overhead_s=result.cpu_master_overhead_s,
        idle_node_share=idle_mb / cap_mb,
        completed=len(result.records), node_type=node_type,
        spot_node_seconds=result.spot_node_seconds,
        billed_gb_s=billed_gb_s, warm_gb_s=warm_gb_s)


def bill_summary(summary: dict, profile: BillingProfile,
                 node_type: NodeType = NodeType(), dt: float = 1.0,
                 cap_mb: float = 0.0) -> BillReport:
    """Bill a ``simulate_chunked`` summary row through a profile.  The scan
    accumulated ``billed_gb_s`` with this profile's expectation weights;
    the warm-pool GB-s is the measured idle mass held over the window —
    the same (mem_total - mem_busy) basis the oracle side bills."""
    window = summary["ticks_measured"] * dt
    if cap_mb <= 0.0:
        cap_mb = max(summary["nodes_mean"] * node_type.memory_mb, 1e-9)
    idle_mb = summary["mem_total_mean"] - summary["mem_busy_mean"]
    return profile.bill(
        node_seconds=summary["node_seconds"],
        cpu_worker_overhead_s=summary["cpu_worker_s"],
        cpu_master_overhead_s=summary["cpu_master_s"],
        idle_node_share=idle_mb / cap_mb,
        completed=int(summary["completed"]), node_type=node_type,
        spot_node_seconds=summary["spot_node_seconds"],
        billed_gb_s=summary.get("billed_gb_s", 0.0),
        warm_gb_s=max(idle_mb, 0.0) * window / 1024.0)


# ---------------------------------------------------------------------------
# the profile registry (mirrors repro_torch.fleet.spot's tier registry)
# ---------------------------------------------------------------------------

_PROFILES: dict[str, BillingProfile] = {}


def register_profile(profile: BillingProfile) -> BillingProfile:
    if profile.name in _PROFILES:
        raise ValueError(f"duplicate billing profile {profile.name!r}")
    _PROFILES[profile.name] = profile
    return profile


def get_profile(name: Union[str, BillingProfile]) -> BillingProfile:
    if isinstance(name, BillingProfile):
        return name
    try:
        return _PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown billing profile {name!r}; "
                       f"registered: {sorted(_PROFILES)}") from None


def list_profiles() -> list[str]:
    return sorted(_PROFILES)


def resolve_profile(billing, default: "BillingProfile" = None
                    ) -> "BillingProfile":
    """Resolve a billing spec against a context default (typically the
    scenario's own profile): ``None`` -> the default; a NAME -> the
    registered profile inheriting the default's spot discount (the tier is
    workload state, not provider semantics); a profile OBJECT ->
    verbatim."""
    default = default if default is not None else IDEAL
    if billing is None:
        return default
    prof = get_profile(billing)
    if isinstance(billing, str):
        prof = prof.with_spot_discount(default.spot_discount)
    return prof


IDEAL = register_profile(BillingProfile())

# AWS Lambda, x86 / us-east-1 (aws.amazon.com/lambda/pricing, 2025):
# $0.20 / 1M requests, $0.0000166667 / GB-s billed at 1 ms granularity
# (duration rounds up to the nearest ms; the 1 ms is also the minimum),
# provisioned concurrency at $0.0000041667 / GB-s, and CPU share
# proportional to memory with a full vCPU at 1769 MB.  The throttle cap
# is calibrated at 1.5x, well under the raw memory ratio: measured trace
# durations already embed partial provider throttling (plus burst
# credits), so the full proportional stretch would double-count — and the
# 0.25x oracle-vs-fluid billed-cost parity band (<=15% on every
# registered scenario, pinned in tests/test_billing.py) bounds how far
# the workload may be stretched before the fluid idle-mass model drifts.
AWS_LAMBDA = register_profile(BillingProfile(
    name="aws_lambda",
    description="AWS Lambda x86 us-east-1: per-request + per-GB-s at 1 ms "
                "granularity, provisioned-concurrency warm tier, "
                "memory-proportional CPU",
    node_hour_weight=0.0, master_vcpu_per_hour=0.0,
    rounding_s=0.001, min_billed_s=0.001,
    per_request=2.0e-7, per_gb_s=1.66667e-5,
    warm_gb_s_rate=4.1667e-6,
    throttle_full_mb=1769.0, throttle_cap=1.5))

# Google Cloud Run, request-based billing, tier-1 region
# (cloud.google.com/run/pricing, 2025): $0.40 / 1M requests; CPU
# $0.000024 / vCPU-s + memory $0.0000025 / GiB-s, folded at the default
# 1-vCPU-per-GiB shape into one $/GB-s rate; durations round UP to the
# nearest 100 ms (which is therefore also the minimum bill); idle
# min-instances bill CPU at a reduced rate — folded into the warm tier.
# Cloud Run grants whole vCPUs regardless of memory: no throttle term.
GCR = register_profile(BillingProfile(
    name="gcr",
    description="Google Cloud Run tier-1: per-request + folded "
                "CPU+memory $/GB-s at 100 ms round-up, idle min-instance "
                "warm tier, whole-vCPU (no throttle)",
    node_hour_weight=0.0, master_vcpu_per_hour=0.0,
    rounding_s=0.1, min_billed_s=0.1,
    per_request=4.0e-7, per_gb_s=2.65e-5,
    warm_gb_s_rate=5.0e-6))

# Azure Functions, Consumption plan (azure.microsoft.com/pricing/details/
# functions, 2025): $0.20 / 1M executions; $0.000016 / GB-s of observed
# duration, rounded UP to the nearest 1 ms with a 100 ms minimum per
# execution — the most aggressive minimum-billing censoring of the three
# providers, so short functions over-bill hardest here.  Memory is rounded
# to the nearest 128 MB by the platform; we bill the configured MB
# directly (the rounding is second-order next to the 100 ms floor).  The
# Consumption plan has no provisioned-concurrency tier (that's Premium)
# and the host grants a full core per sandbox: no warm rate, no throttle.
AZURE_FUNCTIONS = register_profile(BillingProfile(
    name="azure_functions",
    description="Azure Functions Consumption: per-execution + $/GB-s at "
                "1 ms round-up with a 100 ms minimum bill, no warm tier, "
                "full-core host (no throttle)",
    node_hour_weight=0.0, master_vcpu_per_hour=0.0,
    rounding_s=0.001, min_billed_s=0.1,
    per_request=2.0e-7, per_gb_s=1.6e-5))


def _require_float_identities() -> None:
    """The ideal-profile bitwise guarantee rests on x*1.0 == x and
    x+0.0 == x for finite non-negative x; both are IEEE-754 exact.  This
    module-import assertion documents (and enforces) the assumption."""
    x = 0.1 + 0.2
    assert x * 1.0 == x and x + 0.0 == x
    assert math.isnan(float("nan"))


_require_float_identities()
