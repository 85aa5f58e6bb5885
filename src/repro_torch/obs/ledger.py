"""The churn-overhead attribution ledger (both engines).

A copy of ``repro.obs.ledger`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

The paper's headline metrics are ratios — ``cpu_overhead`` = system CPU /
useful CPU, ``normalized_memory`` = allocated / busy memory — and this
module decomposes each into WHERE the overhead goes:

* CPU:    creation (cold-start churn: the create-side sandbox/CNI/probe
            cost of ordinary scale-up)
          / eviction_storm (spot reclaims: the recreate wave killed warm
            instances trigger)
          / keepalive_idle (probes+metrics on warm-idle instances)
          / master_control (control-plane floors + per-request data plane
            + graceful-teardown work — computed as the residual, so the
            four components sum to the aggregate EXACTLY, by construction;
            teardown CPU lives here on BOTH engines because the engines
            agree on creation flux, the parity-banded metric, but not on
            when idle mass sheds around the measurement boundary)
* memory: busy / warm_idle / pipeline (still-starting sandboxes +
          pre-warmed mass), warm_idle the residual.

Both engines feed the same ``OverheadLedger``: the oracle from its
attribution counters (``SimResult.cpu_churn_creation_s`` etc.), the fluid
engine from the in-scan telemetry sums (``simulate_chunked(...,
telemetry=...)``).  ``ledger_parity`` judges each component's
oracle-vs-fluid gap against the aggregate's magnitude — the same <=15% bar
the aggregate parity band uses — so attribution that disagrees between
engines surfaces as a bug, not a footnote.
"""

from __future__ import annotations

import dataclasses
import math

CPU_COMPONENTS = ("creation", "eviction_storm", "keepalive_idle",
                  "master_control")
MEM_COMPONENTS = ("busy", "warm_idle", "pipeline")


@dataclasses.dataclass
class OverheadLedger:
    """One engine's overhead decomposition over the measurement window.
    CPU components are cpu-seconds; memory components are mean MB."""
    engine: str
    cpu_useful_s: float
    cpu_creation_s: float
    cpu_eviction_s: float
    cpu_keepalive_s: float
    cpu_control_s: float               # residual: floors + per-request CPU
    mem_busy_mb: float
    mem_warm_idle_mb: float            # residual
    mem_pipeline_mb: float

    # -- aggregates ----------------------------------------------------------

    @property
    def cpu_total_s(self) -> float:
        return (self.cpu_creation_s + self.cpu_eviction_s
                + self.cpu_keepalive_s + self.cpu_control_s)

    @property
    def cpu_overhead(self) -> float:
        return self.cpu_total_s / max(self.cpu_useful_s, 1e-9)

    @property
    def mem_total_mb(self) -> float:
        return (self.mem_busy_mb + self.mem_warm_idle_mb
                + self.mem_pipeline_mb)

    @property
    def normalized_memory(self) -> float:
        return self.mem_total_mb / max(self.mem_busy_mb, 1e-9)

    # -- component views -----------------------------------------------------

    def cpu_components(self) -> dict:
        """Each component as a share of USEFUL cpu (the same normalization
        as ``cpu_overhead`` — the four values sum to it)."""
        u = max(self.cpu_useful_s, 1e-9)
        return {"creation": self.cpu_creation_s / u,
                "eviction_storm": self.cpu_eviction_s / u,
                "keepalive_idle": self.cpu_keepalive_s / u,
                "master_control": self.cpu_control_s / u}

    def mem_components(self) -> dict:
        """Each component as a multiple of BUSY memory (the same
        normalization as ``normalized_memory`` — the three sum to it)."""
        b = max(self.mem_busy_mb, 1e-9)
        return {"busy": self.mem_busy_mb / b,
                "warm_idle": self.mem_warm_idle_mb / b,
                "pipeline": self.mem_pipeline_mb / b}

    def row(self) -> dict:
        return {"engine": self.engine, "cpu_useful_s": self.cpu_useful_s,
                "cpu_overhead": self.cpu_overhead,
                "normalized_memory": self.normalized_memory,
                **{f"cpu_{k}": v for k, v in self.cpu_components().items()},
                **{f"mem_{k}": v for k, v in self.mem_components().items()}}


def ledger_from_eventsim(result) -> OverheadLedger:
    """Build the ledger from the oracle's attribution counters (a
    ``repro_torch.core.eventsim.SimResult``)."""
    total = result.cpu_worker_overhead_s + result.cpu_master_overhead_s
    creation = result.cpu_churn_creation_s
    evict = result.cpu_evict_storm_s
    idle = result.cpu_keepalive_idle_s
    mem_total = (float(result.mem_samples_total_mb.mean())
                 if len(result.mem_samples_total_mb) else 0.0)
    mem_busy = (float(result.mem_samples_busy_mb.mean())
                if len(result.mem_samples_busy_mb) else 0.0)
    pipe = (float(result.mem_samples_starting_mb.mean())
            if len(result.mem_samples_starting_mb) else 0.0)
    return OverheadLedger(
        engine="eventsim",
        cpu_useful_s=result.cpu_useful_s,
        cpu_creation_s=creation, cpu_eviction_s=evict,
        cpu_keepalive_s=idle,
        cpu_control_s=total - creation - evict - idle,
        mem_busy_mb=mem_busy, mem_pipeline_mb=pipe,
        mem_warm_idle_mb=mem_total - mem_busy - pipe)


def ledger_from_chunked(summary: dict) -> OverheadLedger:
    """Build the ledger from a ``simulate_chunked(..., telemetry=N)`` row
    (its ``telemetry.attribution`` sums cover the measurement window)."""
    telem = summary.get("telemetry")
    if not telem or "attribution" not in telem:
        raise ValueError("summary carries no telemetry attribution; run "
                         "simulate_chunked(..., telemetry=N) with N > 0")
    att = telem["attribution"]
    total = summary["cpu_worker_s"] + summary["cpu_master_s"]
    creation = att["cpu_creation_s"]
    evict = att["cpu_eviction_s"]
    idle = att["cpu_keepalive_s"]
    ticks = max(summary["ticks_measured"], 1e-9)
    pipe = att["mem_pipeline_mb_ticks"] / ticks
    mem_total = summary["mem_total_mean"]
    mem_busy = summary["mem_busy_mean"]
    return OverheadLedger(
        engine="simjax",
        cpu_useful_s=summary["cpu_useful_s"],
        cpu_creation_s=creation, cpu_eviction_s=evict,
        cpu_keepalive_s=idle,
        cpu_control_s=total - creation - evict - idle,
        mem_busy_mb=mem_busy, mem_pipeline_mb=pipe,
        mem_warm_idle_mb=mem_total - mem_busy - pipe)


def check_ledger(led: OverheadLedger, tol: float = 1e-6) -> list[str]:
    """Attribution-sum consistency: components must sum to the aggregates
    within ``tol`` (relative), every value finite, residuals non-negative
    (a negative residual means a component double-counted overhead it does
    not own).  Returns problem strings; empty = consistent."""
    problems = []
    vals = dataclasses.asdict(led)
    for k, v in vals.items():
        if k != "engine" and not math.isfinite(v):
            problems.append(f"{led.engine}: {k} non-finite ({v})")
    cpu_sum = sum(led.cpu_components().values())
    if abs(cpu_sum - led.cpu_overhead) > tol * max(led.cpu_overhead, 1.0):
        problems.append(f"{led.engine}: cpu components sum {cpu_sum:.9g} != "
                        f"cpu_overhead {led.cpu_overhead:.9g}")
    mem_sum = sum(led.mem_components().values())
    if abs(mem_sum - led.normalized_memory) \
            > tol * max(led.normalized_memory, 1.0):
        problems.append(f"{led.engine}: mem components sum {mem_sum:.9g} != "
                        f"normalized_memory {led.normalized_memory:.9g}")
    slack = tol * max(led.cpu_total_s, 1.0)
    for k in ("cpu_creation_s", "cpu_eviction_s", "cpu_keepalive_s",
              "cpu_control_s"):
        if vals[k] < -slack:
            problems.append(f"{led.engine}: {k} negative ({vals[k]:.6g})")
    mslack = tol * max(led.mem_total_mb, 1.0)
    for k in ("mem_busy_mb", "mem_warm_idle_mb", "mem_pipeline_mb"):
        if vals[k] < -mslack:
            problems.append(f"{led.engine}: {k} negative ({vals[k]:.6g})")
    return problems


def ledger_parity(a: OverheadLedger, b: OverheadLedger) -> dict:
    """Per-component oracle-vs-fluid gaps.

    Components are shares of the aggregate's own denominator (useful CPU /
    busy memory), so the gap divides the share difference by the AGGREGATE
    (max over engines), floored at 1: a gap of 0.15 means the engines
    disagree on that component by 15% of the aggregate overhead — or, for
    a lean scenario whose overhead is below its useful work, by 15% of
    USEFUL CPU itself.  The floor keeps the bar meaningful where the
    aggregate ratio is small: without it, a cpu_overhead of 0.25 would
    amplify a 4-cpu-points disagreement (out of every 100 useful cpu-s)
    into a 16% "failure" even though both engines agree the component is
    tiny."""
    out = {}
    ca, cb = a.cpu_components(), b.cpu_components()
    cpu_ref = max(a.cpu_overhead, b.cpu_overhead, 1.0)
    for k in CPU_COMPONENTS:
        out[f"cpu_{k}"] = abs(ca[k] - cb[k]) / cpu_ref
    ma, mb = a.mem_components(), b.mem_components()
    mem_ref = max(a.normalized_memory, b.normalized_memory, 1.0)
    for k in MEM_COMPONENTS:
        out[f"mem_{k}"] = abs(ma[k] - mb[k]) / mem_ref
    return out


def attribution_table(ledgers: list[OverheadLedger]) -> str:
    """The human-readable summary table the trace CLI prints: one line per
    component, one column per engine, plus the parity gap when both engines
    are present."""
    by = {led.engine: led for led in ledgers}
    gaps = (ledger_parity(by["eventsim"], by["simjax"])
            if {"eventsim", "simjax"} <= set(by) else {})
    cols = [led.engine for led in ledgers]
    lines = [f"{'component':24s} " + " ".join(f"{c:>10s}" for c in cols)
             + ("        gap" if gaps else "")]
    rows = [("cpu_overhead", [led.cpu_overhead for led in ledgers], None)]
    for k in CPU_COMPONENTS:
        rows.append((f"  cpu.{k}",
                     [led.cpu_components()[k] for led in ledgers],
                     gaps.get(f"cpu_{k}")))
    rows.append(("normalized_memory",
                 [led.normalized_memory for led in ledgers], None))
    for k in MEM_COMPONENTS:
        rows.append((f"  mem.{k}",
                     [led.mem_components()[k] for led in ledgers],
                     gaps.get(f"mem_{k}")))
    for name, vals, gap in rows:
        line = f"{name:24s} " + " ".join(f"{v:10.4f}" for v in vals)
        if gap is not None:
            line += f"  {gap:9.3f}"
        lines.append(line)
    return "\n".join(lines)
