"""The JAX package's rows for the fluid engine's full-size runs on the card.

``chip_smoke.py`` imports no jax, so it holds the port's
full-size fluid runs (fig9_production's six policies, its fleet and spot
runs, fig9_planet's base) to rows that the JAX package computed on the CPU
and that this file writes:

    PYTHONPATH=src python tests/test_torch_fluid_reference.py   # a few minutes

-> ``tests/data/torch_fluid_jax_rows.json``: the two traces' configurations
and sizes, every run's configuration (policy, fleet, dt, nodes, chunk) with
the JAX row, and the 64-point sweep that ``chip_smoke.py`` runs.  Under
pytest, one run (sync ka 600 on fig9_production) is recomputed with the JAX
package and held to the file, so the file cannot go stale; and the port on
the CPU is held to the file's fig9 async w60 t0.7 row, the one whose
creations differ from JAX's (ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.simjax import JaxFleet, JaxPolicy, simulate_chunked
from repro.core.trace import TraceConfig, synthesize, synthesize_rates

REF = Path(__file__).resolve().parent / "data" / "torch_fluid_jax_rows.json"

TRACES = {
    # src/repro/scenarios/registry.py: fig9_production's and fig9_planet's base
    "fig9_production": dict(kind="events", tick_s=1.0,
                            config=dict(num_functions=2000, duration_s=4800.0,
                                        target_total_rps=729.0, seed=9)),
    "fig9_planet": dict(kind="rates", tick_s=2.0,
                        config=dict(num_functions=100_000, duration_s=2400.0,
                                    target_total_rps=20_900.0, seed=13)),
}
FIG9 = dict(trace="fig9_production", dt=1.0, num_nodes=50, chunk_ticks=512)
RUNS = [
    # benchmarks/fig9_large_scale.py's six policies
    dict(name="fig9.sync_ka60", policy=dict(kind=0, keepalive_s=60), **FIG9),
    dict(name="fig9.sync_ka600", policy=dict(kind=0, keepalive_s=600), **FIG9),
    dict(name="fig9.sync_ka1800", policy=dict(kind=0, keepalive_s=1800), **FIG9),
    dict(name="fig9.async_w60_t0.7", policy=dict(kind=1, window_s=60, target=0.7), **FIG9),
    dict(name="fig9.async_w600_t0.7", policy=dict(kind=1, window_s=600, target=0.7), **FIG9),
    dict(name="fig9.async_w600_t1.0", policy=dict(kind=1, window_s=600, target=1.0), **FIG9),
    # the two-level fleet, and the spot tier under it
    dict(name="fleet.sync_ka600", policy=dict(kind=0, keepalive_s=600), fleet={}, **FIG9),
    dict(name="fleet.spot_aware", policy=dict(family="spot_aware", keepalive_s=600,
                                              extra=dict(spot_fraction=0.5,
                                                         hazard_per_hour=2.0)),
         fleet={}, **FIG9),
    # fig9_planet's base, unclustered: the float32 slowdown solver's path
    dict(name="planet.sync_ka600", policy=dict(kind=0, keepalive_s=600),
         trace="fig9_planet", dt=2.0, num_nodes=2500, chunk_ticks=256),
]
# a frontier sweep's batched shape: 64 async points at window 600, targets
# from 0.1 to 4.0 with 0.7 and 1.0 among them (held to the fig9 rows)
_TARGETS = sorted({round(float(x), 6) for x in np.linspace(0.1, 4.0, 62)} | {0.7, 1.0})
SWEEP = dict(trace="fig9_production", policy=dict(kind=1, window_s=600), targets=_TARGETS,
             held={"0.7": "fig9.async_w600_t0.7", "1.0": "fig9.async_w600_t1.0"},
             alone=[_TARGETS[i] for i in (0, 21, 42, 63)], num_nodes=50, chunk_ticks=512,
             dt=1.0)
TOLERANCES = dict(row_rtol=1e-4, slowdown_rtol=1e-3, batched_vs_alone_rtol=1e-6)


def build_trace(name: str):
    t = TRACES[name]
    cfg = TraceConfig(**t["config"])
    return synthesize(cfg) if t["kind"] == "events" else synthesize_rates(cfg, tick_s=t["tick_s"])


def jax_row(run: dict, trace) -> dict:
    fleet = JaxFleet(**run["fleet"]) if run.get("fleet") is not None else None
    return simulate_chunked(trace, JaxPolicy(**run["policy"]), dt=run["dt"],
                            num_nodes=run["num_nodes"], fleet=fleet,
                            chunk_ticks=run["chunk_ticks"])


def write() -> None:
    assert len(SWEEP["targets"]) == 64, len(SWEEP["targets"])
    traces, runs = {}, []
    for name in TRACES:
        trace = build_trace(name)
        traces[name] = dict(TRACES[name], requests=len(trace))
        for run in (r for r in RUNS if r["trace"] == name):
            row = jax_row(run, trace)
            runs.append(dict(run, row=row))
            print(run["name"], row["slowdown_geomean_p99"], row["normalized_memory"],
                  row["cpu_overhead"], flush=True)
    REF.parent.mkdir(parents=True, exist_ok=True)
    REF.write_text(json.dumps(dict(
        about="rows of repro.core.simjax.simulate_chunked (JAX on the CPU) for the "
              "full-size fluid runs chip_smoke.py holds the port to; written by "
              "python tests/test_torch_fluid_reference.py",
        tolerances=TOLERANCES, traces=traces, runs=runs, sweep=SWEEP), indent=1) + "\n")


def test_reference_file_matches_the_jax_package():
    ref = json.loads(REF.read_text())
    assert [r["name"] for r in ref["runs"]] == [r["name"] for r in RUNS]
    for got, want in zip(ref["runs"], RUNS):
        assert {k: got[k] for k in want} == want
    assert ref["sweep"] == SWEEP and ref["tolerances"] == TOLERANCES
    assert {k: {f: v[f] for f in TRACES[k]} for k, v in ref["traces"].items()} == TRACES
    trace = build_trace("fig9_production")
    assert len(trace) == ref["traces"]["fig9_production"]["requests"] == 3_502_489
    run = next(r for r in ref["runs"] if r["name"] == "fig9.sync_ka600")
    row = jax_row(run, trace)
    assert row.keys() == run["row"].keys()
    for k, v in run["row"].items():
        assert row[k] == pytest.approx(v, rel=1e-6), k


def test_the_port_on_the_cpu_holds_fig9_async_w60_three_creations_over():
    """The port on the CPU at full size against the file's fig9 async w60 t0.7
    row: every metric within the file's tolerances, and 3 creations more than
    JAX over the 2400 measured ticks (7.3e-5 of creation_rate, as on the card),
    where the port's division order tips a ceil at an exact integer
    (ROADMAP Queue 3; test_torch_simtorch.py::
    test_async_ceil_at_an_exact_integer_follows_the_division_order)."""
    import repro_torch.core.simtorch as T
    import repro_torch.core.trace as TT
    ref = json.loads(REF.read_text())
    run = next(r for r in ref["runs"] if r["name"] == "fig9.async_w60_t0.7")
    trace = TT.synthesize(TT.TraceConfig(**TRACES[run["trace"]]["config"]))
    row = T.simulate_chunked(trace, T.JaxPolicy(**run["policy"]), dt=run["dt"],
                             num_nodes=run["num_nodes"], chunk_ticks=run["chunk_ticks"],
                             device="cpu")
    want, tol = run["row"], ref["tolerances"]
    assert row.keys() == want.keys()
    for k, v in want.items():
        rel = tol["slowdown_rtol"] if k == "slowdown_geomean_p99" else tol["row_rtol"]
        assert row[k] == pytest.approx(v, rel=rel, abs=1e-12), k
    window = want["ticks_measured"] * run["dt"]
    assert (row["creation_rate"] - want["creation_rate"]) * window == pytest.approx(3.0, abs=1e-6)


if __name__ == "__main__":
    sys.exit(write())
