"""The JAX package's rows for the sharded runs of ``chip_smoke.py``'s
``dist.*`` phases.

``chip_smoke.py`` imports no jax, so it holds the port's two-shard runs on
the card to rows that the JAX package computed on the CPU under forced host
devices (``torch_dist_common.jax_jobs``) and that this file writes:

    PYTHONPATH=src python tests/test_torch_dist_reference.py   # about a minute

-> ``tests/data/torch_dist_jax_rows.json``:

* ``planet``: fig9_planet's base, unclustered, at full size (100,000
  functions, 1,200 ticks of 2 s, 2,500 nodes, chunks of 256, sync ka 600:
  ``tests/test_torch_fluid_reference.py``'s ``planet.sync_ka600`` run) at
  ``RunSpec(devices=2)``: the function axis over two devices;
* ``points``: ``evaluate_scenario("fleet_cost_stress", 4 points,
  RunSpec(scale=0.25, devices=2))``: 75 functions, 900 ticks, a fleet, the
  point axis over two devices.

Under pytest the ``points`` rows are recomputed with the JAX package (in
the subprocess) and held to the file, so the file cannot go stale, and the
port's two CPU shards are held to them.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

from test_torch_fluid_reference import RUNS as FLUID_RUNS
from test_torch_fluid_reference import TRACES as FLUID_TRACES
from torch_dist_common import jax_jobs

REF = Path(__file__).resolve().parent / "data" / "torch_dist_jax_rows.json"

_PLANET_RUN = next(r for r in FLUID_RUNS if r["name"] == "planet.sync_ka600")
PLANET = dict(kind="chunked",
              trace=dict(kind="rates", tick_s=FLUID_TRACES["fig9_planet"]["tick_s"],
                         config=FLUID_TRACES["fig9_planet"]["config"]),
              policy=_PLANET_RUN["policy"], fleet=None, dt=_PLANET_RUN["dt"],
              num_nodes=_PLANET_RUN["num_nodes"], chunk_ticks=_PLANET_RUN["chunk_ticks"],
              spec=dict(devices=2))
POINTS = dict(kind="evaluate_scenario", name="fleet_cost_stress",
              points=[{"keepalive_s": ka} for ka in (60.0, 300.0, 600.0, 1800.0)],
              spec=dict(scale=0.25, devices=2))
TOLERANCES = dict(row_rtol=1e-4, slowdown_rtol=1e-3, unsharded_rtol=1e-5)


def write() -> None:
    planet, points = jax_jobs([PLANET, POINTS], timeout=3600.0)
    REF.write_text(json.dumps(dict(
        about="rows of the JAX package at RunSpec(devices=2) (JAX on the CPU, two of "
              "eight forced host devices) for chip_smoke.py's dist.* phases; written by "
              "python tests/test_torch_dist_reference.py",
        tolerances=TOLERANCES, planet=dict(PLANET, row=planet),
        points=dict(POINTS, rows=points)), indent=1) + "\n")


def _hold(got: dict, want: dict, rtol: float):
    for k, v in want.items():
        if isinstance(v, float) and k not in ("wall_s", "stage_wall_s"):
            tol = max(rtol, TOLERANCES["slowdown_rtol"]) \
                if k == "slowdown_geomean_p99" else rtol
            assert got[k] == pytest.approx(v, rel=tol, abs=1e-12), k
        elif k not in ("wall_s", "stage_wall_s"):
            assert got[k] == v, k


def test_reference_file_matches_the_jax_package():
    ref = json.loads(REF.read_text())
    assert {k: ref["planet"][k] for k in PLANET} == PLANET
    assert {k: ref["points"][k] for k in POINTS} == POINTS
    assert ref["tolerances"] == TOLERANCES
    # the planet run is fluid.planet's at two devices: its row sits within
    # the sharded tolerance of the unsharded JAX row
    fluid = json.loads((REF.parent / "torch_fluid_jax_rows.json").read_text())
    one = next(r for r in fluid["runs"] if r["name"] == "planet.sync_ka600")["row"]
    assert ref["planet"]["row"].keys() == one.keys()
    _hold(ref["planet"]["row"], one, TOLERANCES["row_rtol"])
    rows = jax_jobs([POINTS])[0]
    assert len(rows) == len(ref["points"]["rows"]) == 4
    for got, want in zip(rows, ref["points"]["rows"]):
        assert got.keys() == want.keys()
        _hold(got, want, 1e-6)


def test_the_port_on_two_cpu_shards_holds_the_points_rows():
    from repro_torch.core.runspec import RunSpec
    from repro_torch.opt import evaluate_scenario
    ref = json.loads(REF.read_text())["points"]
    rows = evaluate_scenario(POINTS["name"], POINTS["points"], spec=RunSpec(**POINTS["spec"]),
                             device="cpu")
    for got, want in zip(rows, ref["rows"]):
        assert got.keys() == want.keys()
        _hold(got, want, TOLERANCES["row_rtol"])


if __name__ == "__main__":
    sys.exit(write())
