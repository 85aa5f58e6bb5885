"""The JAX package's rows for the scenario layer's full-scale runs on the card.

``chip_smoke.py`` imports no jax, so it holds the port's ``run_scenario``
rows on the card to rows that the JAX package computed on the CPU and that
this file writes:

    PYTHONPATH=src python tests/test_torch_scenario_reference.py   # ~2 minutes

-> ``tests/data/torch_scenario_jax_rows.json``: the fluid leg's row of every
registered scenario at scale 1.0 (fig9_planet clustered at 0.05 rps), with
the cells scenarios' ``cell_rows``; the oracle-vs-fluid parity bands at
0.25 x that ``tests/test_scenarios.py`` and ``tests/test_cells.py`` hold,
with JAX's own gaps; and what the JAX CLIs print for the commands
``chip_smoke.py`` runs through the port's CLIs.  Under pytest, one cells
row (region_failover) is recomputed with the JAX package and with the port
on the CPU and both are held to the file, and the CLI outputs are
recomputed with the JAX CLIs, so the file cannot go stale.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile
from pathlib import Path

import pytest

REF = Path(__file__).resolve().parent / "data" / "torch_scenario_jax_rows.json"
OUT = "{OUT}"                      # the CLIs' --out-dir, as the file spells it

SCENARIOS = ["cell_hazard_corr", "cold_tail", "diurnal", "fig9_planet", "fig9_production",
             "flash_crowd", "fleet_cost_stress", "follow_the_sun", "multi_tenant",
             "region_failover", "spot_storm"]
FULL = [dict(name=n, scale=1.0, engines=["simjax"],
             cluster=0.05 if n == "fig9_planet" else 0.0) for n in SCENARIOS]
# the oracle-vs-fluid bands the JAX tests hold at 0.25 x: all three parity
# keys (tests/test_scenarios.py), slowdown and memory (test_cells.py and the
# fig9 test), and region_failover's one-seed smoke band
_ALL = ["slowdown_geomean_p99", "normalized_memory", "creation_rate"]
_TWO = _ALL[:2]
PARITY = {**{n: dict(keys=_ALL, band=0.15) for n in
             ("diurnal", "flash_crowd", "cold_tail", "multi_tenant", "fleet_cost_stress")},
          **{n: dict(keys=_TWO, band=0.15) for n in
             ("fig9_production", "follow_the_sun", "cell_hazard_corr")},
          "region_failover": dict(keys=_TWO, band=0.30)}
PARITY_SCALE = 0.25
CLI = [
    dict(name="scenarios.cold_tail", module="scenarios",
         argv=["--scenario", "cold_tail", "--scale", "0.1", "--parity"]),
    dict(name="trace.diurnal.0.1", module="trace",
         argv=["diurnal", "--scale", "0.1", "--check", "--out-dir", OUT]),
    dict(name="trace.diurnal.0.25", module="trace",
         argv=["diurnal", "--scale", "0.25", "--check", "--out-dir", OUT]),
]
TOLERANCES = dict(row_rtol=1e-4, slowdown_rtol=1e-3, cli_rtol=1e-3)
HELD_ON_THE_CPU = "region_failover"


def jax_full(run: dict):
    from repro.core.runspec import RunSpec
    from repro.scenarios import run_scenario
    detail: dict = {}
    rows = run_scenario(run["name"], detail=detail,
                        spec=RunSpec(scale=run["scale"], engines=tuple(run["engines"]),
                                     cluster=run["cluster"]))
    row = {k: v for k, v in rows[0].items() if k != "wall_s"}
    return row, detail.get("cell_rows")


def jax_gaps(name: str) -> dict:
    from repro.core.runspec import RunSpec
    from repro.scenarios import parity_report, run_scenario
    return parity_report(run_scenario(name, spec=RunSpec(scale=PARITY_SCALE)))


def jax_cli(cli: dict) -> dict:
    """Run a JAX CLI in this process -> its exit code, standard output and
    error, with the out-dir spelled ``{OUT}``, and the trace's ledger.json
    without walls."""
    import repro.launch.scenarios as scenarios
    import repro.launch.trace as trace
    main = {"scenarios": scenarios.main, "trace": trace.main}[cli["module"]]
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = str(Path(tmp) / "out")
        argv = [out_dir if a == OUT else a for a in cli["argv"]]
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        res = dict(rc=rc, stdout=out.getvalue().replace(out_dir, OUT),
                   stderr=err.getvalue().replace(out_dir, OUT))
        if cli["module"] == "trace":
            ledger = json.loads((Path(out_dir) / "ledger.json").read_text())
            for r in ledger["rows"]:
                r.pop("wall_s")
            res["ledger"] = ledger
    return res


def write() -> None:
    full = []
    for run in FULL:
        row, cell_rows = jax_full(run)
        full.append(dict(run, row=row, cell_rows=cell_rows))
        print(run["name"], row["slowdown_geomean_p99"], row["normalized_memory"], flush=True)
    parity = {n: dict(v, jax_gaps=jax_gaps(n)) for n, v in PARITY.items()}
    print("parity", {n: v["jax_gaps"] for n, v in parity.items()}, flush=True)
    cli = [dict(c, **jax_cli(c)) for c in CLI]
    REF.parent.mkdir(parents=True, exist_ok=True)
    REF.write_text(json.dumps(dict(
        about="rows of repro.scenarios.run_scenario (JAX on the CPU) for the scenario "
              "runs chip_smoke.py holds the port to, and the JAX CLIs' outputs; written "
              "by python tests/test_torch_scenario_reference.py",
        tolerances=TOLERANCES, full=full, parity_scale=PARITY_SCALE, parity=parity,
        cli=cli), indent=1) + "\n")


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF.read_text())


def test_reference_file_matches_the_jax_package(ref):
    from repro.scenarios import list_scenarios
    assert SCENARIOS == list_scenarios()
    assert [{k: r[k] for k in FULL[0]} for r in ref["full"]] == FULL
    assert ref["tolerances"] == TOLERANCES and ref["parity_scale"] == PARITY_SCALE
    assert {n: {k: v[k] for k in ("keys", "band")} for n, v in ref["parity"].items()} == PARITY
    for n, v in ref["parity"].items():
        assert all(v["jax_gaps"][k] <= v["band"] for k in v["keys"]), n
    assert [{k: c[k] for k in CLI[0]} for c in ref["cli"]] == CLI
    run = next(r for r in ref["full"] if r["name"] == HELD_ON_THE_CPU)
    row, cell_rows = jax_full(run)
    assert row.keys() == run["row"].keys()
    for k, v in run["row"].items():
        assert row[k] == pytest.approx(v, rel=1e-6), k
    for got, want in zip(cell_rows, run["cell_rows"]):
        assert got == pytest.approx(want, rel=1e-6)


def test_the_port_on_the_cpu_holds_region_failover_at_full_scale(ref):
    from repro_torch.core.runspec import RunSpec
    from repro_torch.scenarios import run_scenario
    run = next(r for r in ref["full"] if r["name"] == HELD_ON_THE_CPU)
    detail: dict = {}
    rows = run_scenario(run["name"], detail=detail, device="cpu",
                        spec=RunSpec(scale=run["scale"], engines=tuple(run["engines"]),
                                     cluster=run["cluster"]))
    got, want, tol = rows[0], run["row"], ref["tolerances"]
    assert got.keys() - {"wall_s"} == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            rel = tol["slowdown_rtol"] if k == "slowdown_geomean_p99" else tol["row_rtol"]
            assert got[k] == pytest.approx(v, rel=rel, abs=1e-12), k
        else:
            assert got[k] == v, k
    for g, w in zip(detail["cell_rows"], run["cell_rows"]):
        assert g == pytest.approx(w, rel=tol["row_rtol"], abs=1e-9)


@pytest.mark.parametrize("i", range(len(CLI)), ids=[c["name"] for c in CLI])
def test_cli_outputs_are_the_jax_clis(ref, i):
    got = jax_cli(CLI[i])
    want = ref["cli"][i]
    from torch_scenario_common import same_text, without_walls
    assert got["rc"] == want["rc"]
    assert without_walls(got["stdout"]) == without_walls(want["stdout"])
    assert got["stderr"] == want["stderr"]
    if "ledger" in want:
        assert same_text(json.dumps(got["ledger"]), json.dumps(want["ledger"]), rtol=1e-9)


if __name__ == "__main__":
    sys.exit(write())
