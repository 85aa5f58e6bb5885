"""The port's oracle-vs-fluid parity bands at 0.25 x, as the JAX package's
tests hold them for ``repro.scenarios`` (``tests/test_scenarios.py``): every
oracle-feasible single-cell scenario replays through both engines from one
spec with at most a 15% relative gap on slowdown, normalized memory and
creation rate.  (The cells scenarios' bands are in ``test_torch_cells.py``;
fig9_production's is checked on the card by ``chip_smoke.py``.)"""

import pytest

from repro_torch.core.runspec import RunSpec
from repro_torch.scenarios import PARITY_KEYS, parity_report, run_scenario

PARITY_SCENARIOS = ["diurnal", "flash_crowd", "cold_tail", "multi_tenant",
                    "fleet_cost_stress"]


@pytest.mark.parametrize("name", PARITY_SCENARIOS)
def test_scenario_parity_oracle_vs_fluid(name):
    rows = run_scenario(name, spec=RunSpec(scale=0.25), device="cpu")
    assert {r["engine"] for r in rows} == {"eventsim", "simjax"}
    gaps = parity_report(rows)
    assert set(gaps) == set(PARITY_KEYS)
    for metric, gap in gaps.items():
        assert gap <= 0.15, (name, metric, gap)


def test_parity_report_needs_both_engines():
    rows = run_scenario("cold_tail", spec=RunSpec(scale=0.1, engines=("simjax",)),
                        device="cpu")
    assert parity_report(rows) == {}
