#!/usr/bin/env python3
"""chip_smoke.py's scenario phases on one card, without the rest of it.

    python3 tools/scenario_phases.py          # one CUDA card, ~3-4 min

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then
fig9_production's sync ka 600 row through ``simulate_chunked`` as
``fluid.fig9`` computes it (it stands in for the scenario layer's
fig9_production row, the same call), then the ``scenario.full``,
``scenario.parity``, ``scenario.cells`` and ``scenario.cli`` phases as they
are: every registered
scenario's fluid leg at full scale held to
``tests/data/torch_scenario_jax_rows.json``, one chunk of region_failover
profiled, the parity bands at 0.25 x, two cells runs bit for bit, one cell
against the plain engine, and the port's CLIs against the JAX CLIs' outputs.
No kernel of this repo is built or run.  Imports torch and repro_torch only.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("scenario_phases: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    chip_smoke.env_phase()
    t_run = time.monotonic()

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        chip_smoke.phase("wall", phase=name, seconds=f"{time.monotonic() - t0:.2f}",
                         since_start=f"{time.monotonic() - t_run:.2f}")
        return out
    fl = chip_smoke.fluid_modules()
    run = fl.runs[chip_smoke.FLUID_PROFILED_RUN]
    trace = chip_smoke.fluid_trace(fl, run["trace"])
    row, wall, _ = chip_smoke.fluid_call(fl, trace, run)
    chip_smoke.hold_ref_row(fl, row, run["row"], run["name"])
    chip_smoke.phase("fluid.fig9", run=run["name"], wall_s=f"{wall:.3f}")
    del trace
    sm = chip_smoke.scenario_modules()
    timed("scenario.full", chip_smoke.scenario_full_phase, sm, {run["name"]: row})
    parity = timed("scenario.parity", chip_smoke.scenario_parity_phase, sm)
    timed("scenario.cells", chip_smoke.scenario_cells_phase, sm, parity)
    timed("scenario.cli", chip_smoke.scenario_cli_phase, sm)
    return 0


if __name__ == "__main__":
    sys.exit(main())
