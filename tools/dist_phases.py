#!/usr/bin/env python3
"""chip_smoke.py's sharded-run phases on one card, without the rest of it.

    python3 tools/dist_phases.py          # one CUDA card, ~1.5 min

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then
``fluid.planet`` (fig9_planet's base at full size, held to the JAX
package's row; its trace and row are what ``dist.planet`` reuses), then the
``dist.planet``, ``dist.points`` and ``dist.cli`` phases as they are: the
sharded fluid run held to ``tests/data/torch_dist_jax_rows.json``, two
shards on cuda:0.  No kernel of this repo is built or run.  Imports torch
and repro_torch only.
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
        print("dist_phases: no CUDA device; this script needs one NVIDIA GPU",
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
    planet, planet_row = timed("fluid.planet", chip_smoke.fluid_planet_phase, fl)
    dm = chip_smoke.dist_modules(fl)
    timed("dist.planet", chip_smoke.dist_planet_phase, dm, planet, planet_row)
    del planet
    chip_smoke.free_cuda()
    timed("dist.points", chip_smoke.dist_points_phase, dm)
    timed("dist.cli", chip_smoke.dist_cli_phase, chip_smoke.scenario_modules(),
          chip_smoke.dist_cli_start())
    return 0


if __name__ == "__main__":
    sys.exit(main())
