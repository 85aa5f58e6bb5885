#!/usr/bin/env python3
"""chip_smoke.py's dry-run phases on one card, without the rest of it.

    python3 tools/dryrun_phases.py          # one CUDA card, ~1 min

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then
``dryrun.constants`` (a bf16 matmul and a device-to-device copy beside
``repro_torch.launch.hopper``'s constants), ``dryrun.check`` (gemma3-4b's
plain-path prefill and decode step counted on the meta device and run on
the card: matmul FLOPs, arguments, peak memory, the bound against the
call's time) and ``dryrun.cli`` (``python -m repro_torch.launch.dryrun`` as
a subprocess) as they are.  No kernel of this repo is built or run.
Imports torch and repro_torch only.
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
        print("dryrun_phases: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    chip_smoke.env_phase()
    t_run = time.monotonic()

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        chip_smoke.phase("wall", phase=name, seconds=f"{time.monotonic() - t0:.2f}",
                         since_start=f"{time.monotonic() - t_run:.2f}")
        return out
    chip_smoke.dryrun_phases(chip_smoke.dryrun_modules(), registry, get_config, timed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
