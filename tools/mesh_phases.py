#!/usr/bin/env python3
"""chip_smoke.py's mesh phases on one card, without the rest of it.

    python3 tools/mesh_phases.py          # one CUDA card, ~1-2 min

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then
``mesh.hold`` (gemma3-4b at full width on a (1, 2) mesh of two ranks on
cuda:0 held to its unsharded run) and ``mesh.rank`` (one rank of the dry
run's decode_32k cell on 16x16 run on the card beside its count) as they
are.  No kernel of this repo is built or run.  Imports torch and
repro_torch only.
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
        print("mesh_phases: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    card = chip_smoke.env_phase()
    t_run = time.monotonic()
    ms = chip_smoke.mesh_modules()
    for name, fn, args in (("mesh.hold", chip_smoke.mesh_hold_phase,
                            (ms, registry, get_config, card)),
                           ("mesh.rank", chip_smoke.mesh_rank_phase, (ms, get_config, card))):
        t0 = time.monotonic()
        fn(*args)
        chip_smoke.phase("wall", phase=name, seconds=f"{time.monotonic() - t0:.2f}",
                         since_start=f"{time.monotonic() - t_run:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
