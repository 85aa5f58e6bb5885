#!/usr/bin/env python3
"""chip_smoke.py's mesh phases on one card, without the rest of it.

    python3 tools/mesh_phases.py                  # one CUDA card, ~5-8 min
    python3 tools/mesh_phases.py --only uneven    # mesh.uneven alone

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then
``mesh.hold`` (gemma3-4b at full width on a (1, 2) mesh of two ranks on
cuda:0 held to its unsharded run), ``mesh.rank`` (one rank of the dry run's
decode_32k cell on 16x16 run on the card beside its count) and
``mesh.uneven`` (every family's smoke config on the (1, 3), (2, 2, 2) and
(4, 2) meshes of the CPU tests, threaded ranks on cuda:0, each held to its
unsharded run) as they are.  chip_smoke.py runs ``mesh.uneven`` through
``--only uneven`` in a process of its own, beside its other phases.  No
kernel of this repo is built or run.  Imports torch and repro_torch only.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PHASES = ("hold", "rank", "uneven")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=PHASES, default=list(PHASES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import registry
    card = chip_smoke.env_phase()
    t_run = time.monotonic()
    ms = chip_smoke.mesh_modules()
    phases = {"hold": (chip_smoke.mesh_hold_phase, (ms, registry, get_config, card)),
              "rank": (chip_smoke.mesh_rank_phase, (ms, get_config, card)),
              "uneven": (chip_smoke.mesh_uneven_phase, (ms, registry, get_smoke_config, card))}
    for name in args.only:
        fn, fargs = phases[name]
        t0 = time.monotonic()
        fn(*fargs)
        chip_smoke.phase("wall", phase=f"mesh.{name}", seconds=f"{time.monotonic() - t0:.2f}",
                         since_start=f"{time.monotonic() - t_run:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
