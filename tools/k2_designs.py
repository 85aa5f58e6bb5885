#!/usr/bin/env python3
"""K2's designs held and timed on one card, without the rest of chip_smoke.py.

    python3 tools/k2_designs.py          # one CUDA card, ~1-2 min with the build

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), builds
the flash-attention library alone (its ptxas lines), then chip_smoke.py's
``kernel.flash_attention`` phase as it is: every design on every K2 shape it
takes, held to the plain version and each bf16 design to its own arithmetic,
rows that see no key, the wgmma kernels' registers and spills, and both bf16
designs timed in turns at gemma3-4b's global and local and deepseek-moe-16b's
prefill shapes against SDPA and the bound.  Last, its numbers as one JSON
line.  Imports torch and repro_torch only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref, ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bf16p_ref,
    visible,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_designs: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    chip_smoke.env_phase()
    chip_smoke.build_phase({"flash_attention": ops})
    row = chip_smoke.flash_attention_phase(ops, flash_attention_ref, flash_attention_bf16p_ref,
                                           visible, ops.build)
    print(json.dumps({"flash_attention": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
