#!/usr/bin/env python3
"""K1's and K4's checks and timings on one card, without the rest of chip_smoke.py.

    python3 tools/k1_k4_designs.py                 # one CUDA card, ~1-2 min with the builds
    python3 tools/k1_k4_designs.py --segments 128 256 512

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), builds the
decode-attention and wkv-scan libraries together (their ptxas lines), then
chip_smoke.py's ``kernel`` phase (K1 against its plain version at both decode shapes,
f32 and bf16, softcap on and off, garbage past pos; timed at the full cache and at
serving positions against SDPA and the bound) and ``kernel.rwkv6_scan`` phase (K4 over
its sweep, a non-zero state and the hard decay; timed per call and per stage at
rwkv6-3b's prefill call) as they are.  With ``--segments``, K4's time at each segment
length in turns.  Last, their numbers as one JSON line.  Imports torch and repro_torch
only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import ops as k1_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_f64_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as k4_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref  # noqa: E402


def k4_segment_sweep(ops, segments, reps: int = 2) -> dict:
    """K4 at rwkv6-3b's prefill call (bf16, with s0) at each segment length, in
    turns (reps rounds over the list) -> median us per call per segment."""
    gen = torch.Generator(device=chip_smoke.DEVICE).manual_seed(4)
    r, k, v, lw, u = chip_smoke.k4_inputs(chip_smoke.K4_MODEL, torch.bfloat16, gen)
    b, _, h, d = chip_smoke.K4_MODEL
    s0 = torch.zeros((b, h, d, d), device=chip_smoke.DEVICE)
    times: dict = {seg: [] for seg in segments}
    for _ in range(reps):
        for seg in segments:
            times[seg].append(chip_smoke.time_ms(lambda: ops._launch(r, k, v, lw, u, s0, seg),
                                                 iters=20))
    out = {seg: round(statistics.median(x) * 1e3, 3) for seg, x in times.items()}
    chip_smoke.phase("kernel.rwkv6_scan.segments", shape=chip_smoke.K4_MODEL,
                     us_per_call=out, kept=ops.SEGMENT)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, nargs="*", default=[],
                    help="K4 segment lengths (multiples of 16) to time in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k4_designs: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    chip_smoke.env_phase()
    chip_smoke.build_phase({"decode_attention": k1_ops, "rwkv6_scan": k4_ops})
    k1 = chip_smoke.kernel_phase(k1_ops, decode_attention_ref, decode_attention_f64_ref)
    k4 = chip_smoke.rwkv6_scan_phase(k4_ops, rwkv6_scan_ref)
    if args.segments:
        k4["segments"] = k4_segment_sweep(k4_ops, args.segments)
    print(json.dumps({"decode_attention": k1, "rwkv6_scan": k4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
