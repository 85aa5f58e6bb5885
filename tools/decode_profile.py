#!/usr/bin/env python3
"""Where a full-width decode step's device time goes, kernel by kernel, on one card.

    python3 tools/decode_profile.py --arch gemma3-4b          # ~1 min with the K1 build
    python3 tools/decode_profile.py --arch deepseek-moe-16b --rounds 3 --out profile.json

Builds the replica chip_smoke.py's ``model`` phase builds (bf16, random weights from
seed 0, 2 slots of 300-token prompts, max_seq 2048), runs 40 warm decode steps, then
``--rounds`` rounds of ``--steps`` steps under the profiler (pos 40-50 in the first
round, as chip_smoke.py's decode profile).  Per round: device busy per step (the union
of kernel intervals), the host's wall per step, the repo's kernels' time per call; and
every kernel name's device time per step.  Prints the rounds and the per-kernel medians
over the rounds as one JSON line, and writes them to ``--out`` when given.  Two source
trees are compared by running this script from each in turns (A, B, B, A).  Imports
torch and repro_torch only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving.engine import ModelReplica, ServeRequest  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--steps", type=int, default=10, help="decode steps a profiled round")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    card = chip_smoke.env_phase()
    cfg = get_config(args.arch).replace(param_dtype="bfloat16", remat="none",
                                        attn_impl="kernel")
    rep = ModelReplica(cfg, max_slots=chip_smoke.MAX_SLOTS, max_seq=chip_smoke.MAX_SEQ,
                       seed=0, device=chip_smoke.DEVICE)
    rng = np.random.default_rng(1)
    for i in range(chip_smoke.MAX_SLOTS):
        prompt = rng.integers(0, cfg.vocab_size, 300).tolist()
        rep.add(ServeRequest(rid=i, fn=0, prompt=prompt, max_new_tokens=1), 0.0)
    for s in range(40):
        rep.step(float(s))
    step = iter(range(40, 40 + args.steps * args.rounds))
    rounds, per_kernel = [], {}
    for _ in range(args.rounds):
        wall, kern, spans = chip_smoke.device_kernels(lambda: rep.step(float(next(step))),
                                                      args.steps)
        if not kern:
            raise AssertionError("the profiler saw no kernels")
        summ = chip_smoke.kernel_summary(kern, spans, args.steps)
        rounds.append(dict(wall_ms_per_step=round(wall * 1e3, 3),
                           device_busy_ms_per_step=round(summ["device_busy_ms"], 4),
                           kernels_per_step=summ["kernels"],
                           **{name: summ[name] for name in chip_smoke.KERNEL_NAMES}))
        chip_smoke.phase("decode_profile.round", arch=args.arch, **rounds[-1])
        for e in kern:
            per_kernel.setdefault(e.key, []).append(
                (e.self_device_time_total / args.steps / 1e3, e.count / args.steps))
    kernels = {name: dict(ms_per_step=round(statistics.median(t for t, _ in x), 5),
                          calls_per_step=statistics.median(c for _, c in x))
               for name, x in per_kernel.items()}
    kernels = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms_per_step"]))
    out = dict(card=card, arch=args.arch, steps=args.steps, rounds=rounds,
               device_busy_ms_per_step=statistics.median(
                   r["device_busy_ms_per_step"] for r in rounds),
               kernels=kernels)
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
