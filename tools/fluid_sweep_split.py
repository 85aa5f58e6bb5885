#!/usr/bin/env python3
"""Where the wall of a frontier sweep's batch goes, on one card.

    python3 tools/fluid_sweep_split.py            # ~1.5 min
    python3 tools/fluid_sweep_split.py --label C  # a name for the tree, echoed in the line

Runs ``chip_smoke.py``'s ``fluid.sweep`` batch (one ``_chunked_summaries`` call over
64 async points at window 600 on fig9_production, from
``tests/data/torch_fluid_jax_rows.json``) and splits its wall into the host
preparation (``_host_inputs`` and ``_upload_run``), the span of the 64 rows' slowdown solves
(``_acc_summary``) and the rest (the tick loop and the read back); the peak memory
above what was held before; the rows at targets 0.7 and 1.0 held to the JAX
package's.  Then one profiled chunk of sync ka 600 (``fluid.fig9.profile``):
launches, device busy and wall a tick, the idle share.  Prints one line
``SWEEP_SPLIT {json}``.  Two trees are compared by running this script from the
root of each in turns (A B B A).  Imports torch and repro_torch only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    fl = cs.fluid_modules()
    st = fl.st
    trace = cs.fluid_trace(fl, "fig9_production")
    spans = {"setup": [], "solve": []}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            spans[name].append((t0, time.monotonic()))
            return out
        return call
    st._host_inputs = timed("setup", st._host_inputs)
    st._upload_run = timed("setup", st._upload_run)
    st._acc_summary = timed("solve", st._acc_summary)
    sw = fl.ref["sweep"]
    pols = [st.JaxPolicy(**sw["policy"], target=t) for t in sw["targets"]]
    base = cs.start_peak()
    t0 = time.monotonic()
    rows = st._chunked_summaries(
        trace, pols[0], st.stack_params([p.params() for p in pols]),
        np.zeros((len(pols), len(st._PFLEET)), np.float32), sim=fl.SimConfig(),
        dt=sw["dt"], num_nodes=sw["num_nodes"], provision_s=0.0, has_fleet=False,
        chunk_ticks=sw["chunk_ticks"], warmup_frac=0.5, nbins=256, device="cuda")
    wall = time.monotonic() - t0
    peak = cs.peak_above(base)
    setup = sum(e - s for s, e in spans["setup"])
    solves = max(e for _, e in spans["solve"]) - min(s for s, _ in spans["solve"])
    by_target = dict(zip(sw["targets"], rows))
    held = {t: cs.hold_ref_row(fl, by_target[float(t)], fl.runs[name]["row"], t)
            for t, name in sw["held"].items()}
    prof = cs.fluid_profile(fl, trace, fl.runs[cs.FLUID_PROFILED_RUN])
    print("SWEEP_SPLIT " + json.dumps(dict(
        tree=args.label, wall_s=round(wall, 3), setup_s=round(setup, 3),
        solves_span_s=round(solves, 3), rest_s=round(wall - setup - solves, 3),
        peak_mem_bytes=peak, held=held, launches_per_tick=prof["launches_per_tick"],
        busy_us_per_tick=prof["device_busy_us_per_tick"],
        wall_ms_per_tick=prof["wall_ms_per_tick"],
        idle_unprofiled=prof["idle_share_unprofiled"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
