#!/usr/bin/env python3
"""The optimizer on one card: chip_smoke.py's opt phases, and the two runs too
long for it.

    python3 tools/opt_phases.py                  # one CUDA card, ~18 min
    python3 tools/opt_phases.py --only smoke     # the opt.* phases alone, ~2-4 min
    python3 tools/opt_phases.py --only full fig11 --out chiprun_out/opt

Runs chip_smoke.py's ``env`` phase (the card's name and power limit), then:

* ``smoke``: chip_smoke.py's ``opt.frontier``, ``opt.evo``, ``opt.learned`` and
  ``opt.cli`` phases as they are (the CLI's runs beside the other three), held
  to ``tests/data/torch_opt_jax_rows.json``;
* ``full``: the frontier CLI's default run, ``python -m
  repro_torch.launch.frontier --spot-check 3 --telemetry``: every event-level
  scenario, ``DEFAULT_SPACE`` coarse at 0.1 x, the pooled survivors refined at
  1.0 x, three oracle spot-checks a scenario at 0.25 x; its exit code (1 is
  its verdict that a scenario's front failed the oracle, printed), its
  artifacts under ``--out``, the wall of each stage and scenario from its
  telemetry, and its total wall;
* ``fig11``: ``benchmarks/fig11_learned_policy.py``'s training (fleet_cost_stress
  at 0.25 x, 50 Adam steps) with ``evaluate_trained`` and ``confirm`` at 0.25 x:
  the 50-step loss history against the JAX package's (the reference file's
  ``learned50``, at ``history50_rtol``), the trained ``theta``, the row, the
  oracle verdict, the wall of each part.

Prints one line a phase, as chip_smoke.py does.  No kernel of this repo is
built or run.  Imports torch and repro_torch only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FULL_TIMEOUT = 3000


def full_phase(out: Path) -> None:
    """The frontier CLI's default run on the card, as a user starts it."""
    out_dir = out / "frontier_full"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + (os.pathsep + path if path else ""))
    cmd = [sys.executable, "-m", "repro_torch.launch.frontier", "--spot-check", "3",
           "--telemetry", "--out-dir", str(out_dir)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=FULL_TIMEOUT)
    wall = time.monotonic() - t0
    (out / "frontier_full.log").write_text(proc.stderr)
    # exit 1 is the CLI's verdict (an empty confirmed front, or a scenario with
    # no sampled winner inside the parity band): a finding, printed below
    failures = [line for line in proc.stderr.splitlines()
                if line.startswith("FRONTIER FAILURE")]
    if proc.returncode not in (0, 1) or (proc.returncode == 1) != bool(failures):
        raise AssertionError(f"frontier CLI exit {proc.returncode}: {proc.stderr[-3000:]}")
    events = json.loads((out_dir / "telemetry.json").read_text())["events"]
    stages = {}
    for e in events:
        if e["event"] in ("frontier_coarse", "frontier_refine"):
            stages.setdefault(e["scenario"], {})[e["event"].split("_")[1]] = e["wall_s"]
    for name, walls in sorted(stages.items()):
        coarse = next(e for e in events if e["event"] == "frontier_coarse"
                      and e["scenario"] == name)
        refine = next(e for e in events if e["event"] == "frontier_refine"
                      and e["scenario"] == name)
        spot = next((e for e in events if e["event"] == "spot_check"
                     and e["scenario"] == name), None)
        chip_smoke.phase("opt.full", run=name, coarse_sims=coarse["sims"],
                         coarse_wall_s=walls["coarse"], refine_sims=refine["sims"],
                         survivors=refine["survivors"], refine_wall_s=walls["refine"],
                         front_size=refine["front_size"],
                         hypervolume=f"{refine['hypervolume']:.6g}",
                         spot_checked=spot["checked"] if spot else 0,
                         spot_passed=spot["passed"] if spot else 0,
                         spot_demoted=spot["demoted"] if spot else 0)
    summary = json.loads((out_dir / "frontier.json").read_text())["summary"]
    reduce = next(e for e in events if e["event"] == "frontier_reduce")
    chip_smoke.phase("opt.full", scenarios=len(stages), rc=proc.returncode,
                     wall_s=f"{wall:.1f}", search_wall_s=reduce["wall_s"],
                     coarse_s=f"{sum(w['coarse'] for w in stages.values()):.2f}",
                     refine_s=f"{sum(w['refine'] for w in stages.values()):.2f}",
                     robust_point_ids=summary["robust_point_ids"], failures=failures)


def fig11_phase(om) -> None:
    """fig11's training run and its readouts, held to the JAX package's."""
    args, want = om.ref["learned50_args"], om.ref["learned50"]
    L, spent = om.learned, {}
    with chip_smoke.part(spent, "train_policy"):
        res = L.train_policy(args["scenario"], scale=args["scale"], steps=args["steps"],
                             seed=args["seed"], device=chip_smoke.DEVICE)
    h, w = np.asarray(res.history), np.asarray(want["history"])
    rel = np.abs(h - w) / np.abs(w)
    if len(h) != len(w) or not rel.max() <= om.tol["history50_rtol"]:
        raise AssertionError(f"fig11: history {res.history} against {want['history']}")
    theta_err = max(float(np.abs(np.asarray(res.policy.theta[k], np.float64)
                                 - np.asarray(v)).max()) for k, v in want["theta"].items())
    with chip_smoke.part(spent, "evaluate_trained"):
        row = L.evaluate_trained(args["scenario"], res, scale=args["scale"],
                                 device=chip_smoke.DEVICE)
    row_err = chip_smoke.hold_opt_rows(om, [row], [want["row"]], "fig11 row")
    with chip_smoke.part(spent, "confirm"):
        check = L.confirm(args["scenario"], res, scale=args["scale"], device=chip_smoke.DEVICE)
    chip_smoke.phase("opt.fig11", run=args["scenario"], scale=args["scale"],
                     steps=args["steps"], s_per_step=f"{spent['train_policy'] / (len(h)):.3f}",
                     history=[f"{x:.7g}" for x in res.history],
                     jax_history=[f"{x:.7g}" for x in want["history"]],
                     history_max_rel_err=f"{rel.max():.3g}", theta_max_abs_err=f"{theta_err:.3g}",
                     row_max_rel_err_vs_jax=row_err,
                     cost_per_million=f"{row['cost_per_million']:.6g}",
                     slowdown_geomean_p99=f"{row['slowdown_geomean_p99']:.6g}",
                     oracle_pass=check["pass"], jax_oracle_pass=want["confirm"]["pass"],
                     oracle_gaps={k: f"{v:.4f}" for k, v in check["gaps"].items()},
                     phase_parts_s=chip_smoke.parts(spent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=["smoke", "full", "fig11"],
                    default=["smoke", "full", "fig11"])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "opt"),
                    help="where the full run writes its artifacts and log")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("opt_phases: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    chip_smoke.env_phase()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    t_run = time.monotonic()

    def timed(name, fn, *a):
        t0 = time.monotonic()
        res = fn(*a)
        chip_smoke.phase("wall", phase=name, seconds=f"{time.monotonic() - t0:.2f}",
                         since_start=f"{time.monotonic() - t_run:.2f}")
        return res
    om = chip_smoke.opt_modules()
    if "smoke" in args.only:
        chip_smoke.opt_phases(om, timed)
    if "fig11" in args.only:
        timed("opt.fig11", fig11_phase, om)
    if "full" in args.only:
        timed("opt.full", full_phase, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
