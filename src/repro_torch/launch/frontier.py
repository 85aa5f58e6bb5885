"""Frontier-search CLI — discover cost-efficient autoscaling configs.

Sweeps the joint (policy x fleet) parameter space through the batched
chunked fluid simulator across registered scenarios (coarse grid at
``coarse_frac`` x scale, successive-halving refine at full scale), then
emits per-scenario Pareto fronts, the cross-scenario robust frontier, and
oracle spot-check verdicts on sampled winners.

  PYTHONPATH=src python -m repro_torch.launch.frontier --scale 0.1
  PYTHONPATH=src python -m repro_torch.launch.frontier --scenario cold_tail \\
      --scenario diurnal --scale 0.25 --out-dir frontier_out
  PYTHONPATH=src python -m repro_torch.launch.frontier --scale 1.0 --spot-check 5
  PYTHONPATH=src python -m repro_torch.launch.frontier --scenario cold_tail \\
      --scale 0.25 --learned --learn-steps 60
  PYTHONPATH=src python -m repro_torch.launch.frontier --scenario fleet_cost_stress \\
      --scale 0.1 --algo evo --budget 24 --seed 0

``--algo evo`` swaps the exhaustive grid for the NSGA-II population
optimizer (``repro_torch.opt.evo``) over the same space and scenarios, budgeted
in simulated candidate-scenario pairs (``--budget``; default: exactly the
grid's own cost) — everything downstream (spot-checks, demotion, outputs)
applies unchanged.

``--learned`` additionally trains the gradient-learned policy family per
scenario (``repro_torch.opt.learned``: autograd through the fluid step),
evaluates it at the refine scale against the swept frontier, and
oracle-confirms it where the discrete replay is feasible.

Outputs in ``--out-dir``:
  frontier_<scenario>.csv   refined rows, with ``front``/``robust`` flags
  frontier_robust.csv       the robust frontier (one row per point x scenario)
  frontier.json             search summary + spot-check + learned records

Exit status is non-zero when a scenario ends with an empty oracle-confirmed
front or (with spot checks enabled) an oracle-feasible scenario where no
sampled winner passed the parity band.

The port of ``repro.launch.frontier``: the same flags, defaults, exit codes
and artifacts, plus ``--device`` (where the fluid runs and the training go:
the CUDA card unless ``--device cpu``; without a card and without
``--device cpu`` the run raises).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

from repro_torch.fleet.billing import get_profile, list_profiles
from repro_torch.launch.flags import (add_run_flags, add_search_flags,
                                      unknown_scenarios, validate_run_flags,
                                      validate_search_flags)
from repro_torch.opt.frontier import frontier_slack
from repro_torch.opt.search import frontier_search, oracle_spot_check
from repro_torch.opt.space import SWEEPABLE
from repro_torch.scenarios import get_scenario, list_scenarios

_METRICS = ["cost_per_million", "slowdown_geomean_p99", "normalized_memory",
            "creation_rate", "cpu_overhead", "nodes_mean", "node_cost",
            "idle_cost", "churn_cost", "completed", "total_cost",
            "request_cost", "duration_cost", "warm_pool_cost", "billed_gb_s"]


def _columns(rows: list[dict]) -> list[str]:
    knobs = sorted({k for r in rows for k in r} & SWEEPABLE)
    return (["scenario", "point_id"] + knobs + _METRICS
            + ["front", "robust", "scale"])


def _write_csv(path: str, rows: list[dict]) -> None:
    # an empty robust frontier is a finding, not a missing artifact: the
    # file still lands, header-only, so downstream tooling sees the schema
    cols = _columns(rows) if rows else (["scenario", "point_id"] + _METRICS
                                        + ["front", "robust", "scale"])
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=cols, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow({k: (f"{v:.6g}" if isinstance(v, float) else v)
                        for k, v in r.items() if k in cols})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.frontier",
        description="Cross-scenario multi-objective autoscaling-parameter "
                    "search (coarse+refine, Pareto + robust fronts).")
    ap.add_argument("--scenario", action="append", default=None,
                    help="scenario name (repeatable; default: every "
                         "registered event-level scenario)")
    ap.add_argument("--coarse-frac", type=float, default=0.1,
                    help="coarse stage runs at this fraction of --scale")
    ap.add_argument("--eps", type=float, default=0.15,
                    help="survivor slack band around the coarse front")
    ap.add_argument("--cap", type=int, default=12,
                    help="max survivors per scenario")
    ap.add_argument("--spot-check", type=int, default=3, metavar="K",
                    help="oracle-verify K winners per oracle-feasible "
                         "scenario, demoting refuted points (0 disables)")
    ap.add_argument("--learned", action="store_true",
                    help="also train the gradient-learned policy per "
                         "scenario and compare it against the swept front")
    ap.add_argument("--learn-steps", type=int, default=60,
                    help="gradient steps for --learned (default 60)")
    ap.add_argument("--learn-scale", type=float, default=None,
                    help="training trace scale for --learned "
                         "(default: the coarse scale)")
    ap.add_argument("--out-dir", default="frontier_out",
                    help="where CSV/JSON land (default frontier_out/)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--quiet", action="store_true")
    add_run_flags(ap, scale_default=1.0,
                  scale_help="refine-stage trace scale (default 1.0)",
                  telemetry="flag")
    add_search_flags(ap)
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            sc = get_scenario(name)
            print(f"{name:20s} {sc.figure:45s} {sc.description}")
        from repro_torch.core.policy_api import get_family, list_families
        from repro_torch.core.simtorch import _PFLEET
        from repro_torch.fleet.spot import get_tier, list_tiers
        print("\nsweepable policy axes (per registered family):")
        for fam_name in list_families():
            fam = get_family(fam_name)
            axes = ", ".join(fam.sweepable_axes()) or "-"
            print(f"  {fam_name:12s} {axes}")
        print(f"fleet axes: {', '.join(_PFLEET)}")
        print("capacity tiers: " + ", ".join(
            f"{n} ({get_tier(n).price_multiplier:.2f}x, "
            f"{get_tier(n).hazard_per_hour:g}/h)" for n in list_tiers()))
        print("billing profiles (--billing):")
        for n in list_profiles():
            print(f"  {n:12s} {get_profile(n).description}")
        return 0

    say = (lambda s: None) if args.quiet else \
        (lambda s: print(s, file=sys.stderr))
    rc = validate_run_flags(args) or validate_search_flags(args)
    if rc:
        return rc
    if args.scenario:
        rc = unknown_scenarios(args.scenario)
        if rc:
            return rc
        names = list(args.scenario)
    else:
        # rate-based scenarios (fig9_planet) join a search only when named
        # explicitly — same default frontier_search applies
        names = [n for n in list_scenarios()
                 if not get_scenario(n).rate_trace]

    targets = names
    spot_check = args.spot_check
    if args.tier is not None:
        # search the TIERED scenario objects: hazard/notice/discount from
        # the named capacity tier.  Oracle spot-checks would replay the
        # UNTIERED registry entries (the check resolves scenarios by
        # name), so they are skipped under --tier.
        from repro_torch.fleet.spot import get_tier
        from repro_torch.scenarios.runner import apply_tier
        tier = get_tier(args.tier)
        targets = []
        for n in names:
            tiered = apply_tier(get_scenario(n), tier)
            if tiered is None:
                print(f"note: {n} has no spot-capable policy/fleet; "
                      f"--tier {tier.name} ignored for it", file=sys.stderr)
                targets.append(n)
            else:
                targets.append(tiered)
        if spot_check > 0:
            say(f"note: oracle spot-checks are skipped under --tier "
                f"{tier.name} (they replay untiered registry entries)")
            spot_check = 0

    telem = None
    if args.telemetry:
        from repro_torch.obs import RunTelemetry
        telem = RunTelemetry()
    result = frontier_search(targets, scale=args.scale,
                             coarse_frac=args.coarse_frac, eps=args.eps,
                             survivor_cap=args.cap, billing=args.billing,
                             log=say, telemetry=telem, devices=args.devices,
                             cluster=args.cluster, algo=args.algo,
                             budget=args.budget, seed=args.seed,
                             device=args.device)
    checks = []
    if spot_check > 0:
        import numpy as np
        checks = oracle_spot_check(result, k=spot_check, log=say,
                                   telemetry=telem,
                                   rng=np.random.default_rng(args.seed),
                                   device=args.device)

    learned_records = []
    if args.learned:
        from repro_torch.opt.learned import (confirm, evaluate_trained,
                                             train_policy)
        learn_scale = args.learn_scale if args.learn_scale is not None \
            else result.coarse_scale
        for name in sorted(result.fronts):
            sc = get_scenario(name)
            res = train_policy(name, scale=learn_scale,
                               steps=args.learn_steps, log=say,
                               telemetry=telem, device=args.device)
            row = evaluate_trained(name, res, scale=args.scale,
                                   billing=args.billing, device=args.device)
            front = result.fronts[name]
            slack = frontier_slack(row, front)
            rec = {"scenario": name, "train": res.summary(),
                   "cost_per_million": row["cost_per_million"],
                   "slowdown_geomean_p99": row["slowdown_geomean_p99"],
                   "frontier_slack": slack,
                   "on_front": slack <= 1.0 + 1e-9}
            if sc.oracle_ok:
                rec["oracle"] = confirm(name, res, device=args.device)
            learned_records.append(rec)
            say(f"learned {name}: cost {row['cost_per_million']:.3g} "
                f"p99 {row['slowdown_geomean_p99']:.3g} "
                f"slack {slack:.3f}"
                + (f" oracle {'ok' if rec.get('oracle', {}).get('pass') else 'REFUTED'}"
                   if "oracle" in rec else ""))

    os.makedirs(args.out_dir, exist_ok=True)
    robust = set(result.robust_ids)
    for name, rows in sorted(result.refined.items()):
        front_ids = {r["point_id"] for r in result.fronts[name]}
        for r in rows:
            r["front"] = r["point_id"] in front_ids
            r["robust"] = r["point_id"] in robust
        _write_csv(os.path.join(args.out_dir, f"frontier_{name}.csv"), rows)
    _write_csv(os.path.join(args.out_dir, "frontier_robust.csv"),
               result.robust_rows())

    payload = {"summary": result.summary(),
               "spot_checks": checks,
               "learned": learned_records,
               "argv": {"scale": args.scale, "coarse_frac": args.coarse_frac,
                        "eps": args.eps, "cap": args.cap,
                        "spot_check": args.spot_check,
                        "learned": args.learned,
                        "billing": args.billing, "tier": args.tier,
                        "devices": args.devices, "cluster": args.cluster,
                        "algo": args.algo, "budget": args.budget,
                        "seed": args.seed}}
    with open(os.path.join(args.out_dir, "frontier.json"), "w") as fh:
        json.dump(payload, fh, indent=2, default=float)
    if telem is not None:
        tpath = os.path.join(args.out_dir, "telemetry.json")
        telem.write_json(tpath)
        say(f"run telemetry ({len(telem.events)} events) -> {tpath}")

    failures = []
    for name in sorted(result.fronts):
        if not result.fronts[name]:
            failures.append(f"{name}: empty oracle-confirmed front")
    if args.spot_check > 0:
        by = {}
        for c in checks:
            by.setdefault(c["scenario"], []).append(c)
        for name, recs in sorted(by.items()):
            n_ok = sum(r["pass"] for r in recs)
            say(f"spot-check {name}: {n_ok}/{len(recs)} winners confirmed")
            if n_ok == 0:
                failures.append(f"{name}: no sampled winner passed the "
                                f"oracle parity band")
    say(f"robust frontier: {len(result.robust_ids)} point(s) "
        f"{[result.points[i] for i in result.robust_ids]}")
    say(f"total wall {result.wall_s:.1f}s; outputs in {args.out_dir}/")
    for f in failures:
        print(f"FRONTIER FAILURE: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
