"""Scenario runner CLI — the entry point behind the scenario benchmarks.

Replays registered workload scenarios through the discrete-event oracle
and/or the chunked fluid simulator and emits one CSV metric row per
(scenario, engine) pair, the format ``benchmarks/`` consumes.  The port of
``repro.launch.scenarios``: the same flags and output, plus ``--device``
(where the fluid leg runs: the CUDA card unless ``--device cpu``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.scenarios --list
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenario diurnal
  PYTHONPATH=src python -m repro_torch.launch.scenarios --all --scale 0.25
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenario flash_crowd \\
      --engines simjax --scale 1.0 --csv out.csv
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenario cold_tail \
      --scale 0.1 --parity --device cpu

``--scale`` shrinks the workload isotropically (functions, duration, load)
— transforms are fraction-based, so the scenario's shape is preserved; the
CI smoke job runs the smallest scenario at a small scale through BOTH
engines.  At full scale the oracle leg of scenarios flagged
``oracle_ok=False`` (the 2000-function Fig. 9 replay) is skipped unless
``--force-oracle`` is given; the chunked simulator handles them easily.

The shared run-configuration flags (``--scale`` / ``--billing`` /
``--tier`` / ``--devices`` / ``--cluster``) are declared in
``repro_torch.launch.flags`` and map onto ``repro_torch.core.runspec.RunSpec``:
``--devices 8`` shards the fluid scan's function axis across eight local
CUDA devices (``--device cpu --devices 8``: eight shards on the host),
``--cluster 0.05`` buckets the sub-0.05-rps long tail into weighted
super-functions (fluid-only: the oracle leg drops).
"""

from __future__ import annotations

import argparse
import csv
import sys

from repro_torch.core.runspec import RunSpec
from repro_torch.fleet.billing import get_profile, list_profiles
from repro_torch.fleet.spot import get_tier, list_tiers
from repro_torch.launch.flags import (add_run_flags, unknown_scenarios,
                                      validate_run_flags)
from repro_torch.scenarios import (ENGINES, get_scenario, list_scenarios,
                                   parity_report, run_scenario)
from repro_torch.scenarios.runner import apply_tier

# stable CSV column order: identity, run info, the paper metric core, then
# the billed-dollar columns (empty unless --billing is given)
_COLUMNS = ["scenario", "engine", "scale", "num_functions", "invocations",
            "wall_s", "slowdown_geomean_p99", "normalized_memory",
            "creation_rate", "cpu_overhead", "worker_share", "nodes_mean",
            "completed", "dropped", "figure", "billing", "total_cost",
            "cost_per_million", "billed_gb_s"]


def _emit(rows: list[dict], out) -> None:
    writer = csv.DictWriter(out, fieldnames=_COLUMNS, extrasaction="ignore")
    writer.writeheader()
    for r in rows:
        writer.writerow({k: (f"{v:.6g}" if isinstance(v, float) else v)
                         for k, v in r.items() if k in _COLUMNS})


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.scenarios",
        description="Replay workload scenarios through both simulators.")
    ap.add_argument("--scenario", action="append", default=None,
                    help="scenario name (repeatable); see --list")
    ap.add_argument("--all", action="store_true", help="run every scenario")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--engines", default="both",
                    choices=["both", "eventsim", "simjax"])
    ap.add_argument("--csv", default=None, help="write CSV here (default stdout)")
    ap.add_argument("--parity", action="store_true",
                    help="print oracle-vs-simjax relative gaps to stderr")
    ap.add_argument("--force-oracle", action="store_true",
                    help="run the discrete-event oracle even for scenarios "
                         "flagged infeasible at this scale")
    ap.add_argument("--cells", type=int, default=None, metavar="N",
                    help="override a cells scenario's cell count (ignored "
                         "with a note for scenarios without a topology)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the oracle leg's request/instance/node "
                         "lifecycle spans and write a Chrome-trace JSON "
                         "here (requires exactly one scenario and an "
                         "eventsim leg)")
    add_run_flags(ap, scale_default=1.0, telemetry="dir")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.list:
        for name in list_scenarios():
            sc = get_scenario(name)
            print(f"{name:20s} {sc.figure:45s} {sc.description}")
        print("\ncapacity tiers (--tier):")
        for name in list_tiers():
            t = get_tier(name)
            print(f"  {name:12s} {t.price_multiplier:.2f}x on-demand, "
                  f"{t.hazard_per_hour:g} reclaims/node-hour, "
                  f"{t.reclaim_notice_s:g}s notice")
        print("\nbilling profiles (--billing):")
        for name in list_profiles():
            print(f"  {name:12s} {get_profile(name).description}")
        return 0

    rc = validate_run_flags(args)
    if rc:
        return rc
    tier = get_tier(args.tier) if args.tier is not None else None

    names = list_scenarios() if args.all else (args.scenario or [])
    if not names:
        ap.error("pick --scenario NAME (repeatable), --all, or --list")
    rc = unknown_scenarios(names)
    if rc:
        return rc
    engines = ENGINES if args.engines == "both" else (args.engines,)
    if args.cluster > 0 and "eventsim" in engines:
        print("note: --cluster produces a rate-based workload; the "
              "eventsim leg is skipped", file=sys.stderr)

    # observability flags are validated up front, friendly-error style:
    # a span trace needs exactly one oracle leg, telemetry a simjax leg
    if args.trace_out is not None:
        if "eventsim" not in engines:
            print("--trace-out records the oracle leg; pick --engines "
                  "both or eventsim", file=sys.stderr)
            return 2
        if len(names) != 1:
            print(f"--trace-out records one scenario's spans, got "
                  f"{len(names)}; pick a single --scenario", file=sys.stderr)
            return 2
    if args.telemetry is not None and "simjax" not in engines:
        print("--telemetry samples the simjax leg; pick --engines both "
              "or simjax", file=sys.stderr)
        return 2

    obs = None
    if args.trace_out is not None:
        from repro_torch.obs import SpanRecorder
        obs = SpanRecorder(enabled=True)
    telem_slots = (max(1, args.telemetry_slots)
                   if args.telemetry is not None else 0)
    if args.telemetry is not None:
        import os
        os.makedirs(args.telemetry, exist_ok=True)

    rows = []
    for name in names:
        target = name
        if tier is not None:
            tiered = apply_tier(get_scenario(name), tier)
            if tiered is None:
                print(f"note: {name} has no spot-capable policy/fleet; "
                      f"--tier {tier.name} ignored for it", file=sys.stderr)
            else:
                target = tiered
        if args.cells is not None:
            sc_obj = get_scenario(target) if isinstance(target, str) \
                else target
            if sc_obj.cells is None:
                print(f"note: {name} has no cell topology; --cells ignored "
                      f"for it", file=sys.stderr)
            else:
                import dataclasses
                # the topology re-validates, so a fail_cell or trigger
                # aimed at a now-missing cell errors loudly here
                target = dataclasses.replace(
                    sc_obj, cells=dataclasses.replace(
                        sc_obj.cells, cell_count=args.cells))
        detail: dict = {}
        sc_rows = run_scenario(target, detail=detail,
                               spec=RunSpec(engines=engines,
                                            scale=args.scale,
                                            force_oracle=args.force_oracle,
                                            obs=obs, telemetry=telem_slots,
                                            billing=args.billing,
                                            devices=args.devices,
                                            cluster=args.cluster),
                               device=args.device)
        if args.telemetry is not None and "fluid_summary" in detail \
                and detail["fluid_summary"].get("telemetry"):
            from repro_torch.obs import write_timeline_csv
            import os
            path = os.path.join(args.telemetry, f"timeline_{name}.csv")
            write_timeline_csv(detail["fluid_summary"]["telemetry"], path)
            print(f"telemetry timeline -> {path}", file=sys.stderr)
        rows.extend(sc_rows)
        if args.parity:
            gaps = parity_report(sc_rows)
            if gaps:
                print(f"parity {name}: " +
                      " ".join(f"{k}={v:.3f}" for k, v in gaps.items()),
                      file=sys.stderr)

    if obs is not None:
        if not obs.spans:
            print("note: no spans recorded — the oracle leg was skipped at "
                  "this scale (see --force-oracle)", file=sys.stderr)
        obs.write_json(args.trace_out)
        print(f"span trace ({len(obs.spans)} spans) -> {args.trace_out}",
              file=sys.stderr)

    if args.csv:
        with open(args.csv, "w", newline="") as fh:
            _emit(rows, fh)
    else:
        _emit(rows, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
