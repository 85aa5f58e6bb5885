"""Trace one scenario through both engines with full observability.

The one-command window into WHERE autoscaling overhead goes: replays a
registered scenario through the discrete-event oracle with request/
instance/node lifecycle spans recorded, and through the chunked fluid
simulator with in-scan telemetry attached, then prints the two engines'
overhead-attribution ledgers side by side (creation / eviction-storm /
keepalive-idle / master-control CPU; busy / warm-idle / pipeline memory)
with their component-level parity gaps.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.trace diurnal
  PYTHONPATH=src python -m repro_torch.launch.trace spot_storm --scale 0.1
  PYTHONPATH=src python -m repro_torch.launch.trace diurnal --out-dir trace_out \\
      --slots 400 --check
  PYTHONPATH=src python -m repro_torch.launch.trace diurnal --scale 0.1 --check \\
      --device cpu

Outputs in ``--out-dir`` (default ``trace_out/``):
  trace.json             oracle span tree, Chrome-trace format — load it in
                         Perfetto (ui.perfetto.dev) or chrome://tracing
  timeline_oracle.csv    the oracle's per-tick memory/node samples
  timeline_simjax.csv    the fluid engine's downsampled telemetry series
  ledger.json            both ledgers + component parity gaps + span stats

``--check`` exits non-zero when span validation, either engine's
attribution-sum consistency, or (with both engines) the component parity
band fails — the CI smoke gate.

The port of ``repro.launch.trace``: the same flags and artifacts, plus
``--device`` (where the fluid leg runs: the CUDA card unless
``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.core.runspec import RunSpec
from repro_torch.launch.flags import (add_run_flags, unknown_scenarios,
                                      validate_run_flags)
from repro_torch.obs import (SpanRecorder, attribution_table, check_ledger,
                             ledger_from_chunked, ledger_from_eventsim,
                             ledger_parity, validate, write_oracle_timeline_csv,
                             write_timeline_csv)
from repro_torch.scenarios import get_scenario, run_scenario

# the component-parity band --check judges: same 15% the aggregate
# parity tests pin (see repro_torch.obs.ledger.ledger_parity for normalization)
PARITY_TOL = 0.15


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.trace",
        description="Replay one scenario through both engines with spans, "
                    "telemetry, and the overhead-attribution ledger.")
    ap.add_argument("scenario", help="registered scenario name")
    ap.add_argument("--out-dir", default="trace_out",
                    help="artifact directory (default trace_out/)")
    ap.add_argument("--engines", default="both",
                    choices=["both", "eventsim", "simjax"])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on span-validation, attribution-sum, or "
                         "component-parity failure (the CI gate)")
    add_run_flags(ap, scale_default=0.25,
                  scale_help="trace scale (default 0.25, the oracle-"
                             "feasible parity calibration point)",
                  telemetry="slots")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    rc = unknown_scenarios([args.scenario]) or validate_run_flags(args)
    if rc:
        return rc

    engines = (("eventsim", "simjax") if args.engines == "both"
               else (args.engines,))
    target = args.scenario
    if args.tier is not None:
        from repro_torch.fleet.spot import get_tier
        from repro_torch.scenarios.runner import apply_tier
        tier = get_tier(args.tier)
        tiered = apply_tier(get_scenario(args.scenario), tier)
        if tiered is None:
            print(f"note: {args.scenario} has no spot-capable policy/"
                  f"fleet; --tier {tier.name} ignored", file=sys.stderr)
        else:
            target = tiered
    rate_based = (get_scenario(args.scenario).rate_trace
                  or args.cluster > 0)
    if rate_based and "eventsim" in engines:
        print("note: rate-based workload (rate_trace scenario or "
              "--cluster); the oracle leg is skipped — fluid-only ledger",
              file=sys.stderr)
    obs = SpanRecorder(enabled=True) if "eventsim" in engines else None
    detail: dict = {}
    rows = run_scenario(target, detail=detail,
                        spec=RunSpec(engines=engines, scale=args.scale,
                                     force_oracle="eventsim" in engines,
                                     obs=obs, telemetry=max(1, args.slots),
                                     billing=args.billing,
                                     devices=args.devices,
                                     cluster=args.cluster),
                        device=args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    failures: list[str] = []
    ledgers = []
    span_stats: dict = {}

    if obs is not None:
        path = os.path.join(args.out_dir, "trace.json")
        obs.write_json(path)
        problems = validate(obs)
        span_stats = {"spans": len(obs.spans),
                      "validation_problems": problems}
        print(f"span trace: {len(obs.spans)} spans -> {path}"
              + (f"  [{len(problems)} VALIDATION PROBLEMS]"
                 if problems else ""))
        for p in problems[:10]:
            print(f"  span problem: {p}", file=sys.stderr)
        failures += problems

    if "oracle_result" in detail:
        res = detail["oracle_result"]
        path = os.path.join(args.out_dir, "timeline_oracle.csv")
        write_oracle_timeline_csv(res, path)
        print(f"oracle timeline ({len(res.sample_times)} ticks) -> {path}")
        led = ledger_from_eventsim(res)
        failures += check_ledger(led)
        ledgers.append(led)

    if "fluid_summary" in detail:
        summary = detail["fluid_summary"]
        telem = summary.get("telemetry")
        if telem:
            path = os.path.join(args.out_dir, "timeline_simjax.csv")
            write_timeline_csv(telem, path)
            print(f"fluid timeline ({telem['slots']} slots) -> {path}")
            led = ledger_from_chunked(summary)
            failures += check_ledger(led)
            ledgers.append(led)

    gaps: dict = {}
    if ledgers:
        print()
        print(attribution_table(ledgers))
        if len(ledgers) == 2:
            gaps = ledger_parity(ledgers[0], ledgers[1])
            bad = {k: g for k, g in gaps.items() if g > PARITY_TOL}
            for k, g in bad.items():
                failures.append(f"component parity {k}: gap {g:.3f} "
                                f"> {PARITY_TOL}")

    # the telemetry series already landed in timeline_simjax.csv; the
    # ledger JSON keeps the scalar rows only
    rows = [{k: v for k, v in r.items() if k != "telemetry"} for r in rows]
    payload = {"scenario": args.scenario, "scale": args.scale,
               "rows": rows, "spans": span_stats,
               "ledgers": [led.row() for led in ledgers],
               "component_parity": gaps, "failures": failures}
    lpath = os.path.join(args.out_dir, "ledger.json")
    with open(lpath, "w") as fh:
        json.dump(payload, fh, indent=2, default=float)
    print(f"\nledger -> {lpath}")

    for f in failures:
        print(f"TRACE FAILURE: {f}", file=sys.stderr)
    return 1 if (args.check and failures) else 0


if __name__ == "__main__":
    raise SystemExit(main())
