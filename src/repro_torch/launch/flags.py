"""Shared CLI flags for the launch entry points.

The launchers (``repro_torch.launch.scenarios``,
``repro_torch.launch.trace``, ``repro_torch.launch.frontier``) accept one
common run-configuration vocabulary —
``--scale`` / ``--billing`` / ``--tier`` / ``--devices`` / ``--cluster``
plus a per-CLI telemetry form, and ``--device`` (where the fluid leg runs) —
declared HERE once instead of copy-pasted ``add_argument`` blocks.  ``validate_run_flags`` performs the
friendly-error checks (unknown billing profile / capacity tier, more
devices than the host exposes, a negative clustering threshold) with the
launchers' exit-2 contract: print the registered choices to stderr, return
2, never traceback.

These flags map one-to-one onto ``repro_torch.core.runspec.RunSpec`` fields;
each launcher builds its spec from the parsed namespace and threads it
through ``run_scenario``.

The frontier launcher adds the search-engine flags (``add_search_flags``:
``--algo`` / ``--budget`` / ``--seed``), validated by
``validate_search_flags`` under the same exit-2 contract.

The port of ``repro.launch.flags``.  Devices are counted with
``torch.cuda.device_count()``; with ``--device cpu`` any ``--devices N``
runs N shards on the host (the JAX package's forced host-device count).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def add_run_flags(ap: argparse.ArgumentParser, *,
                  scale_default: float = 1.0,
                  scale_help: Optional[str] = None,
                  telemetry: Optional[str] = None) -> argparse.ArgumentParser:
    """Declare the shared run-configuration flags on *ap*.

    ``telemetry`` picks the launcher's telemetry form: ``"dir"`` (the
    scenario runner's ``--telemetry DIR`` + ``--telemetry-slots``),
    ``"flag"`` (the frontier's boolean ``--telemetry``), ``"slots"`` (the
    trace CLI's ``--slots``), or None.
    """
    ap.add_argument("--scale", type=float, default=scale_default,
                    help=scale_help or "isotropic workload shrink factor "
                                       f"(default {scale_default:g})")
    ap.add_argument("--billing", default=None, metavar="PROFILE",
                    help="bill through this billing profile (rounding, "
                         "minimum duration, per-request and per-GB-s fees, "
                         "cpu throttle); see --list for registered profiles")
    ap.add_argument("--tier", default=None,
                    help="run spot-capable scenarios under this capacity "
                         "tier (hazard, reclaim notice, discount); "
                         "see --list for registered tiers")
    ap.add_argument("--devices", type=int, default=0, metavar="N",
                    help="shard the fluid scan over N local CUDA devices, "
                         "or N shards on the host with --device cpu "
                         "(0 = unsharded)")
    ap.add_argument("--cluster", type=float, default=0.0, metavar="RPS",
                    help="bucket functions below this mean-rps threshold "
                         "into weighted super-functions before simulating "
                         "(0 = off; fluid-only — the oracle leg drops)")
    if telemetry == "dir":
        ap.add_argument("--telemetry", default=None, metavar="DIR",
                        help="attach in-scan telemetry to the simjax leg "
                             "and write timeline_<scenario>.csv per "
                             "scenario here (requires a simjax leg)")
        ap.add_argument("--telemetry-slots", type=int, default=200,
                        help="downsampled timeline resolution (default 200)")
    elif telemetry == "flag":
        ap.add_argument("--telemetry", action="store_true",
                        help="record search-run telemetry (per-stage sims/"
                             "wall/hypervolume, spot-check demotion counts, "
                             "training-loss series) to telemetry.json in "
                             "--out-dir")
    elif telemetry == "slots":
        ap.add_argument("--slots", type=int, default=200,
                        help="fluid timeline resolution (default 200)")
    ap.add_argument("--device", default=None,
                    help="where the fluid leg runs (default: the CUDA card; "
                         "'cpu' runs it on the host)")
    return ap


def validate_run_flags(args: argparse.Namespace) -> int:
    """Friendly-error validation of the shared flags: returns 0 when every
    value resolves, 2 (the launchers' usage-error exit) after printing the
    registered choices to stderr otherwise."""
    if args.billing is not None:
        from repro_torch.fleet.billing import get_profile, list_profiles
        try:
            get_profile(args.billing)
        except KeyError:
            # a friendly listing, not a KeyError traceback
            print(f"unknown billing profile {args.billing!r}",
                  file=sys.stderr)
            print(f"registered profiles: {', '.join(list_profiles())} "
                  f"(see --list)", file=sys.stderr)
            return 2
    if args.tier is not None:
        from repro_torch.fleet.spot import get_tier, list_tiers
        try:
            get_tier(args.tier)
        except KeyError:
            # a friendly listing, not a KeyError traceback
            print(f"unknown capacity tier {args.tier!r}", file=sys.stderr)
            print(f"registered tiers: {', '.join(list_tiers())} "
                  f"(see --list)", file=sys.stderr)
            return 2
    if args.devices < 0:
        print(f"--devices must be >= 0, got {args.devices}", file=sys.stderr)
        return 2
    if args.devices > 0:
        import torch
        on_host = args.device is not None and torch.device(args.device).type == "cpu"
        n = torch.cuda.device_count()
        if args.devices > n and not on_host:
            print(f"--devices {args.devices}: only {n} CUDA device(s) "
                  f"visible", file=sys.stderr)
            return 2
    if args.cluster < 0.0:
        print(f"--cluster must be >= 0 (a mean-rps threshold), got "
              f"{args.cluster}", file=sys.stderr)
        return 2
    return 0


def add_search_flags(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Search-engine selection flags (frontier-style launchers): which
    engine walks the space (``--algo``), how much simulation it may spend
    (``--budget``), and the seed behind every stochastic choice
    (``--seed``) — same shared-vocabulary contract as ``add_run_flags``."""
    ap.add_argument("--algo", default="grid", metavar="ALGO",
                    help="search engine: 'grid' enumerates the space's "
                         "cartesian product; 'evo' runs the NSGA-II "
                         "population optimizer at the same evaluation "
                         "budget (repro_torch.opt.evo)")
    ap.add_argument("--budget", type=int, default=None, metavar="N",
                    help="evo evaluation budget in simulated candidate-"
                         "scenario pairs (default: exactly what the grid "
                         "would cost, for a like-for-like comparison; "
                         "ignored under --algo grid)")
    ap.add_argument("--seed", type=int, default=0, metavar="S",
                    help="seed for every stochastic search choice (evo "
                         "variation, spot-check winner sampling); a seeded "
                         "run replays bit-for-bit (default 0)")
    return ap


def validate_search_flags(args: argparse.Namespace) -> int:
    """Friendly-error validation of the search flags: exit-2 contract,
    printing the registered engines instead of a traceback."""
    from repro_torch.opt.search import SEARCH_ALGOS
    if args.algo not in SEARCH_ALGOS:
        # a friendly listing, not a ValueError traceback
        print(f"unknown search algo {args.algo!r}", file=sys.stderr)
        print(f"registered algos: {', '.join(SEARCH_ALGOS)}",
              file=sys.stderr)
        return 2
    if args.budget is not None and args.budget <= 0:
        print(f"--budget must be a positive candidate-scenario pair count, "
              f"got {args.budget}", file=sys.stderr)
        return 2
    return 0


def unknown_scenarios(names) -> int:
    """Exit-2 helper shared by the launchers: print the friendly listing
    for any unregistered scenario names; 0 when all resolve."""
    from repro_torch.scenarios import list_scenarios
    unknown = [n for n in names if n not in list_scenarios()]
    if not unknown:
        return 0
    # a friendly listing, not a KeyError traceback
    print(f"unknown scenario(s): {', '.join(unknown)}", file=sys.stderr)
    print("registered scenarios (see --list for details):", file=sys.stderr)
    for n in list_scenarios():
        print(f"  {n}", file=sys.stderr)
    return 2
