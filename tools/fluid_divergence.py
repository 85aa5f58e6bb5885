#!/usr/bin/env python3
"""Where two devices' fluid runs part: one reference run of the fluid engine,
stepped tick by tick on two devices side by side.

    python3 tools/fluid_divergence.py                       # card against CPU, ~2 min
    python3 tools/fluid_divergence.py --devices cpu         # the CPU's row alone
    python3 tools/fluid_divergence.py --run fig9.sync_ka600 --out chiprun_out/div.json

The run (``--run``, default fig9 async w60 t0.7) and its trace come from
``tests/data/torch_fluid_jax_rows.json``, which also holds the JAX package's row.
For each device: the ``simulate_chunked`` row, each metric's relative error
against the JAX row, and the wall.  With two devices the run's step is then
driven on both from the same state, tick by tick, and the script reports:

- the first tick where any state leaf differs in a bit, with the leaf and its
  largest difference;
- the first tick where a function's instance count (running or starting)
  differs, with each such
  function's window mean on both devices, the float32 argument of the async
  family's ``ceil`` there, the float64 mean of the same window, and whether
  the window's contents were equal bit for bit;
- how many ticks' creations differ, and the creations summed over the
  measured ticks (those behind the row's ``creation_rate``) on each device.

Prints one JSON line, and writes it to ``--out`` when given.  Imports torch and
repro_torch only.
"""

from __future__ import annotations

import argparse
import json
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

LEAVES = ("inst", "in_service", "queue", "starting", "win", "wcur", "nodes", "pipe",
          "cool", "nodes_spot", "pipe_spot", "spot_inst", "evict_deficit")
STEP_KW = ("lam0", "gaps", "gap_tab", "dur", "mem", "billed_w", "pol", "fleet",
           "cpu_consts", "static_nodes", "family", "dt", "cold_ticks", "wbuf",
           "prov_ticks", "has_fleet", "weights")
CREATIONS = 6                 # index of the creations series in the step's ys


def row_errors(row: dict, want: dict) -> dict:
    return {k: abs(row[k] - v) / max(abs(v), 1e-12) for k, v in want.items()
            if k != "telemetry"}


def chunked_row(fl, trace, run: dict, device: str) -> dict:
    fleet = fl.st.JaxFleet(**run["fleet"]) if run.get("fleet") is not None else None
    t0 = time.monotonic()
    row = fl.st.simulate_chunked(trace, fl.st.JaxPolicy(**run["policy"]), dt=run["dt"],
                                 num_nodes=run["num_nodes"], fleet=fleet,
                                 chunk_ticks=run["chunk_ticks"], device=device)
    wall = time.monotonic() - t0
    errs = row_errors(row, run["row"])
    worst = max(errs, key=errs.get)
    return dict(device=device, wall_s=round(wall, 3),
                creation_rate=row["creation_rate"], jax_creation_rate=run["row"]["creation_rate"],
                rel_err_vs_jax={k: float(f"{e:.4g}") for k, e in errs.items()},
                worst=[worst, float(f"{errs[worst]:.4g}")])


def window_detail(fl, run, before, after, fns) -> list:
    """For the functions ``fns``: each device's float32 window mean after the tick,
    the ceil's argument, the float64 mean, and whether the windows agree."""
    st = fl.st
    pol = st.JaxPolicy(**run["policy"])
    scale = float(np.float32(pol.params()["target"]) * np.float32(pol.params()["cc"]))
    wcur = before[0][5]
    out = []
    for j in fns:
        item = dict(function=int(j))
        wins = []
        for d, state in enumerate(after):
            win = state[4]
            wbuf = win.shape[-1]
            nvalid = torch.arange(1, wbuf + 1, dtype=torch.float32, device=win.device)
            avg = (win.sum(-1) / nvalid[min(wcur, wbuf - 1)])[0, j]
            arg = torch.ceil(avg / torch.tensor(scale, device=win.device) - 1e-9)
            wins.append(win[0, j].cpu().numpy())
            item[f"avg_{d}"] = float(avg)
            item[f"ceil_arg_{d}"] = float(avg / torch.tensor(scale, device=win.device) - 1e-9)
            item[f"desired_{d}"] = float(arg)
            item[f"inst_{d}"] = float(state[0][0, j])
            item[f"starting_{d}"] = state[3][0, j].tolist()
        n = min(wcur + 1, wins[0].shape[0])
        item["avg_f64"] = float(wins[1].astype(np.float64).sum() / n)
        item["ceil_arg_f64"] = item["avg_f64"] / scale
        item["windows_equal"] = bool(np.array_equal(wins[0], wins[1]))
        out.append(item)
    return out


def lockstep(fl, trace, run: dict, devices: list, max_ticks: int) -> dict:
    st = fl.st
    pol = st.JaxPolicy(**run["policy"])
    if run.get("fleet") is not None:
        raise SystemExit("lockstep drives the runs without a fleet")
    setups = [st._chunked_setup(trace, pol, st.stack_params([pol.params()]),
                                np.zeros((1, len(st._PFLEET)), np.float32),
                                sim=fl.SimConfig(), dt=run["dt"], num_nodes=run["num_nodes"],
                                provision_s=0.0, has_fleet=False,
                                chunk_ticks=run["chunk_ticks"], warmup_frac=0.5, nbins=256,
                                device=d) for d in devices]
    steps = [st._make_step(s.arr, **{k: s.chunk_kw[k] for k in STEP_KW}) for s in setups]
    states = [s.state for s in setups]
    warm = setups[0].chunk_kw["warm_tick"]
    n_ticks = min(setups[0].n_ticks, max_ticks)
    first_state = first_inst = None
    differing_creations, created = 0, [0.0, 0.0]
    t0 = time.monotonic()
    with torch.no_grad():
        for t in range(n_ticks):
            before = states
            outs = [step(state, t) for step, state in zip(steps, states)]
            states = [o[0] for o in outs]
            cre = [float(o[1][CREATIONS][0, 0]) for o in outs]
            if cre[0] != cre[1]:
                differing_creations += 1
            if t >= warm:
                created[0] += cre[0]
                created[1] += cre[1]
            if first_inst is not None:
                continue
            leaves = [[x.cpu() if isinstance(x, torch.Tensor) else x for x in s] for s in states]
            if first_state is None:
                for name, a, b in zip(LEAVES, *leaves):
                    if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                        first_state = dict(tick=t, leaf=name,
                                           max_abs_diff=float((a - b).abs().max()),
                                           elements=int((a != b).sum()))
                        break
            # a function's instances, or those it has still starting, differ
            have = [lv[0][0] + lv[3][0].sum(-1) for lv in leaves]
            diff = torch.nonzero((leaves[0][0][0] != leaves[1][0][0])
                                 | (have[0] != have[1])).flatten().tolist()
            if diff:
                first_inst = dict(tick=t, functions=len(diff),
                                  detail=window_detail(fl, run, before, states, diff[:4]))
    return dict(devices=devices, ticks=n_ticks, warm_tick=warm,
                lockstep_wall_s=round(time.monotonic() - t0, 3),
                first_state_difference=first_state, first_instance_difference=first_inst,
                ticks_with_differing_creations=differing_creations,
                measured_creations=created,
                measured_creations_rel_diff=abs(created[0] - created[1])
                / max(abs(created[1]), 1e-12))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", default="fig9.async_w60_t0.7")
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--ticks", type=int, default=1 << 30,
                    help="stop the side-by-side stepping after this many ticks")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if len(args.devices) > 2:
        raise SystemExit("--devices takes one or two devices")
    if "cuda" in args.devices and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --devices cpu")
    fl = chip_smoke.fluid_modules()
    run = fl.runs[args.run]
    trace = chip_smoke.fluid_trace(fl, run["trace"])
    result = dict(run=args.run, torch=torch.__version__,
                  rows=[chunked_row(fl, trace, run, d) for d in args.devices])
    if "cuda" in args.devices:
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    if len(args.devices) == 2:
        result.update(lockstep(fl, trace, run, args.devices, args.ticks))
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
