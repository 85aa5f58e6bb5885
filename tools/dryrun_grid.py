#!/usr/bin/env python3
"""The dry run's whole grid, several cells at a time, and its tables.

    python3 tools/dryrun_grid.py --jobs 6      # every arch x cells(arch) x mesh
    python3 tools/dryrun_grid.py --jobs 6 --mesh 16x16 2x16x16 --shape decode_32k
    python3 tools/dryrun_grid.py --tables-only # render what artifacts/dryrun_torch holds

Runs ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh M`` for
each cell of the grid (the single-cell path that ``--arch all`` runs one
cell at a time in a subprocess), ``--jobs`` of them at once, the longest
first, each under the CLI's 3600 s timeout (``--arch`` / ``--shape`` /
``--mesh`` keep a part of the grid); then prints, for each mesh, one row an
arch: each cell's roofline bounds a device (compute / memory / collective,
ms, from ``repro_torch.launch.hopper``'s constants of one H100, counted on
the meta device; on a mesh of more than one device, one rank's) with the
seconds its count took, and the arguments plus the counted temp a device
(GiB).  Needs no card; imports repro_torch only.
Exits 1 if a cell failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.configs.base import SHAPES, cells  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

# the cells whose count takes longest go first (one dispatch a token of a scan)
SLOW_FIRST = ("hymba-1.5b", "rwkv6-3b", "internvl2-76b", "granite-34b")


def grid(archs=None, shapes=None, meshes=None) -> list[tuple[str, str, str]]:
    def order(c):
        arch, shape, _ = c
        return (SLOW_FIRST.index(arch) if arch in SLOW_FIRST else len(SLOW_FIRST),
                list(SHAPES).index(shape))
    return sorted(((a, s, m) for a in archs or list_archs() for s in cells(a)
                   for m in meshes or dryrun.MESHES if not shapes or s in shapes),
                  key=order)


def run_one(cell) -> tuple:
    arch, shape, mesh = cell
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    try:
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                            "--shape", shape, "--mesh", mesh], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=dryrun.CELL_TIMEOUT_S)
        rc = r.returncode
    except subprocess.TimeoutExpired:
        rc = "timeout"
    print(f"{'OK  ' if rc == 0 else 'FAIL'} {arch:22s} {shape:12s} {mesh:8s} rc={rc}", flush=True)
    return cell, rc


def tables() -> str:
    out = []
    for mesh in dryrun.MESHES:
        head = ["arch", *SHAPES]
        rows = [f"| {' | '.join(head)} |", "|" + "---|" * len(head)]
        mem = [f"| {' | '.join(head)} |", "|" + "---|" * len(head)]
        for arch in list_archs():
            row, mrow = [arch], [arch]
            for shape in SHAPES:
                path = Path(dryrun._artifact_path(arch, shape, mesh))
                d = json.loads(path.read_text()) if path.exists() else {"missing": True}
                if d.get("skipped") or shape not in cells(arch):
                    row.append("—")
                    mrow.append("—")
                elif d.get("error") or d.get("missing"):
                    row.append("ERROR" if d.get("error") else "not counted")
                    mrow.append(row[-1])
                else:
                    t, m = d["roofline_s"], d["memory"]
                    coll = t.get("collective") or 0.0
                    row.append(f"{t['compute'] * 1e3:.4g} / {t['memory'] * 1e3:.4g} / "
                               f"{coll * 1e3:.4g} · {d['lower_s']:.1f} s")
                    mrow.append(f"{m['argument_bytes'] / 2**30:.4g} + "
                                f"{m['temp_bytes'] / 2**30:.4g}")
            rows.append(f"| {' | '.join(row)} |")
            mem.append(f"| {' | '.join(mrow)} |")
        out.append(f"{mesh}: compute / memory / collective bound a device, ms · seconds "
                   f"of the count\n\n"
                   + "\n".join(rows) + f"\n\n{mesh}: arguments + counted temp a device, GiB\n\n"
                   + "\n".join(mem))
    return "\n\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--tables-only", action="store_true")
    ap.add_argument("--arch", nargs="*")
    ap.add_argument("--shape", nargs="*")
    ap.add_argument("--mesh", nargs="*", choices=list(dryrun.MESHES))
    args = ap.parse_args(argv)
    failed = 0
    if not args.tables_only:
        with ThreadPoolExecutor(args.jobs) as pool:
            failed = sum(rc != 0 for _, rc in
                         pool.map(run_one, grid(args.arch, args.shape, args.mesh)))
    print(tables())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
