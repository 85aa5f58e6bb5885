"""Dry run: count every (arch x shape x mesh) cell of the port on the meta
device and write its roofline terms against the H100's constants.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell on 512 forced host devices and costs the optimized HLO.  The port's
cells are its real step functions (``train_step``, ``registry.prefill``,
``registry.decode_step``) run eagerly on meta tensors at their global shapes
under ``launch.op_analysis.OpCounter``: nothing is allocated and no card is
needed, so there is no ``--device``.

What an artifact holds (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``,
JAX's keys):

* ``lower_s``: the seconds of the meta run; ``compile_s`` 0 (nothing compiles);
* ``memory.argument_bytes``: per device and exact, each argument leaf's local
  shard under its spec on the mesh;
* ``per_device.flops`` / ``bytes`` / ``collective_bytes`` and
  ``memory.temp_bytes`` / ``output_bytes``: one rank's counts
  (``"split": "rank"``); ``memory.peak_bytes`` is the device's arguments
  plus that temp; the same counts are under ``counted``;
* ``collectives``: the rank's collectives by kind, each a ``count`` and
  ``bytes`` (``hlo_analysis``' table);
* ``roofline_s``: compute (FLOPs over ``hopper.PEAK_FLOPS``), memory (bytes
  over ``hopper.HBM_BW``) and collective (collective bytes over
  ``hopper.LINK_BW``), and ``bottleneck`` the largest.

The meshes: ``1x1`` (one H100), ``16x16`` and ``2x16x16``.  On a mesh of
more than one device the cell runs as one rank (rank 0) of a fake process
group of ``mesh.size`` ranks, which moves no data: its arguments are
DTensors whose local shards are meta tensors of the rank's shapes, placed
by their specs on a ``DeviceMesh`` (``sharding.fake_group`` keeps the
all-to-alls a card's mesh issues), and ``op_analysis`` counts the rank's
local ops and its collectives.  A cell that cannot run so fails; none falls back to the whole
cell over the chip count.  A train cell's microbatches after the third are
equal iterations of ``train_step``'s loop (the same ops on the same shapes,
the same live set), so the cell is counted at 2 and at 3 microbatches of
the cell's size and extrapolated, exactly: the trip count ``hlo_analysis``
applies to JAX's microbatch scan.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all [--multi-pod both] [--mesh 1x1]
With --arch all each cell runs in a subprocess (JAX's 3600 s timeout), and
the CLI exits 1 if any cell failed.  ``--save-ops`` (JAX's ``--save-hlo``)
writes the cell's op breakdown (``op_analysis.breakdown`` by bytes and by
FLOPs) beside the artifact as ``.ops.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Optional

ARTIFACTS = str(Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch")
MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
CELL_TIMEOUT_S = 3600


def mesh_name(multi_pod: bool, mesh: Optional[str] = None) -> str:
    return mesh or ("2x16x16" if multi_pod else "16x16")


def make_mesh(name: str):
    from repro_torch.distributed.sharding import Mesh
    axes, sizes = MESHES[name]
    return Mesh(axes, sizes)


def count_cell(cfg, shape_name: str, mesh, *, fsdp: bool = True,
               n_microbatches: Optional[int] = None, sites: bool = False,
               exact: bool = False, dmesh=None):
    """Build the cell and count it -> (cell, args, analysis): ``analysis`` is
    ``op_analysis.analyze``'s dict for the whole cell, or for one rank with
    ``dmesh`` (a train cell of more than 3 microbatches extrapolated from 2
    and 3 of them unless ``exact``)."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import cells as cell_lib
    from repro_torch.launch.op_analysis import analyze, storage_bytes
    cell, args, _ = cell_lib._build_cell(cfg, shape_name, mesh, fsdp=fsdp,
                                         n_microbatches=n_microbatches, dmesh=dmesh)
    n = cell.n_microbatches
    if cell.kind != "train" or n <= 3 or exact:
        return cell, args, analyze(cell, *args, sites=sites)
    rows = SHAPES[shape_name].global_batch // n
    part = {}
    for k in (2, 3):
        c, a, _ = cell_lib._build_cell(cfg, shape_name, mesh, fsdp=fsdp, n_microbatches=k,
                                       batch_rows=k * rows, dmesh=dmesh)
        part[k] = analyze(c, *a, sites=sites)
        del a
    two, three = part[2], part[3]
    step = three["counts"].combine(two["counts"], -1.0)        # one steady microbatch
    counts = two["counts"].combine(step, n - 2)
    full_args = storage_bytes(args)
    out = dict(three, flops_per_device=counts.flops, bytes_per_device=counts.bytes,
               matmul_flops=counts.matmul_flops, ops=counts.ops, counts=counts,
               collective_bytes_per_device=counts.collective_bytes,
               collectives={k: dict(v) for k, v in counts.collectives.items()},
               argument_bytes=full_args,
               peak_bytes=three["peak_bytes"] - three["argument_bytes"] + full_args)
    out["microbatches_counted"] = [2, 3]
    return cell, args, out


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, save_ops: bool = False, *,
             mesh: Optional[str] = None) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import cells
    from repro_torch.launch import cells as cell_lib
    from repro_torch.launch import hopper
    from repro_torch.launch.op_analysis import breakdown

    name = mesh_name(multi_pod, mesh)
    cfg = get_config(arch)
    if shape_name not in cells(arch):
        return {"arch": arch, "shape": shape_name, "mesh": name, "skipped": True,
                "reason": "long_500k skipped for full-attention arch"}
    m = make_mesh(name)
    n_chips = m.size
    t0 = time.time()
    cell, args, r = count_rank(cfg, shape_name, m, sites=save_ops)
    lower_s = time.time() - t0
    arg_dev = cell_lib.argument_bytes(cell, args, m)
    flops_dev = r["flops_per_device"]
    bytes_dev = r["bytes_per_device"]
    temp_dev = r["temp_bytes"]
    coll_dev = r["collective_bytes_per_device"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": name, "n_chips": n_chips,
        "lower_s": round(lower_s, 1), "compile_s": 0.0,
        "memory": {"argument_bytes": arg_dev, "output_bytes": r["output_bytes"],
                   "temp_bytes": temp_dev, "peak_bytes": arg_dev + temp_dev},
        "xla_cost_analysis": None,
        "per_device": {"flops": flops_dev, "bytes": bytes_dev, "collective_bytes": coll_dev,
                       "split": "rank"},
        "collectives": r["collectives"],
        "roofline_s": {"compute": flops_dev / hopper.PEAK_FLOPS,
                       "memory": bytes_dev / hopper.HBM_BW,
                       "collective": coll_dev / hopper.LINK_BW},
        "counted": {"flops": r["flops_per_device"], "matmul_flops": r["matmul_flops"],
                    "bytes": r["bytes_per_device"], "ops": r["ops"],
                    "argument_bytes": r["argument_bytes"], "output_bytes": r["output_bytes"],
                    "temp_bytes": r["temp_bytes"], "peak_bytes": r["peak_bytes"],
                    "n_microbatches": cell.n_microbatches,
                    "microbatches_counted": r.get("microbatches_counted",
                                                  cell.n_microbatches)},
        "constants": {"peak_flops": hopper.PEAK_FLOPS, "hbm_bw": hopper.HBM_BW,
                      "link_bw": hopper.LINK_BW, "card": hopper.CARD},
    }
    terms = result["roofline_s"]
    result["bottleneck"] = max(terms, key=terms.get)
    if save_ops:
        result["ops_path"] = _artifact_path(arch, shape_name, name, ext=".ops.json")
        with open(result["ops_path"], "w") as f:
            json.dump({k: breakdown(r["counts"], top=40, key=k) for k in ("bytes", "flops")},
                      f, indent=1)
    return result


def count_rank(cfg, shape_name: str, mesh, **kw):
    """:func:`count_cell` for one device of ``mesh``: the cell itself on one
    device, else rank 0 of a fake process group of ``mesh.size`` ranks
    (module docstring).  The arguments come back as
    global meta tensors."""
    if mesh.size == 1:
        return count_cell(cfg, shape_name, mesh, **kw)
    import torch

    from repro_torch.distributed import sharding as shlib
    with shlib.fake_group(mesh.size):
        # a card's DeviceMesh where there is one; else a CPU one, on which
        # fake_group keeps the all-to-alls the card issues
        dmesh = shlib.dtensor_mesh(mesh, "cuda" if torch.cuda.is_available() else "cpu")
        cell, args, r = count_cell(cfg, shape_name, mesh, dmesh=dmesh, **kw)
        return cell, _meta_stand_ins(args), r


def _meta_stand_ins(tree):
    """The global meta tensors of a tree of DTensors (what
    ``cells.argument_bytes`` reads: shapes and dtypes)."""
    import torch
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: _meta_stand_ins(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta_stand_ins(v) for v in tree)
    return tree


def _artifact_path(arch, shape, mesh: str, ext=".json"):
    os.makedirs(ARTIFACTS, exist_ok=True)
    return os.path.join(ARTIFACTS, f"{arch}__{shape}__{mesh}{ext}")


def _run_one_subprocess(arch, shape, mesh: str, save_ops: bool) -> dict:
    path = _artifact_path(arch, shape, mesh)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", path]
    if save_ops:
        cmd.append("--save-ops")
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=CELL_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": f"timed out after {e.timeout} s"}
    if r.returncode != 0 or not os.path.exists(path):
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "error": (r.stderr or "")[-2000:] or f"exit {r.returncode}"}
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="off", choices=["on", "off", "both"])
    ap.add_argument("--mesh", default=None, choices=[*MESHES, "all"],
                    help="a mesh by name (1x1 is one H100); overrides --multi-pod")
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-ops", action="store_true",
                    help="also write the op breakdown (JAX's --save-hlo)")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs
    from repro_torch.configs.base import cells

    archs = list_archs() if args.arch == "all" else [args.arch]
    if args.mesh:
        meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    else:
        meshes = [mesh_name(mp) for mp in
                  {"on": [True], "off": [False], "both": [False, True]}[args.multi_pod]]

    if len(archs) == 1 and args.shape != "all":
        # single cell, in-process
        res = {}
        for name in meshes:
            try:
                res = run_cell(archs[0], args.shape, save_ops=args.save_ops, mesh=name)
            except Exception:
                res = {"arch": archs[0], "shape": args.shape, "mesh": name,
                       "error": traceback.format_exc()[-3000:]}
            out = args.out or _artifact_path(archs[0], args.shape, name)
            with open(out, "w") as f:
                json.dump(res, f, indent=1)
            print(json.dumps({k: res.get(k) for k in
                              ("arch", "shape", "mesh", "lower_s", "bottleneck", "error",
                               "skipped")}), flush=True)
        return 0 if "error" not in res else 1

    failures = 0
    for arch in archs:
        shapes = cells(arch) if args.shape == "all" else [args.shape]
        for shape in shapes:
            for name in meshes:
                t0 = time.time()
                res = _run_one_subprocess(arch, shape, name, args.save_ops)
                ok = "error" not in res
                failures += not ok
                print(f"{'OK  ' if ok else 'FAIL'} {arch:22s} {shape:12s} {name:8s} "
                      f"{time.time() - t0:7.1f}s  bottleneck={res.get('bottleneck')}",
                      flush=True)
                if not ok:
                    print("  " + res["error"].strip().splitlines()[-1], flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
