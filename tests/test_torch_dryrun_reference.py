"""The JAX package's dry-run figures that the port's dry run is held to
(``tests/test_torch_dryrun.py``).

Compiling the JAX package's cells takes minutes, so this file writes them:

    PYTHONPATH=src python tests/test_torch_dryrun_reference.py   # a few minutes

-> ``tests/data/torch_dryrun_jax_rows.json``, each cell's
``torch_dist_common.jax_cell_figures`` (argument bytes from
``memory_analysis``, the HLO's dot and convolution FLOPs through loops by
trip count, the microbatch count, the donated arguments):

* ``cells_1x1``: the smoke configs of a dense, a moe, an MLA and an ssm
  arch at train_4k, prefill_32k and decode_32k on a 1x1 mesh;
* ``cells_4x2``: full-width configs cut to a few layers (so that FSDP
  shards their weights: a smoke config's dims are all under ``fsdp_specs``'
  1024) on a 4x2 mesh of forced host devices.

Under pytest one cell is recompiled with the JAX package and held to the
file, so the file cannot go stale.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from torch_dist_common import jax_jobs

REF = Path(__file__).resolve().parent / "data" / "torch_dryrun_jax_rows.json"
MESH_1X1 = [[1, 1], ["data", "model"]]
MESH_4X2 = [[4, 2], ["data", "model"]]
ARCHS_1X1 = ("gemma3-4b", "deepseek-moe-16b", "deepseek-v2-lite-16b", "rwkv6-3b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
CELLS_1X1 = [dict(kind="dryrun_cell", arch=a, smoke=True, overrides={}, shape=s,
                  mesh=MESH_1X1) for a in ARCHS_1X1 for s in SHAPES]
# a repeated run in each (gemma3-4b's two local layers, v2-lite's moe layers,
# rwkv6's layers), so that JAX stacks their norms
CELLS_4X2 = ([dict(kind="dryrun_cell", arch="gemma3-4b", smoke=False,
                   overrides={"num_layers": 2}, shape=s, mesh=MESH_4X2) for s in SHAPES]
             + [dict(kind="dryrun_cell", arch=a, smoke=False, overrides={"num_layers": n},
                     shape="train_4k", mesh=MESH_4X2)
                for a, n in (("deepseek-v2-lite-16b", 3), ("rwkv6-3b", 2))])


def write() -> None:
    rows = jax_jobs(CELLS_1X1 + CELLS_4X2, timeout=3600.0)
    n = len(CELLS_1X1)
    REF.write_text(json.dumps(dict(
        about="the JAX package's dry-run cells compiled on the CPU (forced host devices): "
              "argument bytes a device, HLO dot+convolution FLOPs by trip count; written "
              "by python tests/test_torch_dryrun_reference.py",
        cells_1x1=[dict(c, **r) for c, r in zip(CELLS_1X1, rows[:n])],
        cells_4x2=[dict(c, **r) for c, r in zip(CELLS_4X2, rows[n:])]), indent=1) + "\n")


def test_reference_file_matches_the_jax_package():
    ref = json.loads(REF.read_text())
    for key, cells in (("cells_1x1", CELLS_1X1), ("cells_4x2", CELLS_4X2)):
        assert [{k: c[k] for k in cell} for c, cell in zip(ref[key], cells)] == cells
    job = CELLS_1X1[SHAPES.index("decode_32k")]
    got = jax_jobs([job])[0]
    want = next(c for c in ref["cells_1x1"] if {k: c[k] for k in job} == job)
    assert {k: want[k] for k in got} == got


if __name__ == "__main__":
    sys.exit(write())
