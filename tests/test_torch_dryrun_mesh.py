"""The dry run's per-rank count on a multi-device mesh, held to the JAX
package's per-device figures on the same mesh, and ``op_analysis``' rank
design pinned in closed form.

A cell on a mesh of more than one device runs as rank 0 of a fake process
group (``launch.dryrun.count_rank``): DTensor arguments whose local shards
are meta tensors, the rank's local ops and collectives counted.  The JAX
package compiles the same cell on 8 forced host devices and costs its HLO
(``torch_dist_common.jax_cell_figures``: the dots by trip count, and
``hlo_analysis``' collective table).  Compiling takes minutes, so this file
writes the JAX figures, with the port's collective table beside them:

    PYTHONPATH=src python tests/test_torch_dryrun_mesh.py   # a few minutes

-> ``tests/data/torch_dryrun_mesh_jax_rows.json``.  Under pytest one row is
recompiled with the JAX package and recounted with the port, and both are
held to the file.  The cells are every family's smoke config (float32
params, as the grid's) at small shapes of the grid's kinds, on a (4, 2)
("data", "model") mesh: a prefill and a decode cell each, and gemma3-4b's
train cell; and decode cells on a (2, 2, 2) ("pod", "data", "model") mesh,
whose batch is split over two mesh axes.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, op_analysis
from torch_dist_common import jax_jobs

REF = Path(__file__).resolve().parent / "data" / "torch_dryrun_mesh_jax_rows.json"
MESH = [[4, 2], ["data", "model"]]
POD = [[2, 2, 2], ["pod", "data", "model"]]
# small shapes of the grid's three kinds: a rank holds 2 of the 8 rows
CELL_SHAPES = {"mesh_train": [128, 8, "train"], "mesh_prefill": [256, 8, "prefill"],
               "mesh_decode": [1024, 8, "decode"]}
ARCHS = ("gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
         "rwkv6-3b", "hymba-1.5b", "whisper-tiny")
POD_ARCHS = ("gemma3-4b", "deepseek-moe-16b", "rwkv6-3b", "hymba-1.5b")


def _cell(arch, shape, mesh=MESH):
    return dict(kind="dryrun_cell", arch=arch, smoke=True, overrides={}, shape=shape,
                mesh=mesh, shapes=CELL_SHAPES, collectives=True)


CELLS = ([_cell(a, s) for a in ARCHS for s in ("mesh_prefill", "mesh_decode")]
         + [_cell("gemma3-4b", "mesh_train")]
         + [_cell(a, "mesh_decode", POD) for a in POD_ARCHS])
# gemma3-4b's train cell reads 1.0075: the last layer's attention scores, which
# its backward recomputes (``layers.attention``'s checkpoint), are one product
# more than XLA's, which merges that layer's recomputation (outside its scan)
# with the forward's
FLOPS_RTOL = 0.01
# the per-rank collective bytes over JAX's: the dense family's prefill within
# [0.5, 2]; every other ratio pinned (ROADMAP.md's pinned differences)
DENSE = ("gemma3-4b", "internvl2-76b")
COLL_RATIOS = {("gemma3-4b", "mesh_decode", "4x2"): 0.2353,
               ("internvl2-76b", "mesh_decode", "4x2"): 0.2532,
               ("deepseek-moe-16b", "mesh_prefill", "4x2"): 0.4978,
               ("deepseek-moe-16b", "mesh_decode", "4x2"): 0.3002,
               ("deepseek-v2-lite-16b", "mesh_prefill", "4x2"): 0.4978,
               ("deepseek-v2-lite-16b", "mesh_decode", "4x2"): 0.4006,
               ("rwkv6-3b", "mesh_prefill", "4x2"): 0.5, ("rwkv6-3b", "mesh_decode", "4x2"): 0.5,
               ("hymba-1.5b", "mesh_prefill", "4x2"): 0.9491,
               ("hymba-1.5b", "mesh_decode", "4x2"): 0.6624,
               ("whisper-tiny", "mesh_prefill", "4x2"): 0.5,
               ("whisper-tiny", "mesh_decode", "4x2"): 0.2267,
               ("gemma3-4b", "mesh_train", "4x2"): 0.6864,
               ("gemma3-4b", "mesh_decode", "2x2x2"): 0.2353,
               ("deepseek-moe-16b", "mesh_decode", "2x2x2"): 0.4049,
               ("rwkv6-3b", "mesh_decode", "2x2x2"): 0.5,
               ("hymba-1.5b", "mesh_decode", "2x2x2"): 0.6624}


def _mesh(job):
    sizes, names = job["mesh"]
    return sh.Mesh(tuple(names), tuple(sizes))


def _with_shapes():
    for name, (seq, rows, kind) in CELL_SHAPES.items():
        SHAPES[name] = ShapeConfig(name, seq, rows, kind)


def port_row(job: dict) -> dict:
    """The port's count of a cell on its mesh, as one rank."""
    _with_shapes()
    try:
        cfg = get_smoke_config(job["arch"])
        _, _, r = dryrun.count_rank(cfg, job["shape"], _mesh(job))
    finally:
        for name in CELL_SHAPES:
            SHAPES.pop(name, None)
    return {"matmul_flops": r["matmul_flops"], "collectives": r["collectives"],
            "collective_bytes": r["collective_bytes_per_device"]}


def write() -> None:
    rows = jax_jobs(CELLS, timeout=3600.0)
    cells = []
    for job, jx in zip(CELLS, rows):
        port = port_row(job)
        cells.append(dict(job, jax={k: jx[k] for k in ("dot_flops", "collectives",
                                                        "collective_bytes")},
                          port=port, ratio=port["collective_bytes"]
                          / max(jx["collective_bytes"], 1.0)))
    REF.write_text(json.dumps(dict(
        about="per-device dot FLOPs and collectives of the JAX package's dry-run cells "
              "(smoke configs, small shapes, 4x2 and 2x2x2 meshes of forced host devices, "
              "hlo_analysis), beside the port's per-rank count; written by "
              "python tests/test_torch_dryrun_mesh.py", cells=cells), indent=1) + "\n")


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF.read_text())["cells"]


def _key(job):
    return job["arch"], job["shape"], "x".join(map(str, job["mesh"][0]))


def _id(job):
    arch, shape, mesh = _key(job)
    return f"{arch}-{shape}" + ("" if job["mesh"] == MESH else f"-{mesh}")


@pytest.fixture(scope="module")
def port(ref):
    return {_key(c): port_row(c) for c in CELLS}


def test_reference_file_matches_the_jax_package_and_the_port(ref):
    assert [_key(c) for c in ref] == [_key(c) for c in CELLS]
    job = next(c for c in CELLS if _key(c) == ("gemma3-4b", "mesh_decode", "2x2x2"))
    got = jax_jobs([job])[0]
    want = next(c for c in ref if _key(c) == _key(job))
    assert want["jax"] == {k: got[k] for k in want["jax"]}
    assert want["port"] == port_row(job)


@pytest.mark.parametrize("job", CELLS, ids=_id)
def test_per_rank_matmul_flops_match_jax_s_per_device_dots(ref, port, job):
    want = next(c for c in ref if _key(c) == _key(job))["jax"]["dot_flops"]
    got = port[_key(job)]["matmul_flops"]
    assert want > 0
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


@pytest.mark.parametrize("job", CELLS, ids=_id)
def test_per_rank_collectives_are_pinned_beside_jax_s(ref, port, job):
    row = next(c for c in ref if _key(c) == _key(job))
    got = port[_key(job)]
    assert got == row["port"]
    assert set(got["collectives"]) <= {"all-reduce", "all-gather", "reduce-scatter",
                                       "all-to-all"}
    assert got["collective_bytes"] == sum(v["bytes"] for v in got["collectives"].values())
    ratio = got["collective_bytes"] / row["jax"]["collective_bytes"]
    if _key(job) in COLL_RATIOS:
        assert round(ratio, 4) == COLL_RATIOS[_key(job)], ratio
    else:
        assert job["arch"] in DENSE and 0.5 <= ratio <= 2.0, ratio


def test_the_counter_costs_a_sharded_mm_chain_at_the_rank_s_shapes():
    """x (16, 64) over "data", w1 (64, 32) by columns and w2 (32, 64) by rows
    over "model": the rank's products are (4, 64) x (64, 16) and (4, 16) x
    (16, 64), the second a partial sum that one all-reduce over "model"
    completes; CommDebugMode sees the same collectives."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = _mesh(CELLS[0])

    def leaf(shape, pl):
        ways = [1] * len(shape)
        for p, n in zip(pl, mesh.axis_sizes):
            if isinstance(p, Shard):
                ways[p.dim] *= n
        loc = torch.empty([s // w for s, w in zip(shape, ways)], device="meta")
        return DTensor.from_local(loc, dm, pl, run_check=False, shape=torch.Size(shape),
                                  stride=sh.contiguous_stride(shape))

    def chain(x, w1, w2):
        z = (x @ w1) @ w2
        return z.redistribute(dm, [Shard(0), Replicate()])

    with sh.fake_group(mesh.size):
        dm = sh.dtensor_mesh(mesh, "cpu")
        args = (leaf((16, 64), [Shard(0), Replicate()]),
                leaf((64, 32), [Replicate(), Shard(1)]),
                leaf((32, 64), [Replicate(), Shard(0)]))
        r = op_analysis.analyze(chain, *args)
        with CommDebugMode() as comm:
            chain(*args)
    f = 4.0                                   # float32 bytes
    assert r["matmul_flops"] == r["flops_per_device"] == 2 * 4 * 64 * 16 + 2 * 4 * 16 * 64
    assert r["collectives"] == {"all-reduce": {"count": 1, "bytes": 4 * 64 * f}}
    assert r["collective_bytes_per_device"] == 4 * 64 * f
    mm_bytes = (4 * 64 + 64 * 16 + 4 * 16) * f + (4 * 16 + 16 * 64 + 4 * 64) * f
    assert r["bytes_per_device"] == mm_bytes + 2 * 4 * 64 * f
    assert r["argument_bytes"] == (4 * 64 + 64 * 16 + 16 * 64) * f
    counts = {str(k).split(".")[-1]: v for k, v in comm.get_comm_counts().items()}
    assert counts == {"all_reduce": 1}


def test_the_output_projection_folds_a_batch_split_over_two_mesh_axes():
    """On (2, 2, 2), the decode's heads (B, 1, H, D) with the batch over ("pod",
    "data") and the heads whole, as a split-K cache's attention leaves them:
    the rank's product is one (B/4, H*D) x (H*D, d) matmul.  DTensor gives
    such a batch a global stride ``matmul`` will not fold, and the product
    was a batched one over the weight copied to every row."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import attention
    cfg = get_smoke_config("gemma3-4b")
    mesh = _mesh(_cell("gemma3-4b", "mesh_decode", POD))
    h, d, b = cfg.num_heads, cfg.head_dim, 16
    with sh.fake_group(mesh.size):
        dm = sh.dtensor_mesh(mesh, "cpu")
        out = DTensor.from_local(torch.empty((b // 4, 1, h, d), device="meta"), dm,
                                 [Shard(0), Shard(0), Replicate()], run_check=False)
        wo = sh.distribute_leaf(torch.empty((h, d, cfg.d_model), device="meta"), None, dm)
        with sh.use_mesh(mesh):
            r = op_analysis.analyze(lambda o, w: attention._out_proj(
                cfg.replace(num_heads=3), {"wo": w}, o), out, wo, sites=True)
    assert r["matmul_flops"] == 2 * (b // 4) * h * d * cfg.d_model
    kinds = {site.split(":")[0] for site in r["counts"].by_site}
    assert "mm" in kinds and not kinds & {"bmm", "clone", "expand"}, kinds


def test_every_kernel_wrapper_refuses_a_dtensor():
    from torch.distributed.tensor import Replicate

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import moe_expert_ffn
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan
    with sh.fake_group(8):
        dm = sh.dtensor_mesh(_mesh(CELLS[0]), "cpu")

        def d(t):
            return sh.distribute_leaf(t, None, dm)
        q = torch.zeros((8, 1, 4, 16))
        assert d(q).placements == (Replicate(), Replicate())
        x, w = torch.zeros((2, 8, 16)), torch.zeros((2, 16, 32))
        r = torch.zeros((1, 8, 2, 16))
        for call in (lambda: decode_attention(d(q), q, q, torch.zeros(8, dtype=torch.int32)),
                     lambda: flash_attention(q, d(q), q),
                     lambda: moe_expert_ffn(x, w, w, d(w.transpose(1, 2).contiguous())),
                     lambda: rwkv6_scan(d(r), r, r, r, torch.zeros(2, 16))):
            with pytest.raises(TypeError, match="local shards"):
                call()


if __name__ == "__main__":
    sys.exit(write())
