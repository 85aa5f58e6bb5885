"""The port's dry run (``repro_torch.launch.dryrun``, ``hillclimb``,
``report``) against the JAX package's, whose compiled figures
``tests/test_torch_dryrun_reference.py`` writes into
``tests/data/torch_dryrun_jax_rows.json``.

* On a 1x1 mesh at smoke size (a dense, a moe, an MLA and an ssm arch):
  the argument bytes equal JAX's ``memory_analysis`` exactly, once the
  leaves XLA drops as unused are added back (rwkv6's prefill never reads
  the token-shift states, its decode never reads ``pos``: the port's
  caller still holds them); the counted matmul FLOPs equal JAX's HLO dot
  FLOPs within 1%.
* On a 4x2 mesh at full width: the per-device argument bytes equal JAX's
  up to the one known difference, JAX's stacked norms under FSDP (ROADMAP
  Queue 3), which the test accounts for leaf by leaf.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.launch import cells as jcells
from repro.launch import hillclimb as jhill
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import cells as shape_cells
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import cells, dryrun, hillclimb, report
from test_torch_launch_cells import _carry, _flat, _jleaf

REF = json.loads((Path(__file__).resolve().parent / "data"
                  / "torch_dryrun_jax_rows.json").read_text())
MATMUL_RTOL = 1e-2
# what XLA drops as unused from the JAX cells (the port's arguments keep them)
PRUNED = {("rwkv6-3b", "prefill_32k"): ["[1][0][0]['cshift']", "[1][0][0]['tshift']"],
          ("rwkv6-3b", "decode_32k"): ["[3]"]}
# rwkv6's train and prefill cells take a minute on meta at smoke size (one
# dispatch per op of every 64-token chunk): their FLOPs are not recounted here
SLOW = {("rwkv6-3b", "train_4k"), ("rwkv6-3b", "prefill_32k")}
JAX_KEYS = {"arch", "shape", "mesh", "n_chips", "lower_s", "compile_s", "memory",
            "xla_cost_analysis", "per_device", "collectives", "roofline_s", "bottleneck"}


def _ids(cells_):
    return [f"{c['arch']}-{c['shape']}" for c in cells_]


@pytest.mark.parametrize("ref", REF["cells_1x1"], ids=_ids(REF["cells_1x1"]))
def test_a_smoke_cell_on_1x1_is_jax_s(ref):
    mesh = dryrun.make_mesh("1x1")
    cfg = get_smoke_config(ref["arch"])
    key = (ref["arch"], ref["shape"])
    assert ref["pruned"] == PRUNED.get(key, [])
    cell, args, donate = cells.build_cell(cfg, ref["shape"], mesh)
    assert list(donate) == ref["donate"]
    assert cell.n_microbatches == ref["n_microbatches"]
    assert cells.argument_bytes(cell, args, mesh) == ref["argument_bytes"] + ref["pruned_bytes"]
    if key in SLOW:
        return
    _, _, r = dryrun.count_cell(cfg, ref["shape"], mesh)
    assert r["matmul_flops"] == pytest.approx(ref["dot_flops"], rel=MATMUL_RTOL)
    assert r["argument_bytes"] == cells.argument_bytes(cell, args, mesh)   # one device
    assert r["flops_per_device"] >= r["matmul_flops"] > 0


def _local_bytes(shape, dtype_bytes: int, spec, sizes: dict) -> int:
    n = dtype_bytes
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        ways = math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str) else entry or ()))
        n *= dim // ways
    return n


@pytest.mark.parametrize("ref", REF["cells_4x2"], ids=_ids(REF["cells_4x2"]))
def test_argument_bytes_on_4x2_are_jax_s_but_for_the_stacked_norms(ref):
    """Leaf by leaf: every leaf a device holds is JAX's in bytes, but the
    norms and biases of a repeated run, which JAX stacks to (L, n) and shards
    over data under FSDP, where the port's per-layer (n,) stays whole."""
    sizes, names = ref["mesh"]
    tm = tsh.Mesh(tuple(names), tuple(sizes))
    cfg = get_config(ref["arch"]).replace(**ref["overrides"])
    cell, args, _ = cells.build_cell(cfg, ref["shape"], tm)
    got = cells.argument_bytes(cell, args, tm)
    jcfg = j_get_config(ref["arch"]).replace(**ref["overrides"])
    _, jargs, _ = jcells.build_cell(jcfg, ref["shape"], AbstractMesh(tuple(sizes), tuple(names)))
    leaves = jax.tree.map(_jleaf, jargs)
    kind = cell.kind
    rcfg = jcfg if kind == "train" else jcells.serving_config(jcfg, kind)
    want = [_carry(rcfg, leaves[0])]
    want.append({"m": _carry(rcfg, leaves[1]["m"]), "v": _carry(rcfg, leaves[1]["v"]),
                 "step": leaves[1]["step"]} if kind == "train"
                else _carry(rcfg, leaves[1], cache=True))
    want += list(leaves[2:])
    axis = dict(zip(names, sizes))
    diff, differing = 0, []
    for i, (t, spec, w) in enumerate(zip(args, cell.specs, want)):
        tflat, sflat, wflat = _flat(t), _flat(spec), _flat(w)
        assert [p for p, _ in tflat] == [p for p, _ in sflat] == [p for p, _ in wflat], i
        for (path, tensor), (_, tspec), (_, (shape, dtype, jspec)) in zip(tflat, sflat, wflat):
            assert (tuple(tensor.shape), str(tensor.dtype)) == (shape, f"torch.{dtype}"), path
            d = _local_bytes(shape, tensor.element_size(), tspec, axis) \
                - _local_bytes(shape, tensor.element_size(), jspec, axis)
            if d:
                differing.append((i, path, tensor.dim()))
                diff += d
    # only a repeated run's vectors of the parameters (the moments are
    # sharded over data on both sides: fsdp in JAX, opt_state in the port)
    assert all(i == 0 and path[0] == "layers" and rank == 1 for i, path, rank in differing), \
        differing
    assert (kind == "train") == bool(differing)
    assert got - diff == ref["argument_bytes"] + ref["pruned_bytes"]


def test_the_microbatch_trip_count_is_exact():
    mesh = dryrun.make_mesh("1x1")
    cfg = get_smoke_config("deepseek-moe-16b")
    _, _, exact = dryrun.count_cell(cfg, "train_4k", mesh, n_microbatches=4, exact=True)
    _, _, trip = dryrun.count_cell(cfg, "train_4k", mesh, n_microbatches=4)
    assert trip["microbatches_counted"] == [2, 3] and "microbatches_counted" not in exact
    for k in ("flops_per_device", "bytes_per_device", "matmul_flops", "ops", "peak_bytes",
              "temp_bytes", "output_bytes", "argument_bytes"):
        assert trip[k] == exact[k], k
    assert dict(trip["counts"].by_site) == dict(exact["counts"].by_site) == {}


def test_the_single_cell_cli_writes_jax_s_keys(tmp_path):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--mesh", "1x1",
                        "--out", str(out)]) == 0
    d = json.loads(out.read_text())
    assert JAX_KEYS <= d.keys()
    assert d["memory"].keys() == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert {"flops", "bytes", "collective_bytes"} <= d["per_device"].keys()
    assert d["per_device"]["split"] == "rank" and d["n_chips"] == 1
    assert d["per_device"]["collective_bytes"] == 0.0 and d["collectives"] == {}
    assert d["roofline_s"]["collective"] == 0.0 and "collective_reason" not in d
    assert d["bottleneck"] == max(("compute", "memory"), key=d["roofline_s"].get)
    assert d["compile_s"] == 0.0 and d["constants"]["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert d["memory"]["peak_bytes"] == d["memory"]["argument_bytes"] + d["memory"]["temp_bytes"]


def test_long_500k_is_skipped_outside_the_long_context_archs(tmp_path):
    assert "long_500k" not in shape_cells("granite-34b")
    r = dryrun.run_cell("granite-34b", "long_500k", mesh="1x1")
    assert r["skipped"] and "full-attention" in r["reason"]
    out = tmp_path / "skip.json"
    assert dryrun.main(["--arch", "granite-34b", "--shape", "long_500k", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["skipped"]


def test_the_all_archs_path_runs_each_cell_in_a_subprocess(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", str(tmp_path))
    r = dryrun._run_one_subprocess("whisper-tiny", "decode_32k", "2x16x16", False)
    assert "error" not in r and r["n_chips"] == 512 and r["mesh"] == "2x16x16"
    assert (tmp_path / "whisper-tiny__decode_32k__2x16x16.json").exists()
    bad = dryrun._run_one_subprocess("no-such-arch", "decode_32k", "1x1", False)
    assert "error" in bad
    # the loop over every arch's cells: exit 1 when any cell fails
    seen = []

    def fake(arch, shape, mesh, save_ops):
        seen.append((arch, shape, mesh))
        return {"error": "boom"} if arch == "rwkv6-3b" and shape == "long_500k" else {}
    monkeypatch.setattr(dryrun, "_run_one_subprocess", fake)
    assert dryrun.main(["--arch", "all", "--multi-pod", "both"]) == 1
    from repro_torch.configs import list_archs
    assert seen == [(a, s, m) for a in list_archs() for s in shape_cells(a)
                    for m in ("16x16", "2x16x16")]
    monkeypatch.setattr(dryrun, "_run_one_subprocess", lambda *a: {})
    assert dryrun.main(["--arch", "all", "--mesh", "1x1"]) == 0


def test_hillclimb_variants_are_jax_s_and_kv_seq_does_not_leak(monkeypatch):
    assert hillclimb.VARIANTS == jhill.VARIANTS
    monkeypatch.setitem(tsh.LOGICAL_RULES, "kv_seq", None)
    base = hillclimb.run("whisper-tiny", "decode_32k", "baseline")
    seq = hillclimb.run("whisper-tiny", "decode_32k", "unroll_seqshard")
    assert tsh.LOGICAL_RULES["kv_seq"] is None
    assert seq["collective_ms"] > 0 and seq["step_ms_bound"] > 0
    # variants that change nothing in the eager port give the baseline's numbers
    for variant in ("unroll", "qblock1k"):
        r = hillclimb.run("whisper-tiny", "decode_32k", variant)
        for k in ("compute_ms", "memory_ms", "temp_gib", "arg_gib", "step_ms_bound"):
            assert r[k] == base[k], (variant, k)


def test_report_renders_the_tables_from_artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", str(tmp_path))
    for shape in ("prefill_32k", "decode_32k"):
        r = dryrun.run_cell("whisper-tiny", shape, mesh="1x1")
        Path(dryrun._artifact_path("whisper-tiny", shape, "1x1")).write_text(json.dumps(r))
    Path(tmp_path / "gemma3-4b__train_4k__1x1.json").write_text(json.dumps(
        {"arch": "gemma3-4b", "shape": "train_4k", "mesh": "1x1", "error": "boom"}))
    Path(tmp_path / "granite-34b__long_500k__1x1.json").write_text(json.dumps(
        {"arch": "granite-34b", "shape": "long_500k", "mesh": "1x1", "skipped": True}))
    table = report.dryrun_table("1x1", root=str(tmp_path))
    lines = table.splitlines()
    assert len(lines) == 2 + 3 and "| gemma3-4b | train_4k | ERROR |" in table
    assert all("long_500k" not in ln for ln in lines)
    roof = report.roofline_table("1x1", root=str(tmp_path)).splitlines()
    assert len(roof) == 2 + 2 and all(ln.startswith("| whisper-tiny |") for ln in roof[2:])
    rows = report.report("1x1", root=str(tmp_path))
    for r in rows:
        assert 0 < r["useful_ratio"] and 0 < r["mfu"] < 1 and r["collective_s"] == 0.0
    assert report.model_flops("whisper-tiny", "decode_32k") > 0
