"""The dry run's shape grid and cells (``repro_torch.configs.base``'s
``SHAPES`` / ``cells``, ``repro_torch.launch.cells``) against the JAX
package's, and the parameter counts the roofline's model FLOPs read.

A cell's stand-ins are compared leaf by leaf with JAX's ``input_specs``
after ``convert``'s layout change: JAX's run-stacked leaves are unstacked
into the port's per-layer leaves (their leading "layers" dim, which no mesh
axis shards, dropped), and each leaf's global shape, dtype, physical spec
and DTensor placements must be equal.
"""

from __future__ import annotations

import dataclasses

import jax
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs import list_archs as j_list_archs
from repro.configs import base as jbase
from repro.launch import cells as jcells
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import cells as tcells
from repro_torch.models import registry as treg

ARCHS = j_list_archs()
MESHES = {"1x1": ((1, 1), ("data", "model")), "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# one arch of each family (the moe family with MHA and with MLA)
FAMILY_ARCHS = ["gemma3-4b", "internvl2-76b", "deepseek-moe-16b", "deepseek-v2-lite-16b",
                "rwkv6-3b", "hymba-1.5b", "whisper-tiny"]


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), tsh.Mesh(names, sizes)


def test_shape_grid_is_jax_s():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.LONG_CTX_ARCHS == jbase.LONG_CTX_ARCHS
    from repro_torch.configs import SHAPES, ShapeConfig
    assert SHAPES is tbase.SHAPES and ShapeConfig is tbase.ShapeConfig
    for arch in ARCHS:
        assert tbase.cells(arch) == jbase.cells(arch), arch
    assert tbase.cells("granite-34b") == ["train_4k", "prefill_32k", "decode_32k"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_serving_config_is_jax_s(kind):
    for arch in ARCHS:
        got = dataclasses.asdict(tcells.serving_config(t_get_config(arch), kind))
        assert got == dataclasses.asdict(jcells.serving_config(j_get_config(arch), kind)), arch


@pytest.mark.parametrize("mesh", ["1x1", "16x16", "2x16x16"])
def test_default_microbatches_are_jax_s(mesh):
    jm, tm = _meshes(mesh)
    for arch in ARCHS:
        for name, shape in tbase.SHAPES.items():
            if shape.kind != "train":
                continue
            got = tcells.default_microbatches(t_get_config(arch), shape, tm)
            assert got == jcells.default_microbatches(j_get_config(arch), jbase.SHAPES[name],
                                                      jm), (arch, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_are_jax_s(arch):
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    assert treg.param_count(tcfg) == jreg.param_count(jcfg) == tcfg.param_count()
    active = jreg.param_count(jcfg, active_only=True)
    assert treg.param_count(tcfg, active_only=True) == active
    assert tcfg.active_param_count() == jcfg.active_param_count() == active
    if tcfg.num_experts:
        assert active < treg.param_count(tcfg)
    else:
        assert active == treg.param_count(tcfg)


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------


def _norm(spec, rank: int) -> tuple:
    """A spec with one-name tuples read as the name, padded to ``rank``."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec]
    return tuple(out + [None] * (rank - len(out)))


def _jleaf(sd) -> tuple:
    return tuple(sd.shape), str(sd.dtype), _norm(tuple(sd.sharding.spec), len(sd.shape))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _drop(tree):
    """A stacked leaf's per-layer leaf: the leading dim (unsharded) dropped."""
    def one(leaf):
        shape, dtype, spec = leaf
        assert spec[0] is None, leaf
        return shape[1:], dtype, spec[1:]
    return _map(tree, one)


def _carry(cfg, tree, *, cache: bool = False):
    """JAX's run-stacked params (or cache) of stand-in leaves in the port's
    layout (``repro_torch.models.convert``)."""
    if cfg.family == "encdec":
        if cache:
            return [_drop(tree) for _ in range(cfg.num_layers)]
        return {"head": tree["head"],
                "enc": [_drop(tree["enc"]) for _ in range(cfg.num_encoder_layers)],
                "dec": [_drop(tree["dec"]) for _ in range(cfg.num_layers)],
                "enc_norm": tree["enc_norm"]}
    runs = tree if cache else tree["runs"]
    layers = []
    for run, plist in zip(jstack.compute_runs(cfg), runs):
        for _ in range(run.count):
            layers += plist if run.count == 1 else [_drop(sub) for sub in plist]
    if cache:
        return layers
    out = {"head": tree["head"], "layers": layers}
    if "meta" in tree:
        out["meta"] = tree["meta"]
    return out


def _flat(tree, path=()) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _flat(v, path + (i,))]
    return [(path, tree)]


def _placements_of(spec: tuple, axis_names) -> tuple:
    out = {a: Replicate() for a in axis_names}
    for dim, entry in enumerate(spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out[a] = Shard(dim)
    return tuple(out[a] for a in axis_names)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_stand_ins_are_jax_s_input_specs(arch, shape):
    jm, tm = _meshes("4x2")
    jcfg, tcfg = j_get_smoke_config(arch), t_get_smoke_config(arch)
    _, jargs, jdonate = jcells.build_cell(jcfg, shape, jm)
    cell, targs, tdonate = tcells.build_cell(tcfg, shape, tm)
    assert tdonate == jdonate
    kind = tbase.SHAPES[shape].kind
    assert cell.kind == kind
    leaves = jax.tree.map(_jleaf, jargs)
    rcfg = jcfg if kind == "train" else jcells.serving_config(jcfg, kind)
    want = [_carry(rcfg, leaves[0])]
    if kind == "train":
        want.append({"m": _carry(rcfg, leaves[1]["m"]), "v": _carry(rcfg, leaves[1]["v"]),
                     "step": leaves[1]["step"]})
    else:
        want.append(_carry(rcfg, leaves[1], cache=True))
    want += list(leaves[2:])

    stand = tcells.input_specs(tcfg, shape, tm)
    assert len(stand) == len(want) == len(targs) == len(cell.specs)
    for i, (s, w, spec) in enumerate(zip(stand, want, cell.specs)):
        got, exp = _flat(s), _flat(w)
        specs = _flat(spec)
        assert [p for p, _ in got] == [p for p, _ in exp] == [p for p, _ in specs], i
        for (path, leaf), (_, (shape_, dtype, jspec)), (_, tspec) in zip(got, exp, specs):
            where = (i, path)
            assert leaf.shape == shape_, where
            assert str(leaf.dtype).removeprefix("torch.") == dtype, where
            assert _norm(tspec, len(shape_)) == jspec, where
            assert leaf.placements == _placements_of(jspec, jm.axis_names), where


def test_build_cell_refuses_the_kernel_path_and_takes_overrides():
    tm = tsh.Mesh(("data", "model"), (1, 1))
    cfg = t_get_smoke_config("gemma3-4b")
    with pytest.raises(ValueError, match="attn_impl='ref'"):
        tcells.build_cell(cfg.replace(attn_impl="kernel"), "decode_32k", tm)
    cell, args, _ = tcells.build_cell(cfg, "train_4k", tm, n_microbatches=4,
                                      overrides={"num_layers": 2})
    assert cell.n_microbatches == 4 and len(args[0]["layers"]) == 2
    assert all(t.device.type == "meta" for t in treg.leaves(args))
