"""The port's sharding machinery (``repro_torch.distributed.sharding``,
``launch/mesh.py``, ``training.optimizer.opt_specs``, every family's
``param_specs`` / ``cache_specs``) against the JAX package's, on the same
meshes: JAX's concrete 1x1 mesh and ``AbstractMesh``es of 4x2, 16x16 and
2x16x16 (jax 0.9's ``AbstractMesh(axis_sizes, axis_names)``), the port's
``Mesh`` of the same names and sizes.  Every comparison is equality.

The port's parameter and cache trees are flat per-layer lists
(``repro_torch.models.convert``); JAX's spec trees are carried through the
same layout change (``_port_layout``: a repeated run's leading "layers"
axis dropped) before they are compared.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import registry as jreg
from repro.models import stack as jstack
from repro.training.optimizer import opt_specs as j_opt_specs
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_archs as t_list_archs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import registry as treg
from repro_torch.training import opt_specs as t_opt_specs

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    """(JAX mesh, port mesh) of one shape: JAX's 1x1 is a real mesh on the
    one CPU device, the others are abstract."""
    sizes, names = MESHES[name]
    jm = jax.make_mesh(sizes, names) if name == "1x1" else AbstractMesh(sizes, names)
    return jm, tsh.Mesh(names, sizes)


def _same(spec: tuple, p: P) -> bool:
    """A port spec equals a JAX PartitionSpec (which reads a one-name tuple
    entry as that name)."""
    return isinstance(spec, tuple) and P(*spec) == p and len(spec) == len(p)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

RESOLVE_CASES = [(a, axes) for a in [*tsh.LOGICAL_RULES, "unknown_axis", None]
                 for axes in (("data", "model"), ("pod", "data", "model"), ("model",),
                              ("functions",), ("points",))]


def test_logical_rules_are_jax_s():
    assert tsh.LOGICAL_RULES == jsh.LOGICAL_RULES


@pytest.mark.parametrize("axis,mesh_axes", RESOLVE_CASES)
def test_resolve_matches_jax(axis, mesh_axes):
    assert tsh._resolve(axis, mesh_axes) == jsh._resolve(axis, mesh_axes)


def test_resolve_preserves_tuple_rules_and_collapses_strings():
    # tests/test_distributed.py's cases, on the port
    assert tsh._resolve("heads", ("data", "model")) == "model"
    assert tsh._resolve("batch", ("data", "model")) == ("data",)
    assert tsh._resolve("batch", ("pod", "data", "model")) == ("pod", "data")
    assert tsh._resolve("batch", ("model",)) is None
    assert tsh._resolve("unknown_axis", ("data", "model")) is None
    assert tsh._resolve(None, ("data", "model")) is None


@pytest.mark.parametrize("mesh", list(MESHES))
def test_logical_to_spec_matches_jax(mesh):
    jm, tm = _meshes(mesh)
    for logical in [("batch", "seq", "heads"), ("embed", "ffn"), ("experts", "embed", "expert_ffn"),
                    ("layers", "batch", None, "kv_heads", None), ("vocab", "embed"),
                    ("opt_state", "fsdp"), ("batch", "kv_seq", None), tuple(tsh.LOGICAL_RULES)]:
        assert _same(tsh.logical_to_spec(logical, tm), jsh.logical_to_spec(logical, jm))
        with tsh.use_mesh(tm), jsh.use_mesh(jm):
            assert _same(tsh.logical_to_spec(logical), jsh.logical_to_spec(logical))
    assert tsh.logical_to_spec(("batch",)) == () and _same((), jsh.logical_to_spec(("batch",)))
    # a tuple rule stays a tuple on a mesh where one of its axes survives
    assert tsh.logical_to_spec(("batch", "heads"), _meshes("4x2")[1]) == (("data",), "model")


SANITIZE_CASES = [
    # tests/test_distributed.py: non-divisible dims, tuple entries, the
    # single-survivor tuple, spec longer and shorter than the shape
    (("data", "model"), (6, 8)), ((("data", "model"),), (16,)), ((("data", "model"),), (12,)),
    ((("data",), None), (8, 3)), (("data", "model"), (8,)), (("data",), (8, 6, 4)),
    ((("pod", "data"), "model"), (4, 6)), ((None, "model"), (1, 3)),
]


def _names(spec):
    return {a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)}


@pytest.mark.parametrize("mesh,spec,shape", [
    (m, spec, shape) for m in ("4x2", "16x16", "2x16x16") for spec, shape in SANITIZE_CASES
    if _names(spec) <= set(MESHES[m][1])])
def test_sanitize_spec_matches_jax(mesh, spec, shape):
    jm, tm = _meshes(mesh)
    assert _same(tsh.sanitize_spec(spec, shape, tm), jsh.sanitize_spec(P(*spec), shape, jm))


def test_sanitize_spec_cases_of_the_jax_tests():
    """tests/test_distributed.py's sanitize cases (which build JAX's
    AbstractMesh with an older signature), on the port."""
    tm = tsh.Mesh(("data", "model"), (4, 2))
    assert tsh.sanitize_spec(("data", "model"), (6, 8), tm) == (None, "model")
    assert tsh.sanitize_spec((("data", "model"),), (16,), tm) == (("data", "model"),)
    assert tsh.sanitize_spec((("data", "model"),), (12,), tm) == (None,)
    assert tsh.sanitize_spec((("data",), None), (8, 3), tm) == (("data",), None)
    assert tsh.sanitize_spec(("data", "model"), (8,), tm) == ("data", "model")
    assert tsh.sanitize_spec(("data",), (8, 6, 4), tm) == ("data",)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axis_size_and_div_axis_match_jax(mesh):
    jm, tm = _meshes(mesh)
    assert tm.shape == dict(jm.shape)
    with tsh.use_mesh(tm), jsh.use_mesh(jm):
        for a in [*tsh.LOGICAL_RULES, "unknown_axis"]:
            assert tsh.mesh_axis_size(a) == jsh.mesh_axis_size(a), a
            assert tsh.mesh_axis_size(a, tm) == jsh.mesh_axis_size(a, jm), a
            for dim in (1, 2, 6, 8, 12, 16, 32, 48, 256, 1000):
                assert tsh.div_axis(a, dim) == jsh.div_axis(a, dim), (a, dim)
        assert tsh.div_axis(None, 8) is jsh.div_axis(None, 8) is None


def test_fsdp_specs_cases_of_the_jax_tests():
    """tests/test_distributed.py's fsdp cases, on the port and on JAX."""
    for mesh, shapes, specs, want in [
        ("16x16", {"w": (2048, 16, 128), "norm": (2048,)},
         {"w": ("embed", "heads", None), "norm": (None,)},
         {"w": ("fsdp", "heads", None), "norm": (None,)}),
        ("16x16", {"w_odd": (1000, 4096), "w_small": (256, 256), "w_none": (2048, 2048)},
         {"w_odd": (None, None), "w_small": (None, None), "w_none": None},
         {"w_odd": (None, "fsdp"), "w_small": (None, None), "w_none": ("fsdp", None)}),
    ]:
        jm, tm = _meshes(mesh)
        with tsh.use_mesh(tm), jsh.use_mesh(jm):
            got = tsh.fsdp_specs(specs, shapes)
            jshapes = {k: jax.ShapeDtypeStruct(v, jnp.float32) for k, v in shapes.items()}
            assert got == jsh.fsdp_specs(specs, jshapes) == want


def _placements_of(ns: NamedSharding):
    """JAX's NamedSharding as DTensor placements, one per mesh axis."""
    out = {a: Replicate() for a in ns.mesh.axis_names}
    for dim, entry in enumerate(ns.spec):
        for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
            out[a] = Shard(dim)
    return tuple(out[a] for a in ns.mesh.axis_names)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_tree_to_shardings_matches_jax(mesh):
    jm, tm = _meshes(mesh)
    tree = {"a": ("batch", None, "heads"), "b": None, "c": [("vocab", "embed"), ("fsdp", "ffn")],
            "d": {"e": ("layers", "batch", "kv_seq", None)}}
    got = tsh.spec_tree_to_shardings(tree, tm)
    want = jsh.spec_tree_to_shardings(tree, jm)
    assert got["a"] == _placements_of(want["a"]) and got["b"] == _placements_of(want["b"])
    assert got["c"] == [_placements_of(w) for w in want["c"]]
    assert got["d"]["e"] == _placements_of(want["d"]["e"])
    assert tsh.sharding_for(("batch", None, "heads"), tm) == got["a"]
    assert tsh.sharding_for(("batch",)) is jsh.sharding_for(("batch",)) is None


def test_use_mesh_nests_and_restores():
    a, b = tsh.Mesh(("data", "model"), (4, 2)), tsh.Mesh(("data", "model"), (16, 16))
    assert tsh.current_mesh() is None
    with tsh.use_mesh(a) as got:
        assert got is a and tsh.current_mesh() is a
        with tsh.use_mesh(b):
            assert tsh.current_mesh() is b
            assert tsh.mesh_axis_size("batch") == 16
        assert tsh.current_mesh() is a
        with tsh.use_mesh(None):
            assert tsh.current_mesh() is None and tsh.mesh_axis_size("batch") == 1
    assert tsh.current_mesh() is None


def test_shard_is_the_identity_on_plain_tensors():
    x = torch.ones(4, 4)
    assert tsh.shard(x, "batch", None) is x
    with tsh.use_mesh(tsh.Mesh(("data", "model"), (1, 1))):
        assert tsh.shard(x, "batch", None) is x


def test_device_mesh_on_the_cpu_and_its_refusals():
    m = tsh.device_mesh(3, "functions", device="cpu")
    assert m.axis_names == ("functions",) and m.shape == {"functions": 3}
    assert m.devices == (torch.device("cpu"),) * 3
    assert tsh.device_mesh(2, "points", device=torch.device("cpu")).size == 2
    with pytest.raises(ValueError, match="needs >= 1 device"):
        tsh.device_mesh(0, "functions", device="cpu")
    n = torch.cuda.device_count()
    for device in (None, "cuda"):
        with pytest.raises(ValueError, match=rf"device_mesh\({n + 1}, 'functions'\): only {n} "):
            tsh.device_mesh(n + 1, "functions", device=device)
    with pytest.raises(ValueError, match="3 positions was given 2 devices"):
        tsh.Mesh(("functions",), (3,), (torch.device("cpu"),) * 2)


def test_production_and_host_meshes():
    for multi_pod, (sizes, names) in ((False, MESHES["16x16"]), (True, MESHES["2x16x16"])):
        m = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert (m.axis_sizes, m.axis_names, m.devices) == (sizes, names, None)
    host = tmesh.make_host_mesh(device="cpu")
    jhost = jmesh.make_host_mesh()
    assert host.axis_names == jhost.axis_names and host.shape == dict(jhost.shape)
    assert host.devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()


# ---------------------------------------------------------------------------
# the spec trees of every family
# ---------------------------------------------------------------------------


def _drop_layers(tree, drop: bool = True):
    if isinstance(tree, dict):
        return {k: _drop_layers(v, drop) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_drop_layers(v, drop) for v in tree]
    assert tree[0] == "layers", tree
    return tree[1:] if drop else tree


def _port_layout(cfg, tree: dict, *, cache: bool = False, drop: bool = True):
    """A JAX spec tree (params, or a cache when ``cache``) in the port's
    layout: the run list unrolled into one entry a layer, a repeated run's
    leading "layers" axis dropped (``repro_torch.models.convert``), or kept
    with ``drop=False``."""
    _drop = functools.partial(_drop_layers, drop=drop)
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


def _assert_matches_tensors(specs, tensors, path="") -> int:
    """Key for key, each spec's length the tensor's rank; -> leaf count."""
    if isinstance(tensors, torch.Tensor):
        assert isinstance(specs, tuple) and len(specs) == tensors.dim(), (path, specs,
                                                                          tuple(tensors.shape))
        return 1
    if isinstance(tensors, dict):
        assert isinstance(specs, dict) and specs.keys() == tensors.keys(), path
        return sum(_assert_matches_tensors(specs[k], tensors[k], f"{path}/{k}") for k in tensors)
    assert isinstance(specs, list) and len(specs) == len(tensors), path
    return sum(_assert_matches_tensors(s, t, f"{path}/{i}")
               for i, (s, t) in enumerate(zip(specs, tensors)))


def _mesh_ctx(name):
    if name is None:
        return tsh.use_mesh(None), jsh.use_mesh(None)
    jm, tm = _meshes(name)
    return tsh.use_mesh(tm), jsh.use_mesh(jm)


ARCHS = j_list_archs()


def test_the_registries_hold_the_same_archs():
    assert t_list_archs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_jax_and_the_trees(arch):
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    params = treg.init_params(tcfg, device="meta")
    cache = treg.init_cache(tcfg, 2, 64, device="meta")
    for mesh in (None, *MESHES):
        tctx, jctx = _mesh_ctx(mesh)
        with tctx, jctx:
            pspec, cspec = treg.param_specs(tcfg), treg.cache_specs(tcfg)
            assert pspec == _port_layout(jcfg, jreg.param_specs(jcfg)), mesh
            assert cspec == _port_layout(jcfg, jreg.cache_specs(jcfg), cache=True), mesh
        n = _assert_matches_tensors(pspec, params)
        assert n == len(treg.leaves(params))
        assert _assert_matches_tensors(cspec, cache) == len(treg.leaves(cache))


def _sds(tree):
    """The port's (meta) tensor tree as JAX shape structs."""
    return jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32), tree)


def _stacked_vectors(jtree, ttree, path=()):
    """Paths of the leaves that are vectors in the port's tree and (L, n)
    stacks of them in JAX's (``jtree``: JAX's specs in the port's layout,
    "layers" kept): a repeated run's norms and biases."""
    if isinstance(ttree, torch.Tensor):
        return [path] if ttree.dim() == 1 and jtree[0] == "layers" else []
    keys = ttree.keys() if isinstance(ttree, dict) else range(len(ttree))
    return [p for k in keys for p in _stacked_vectors(jtree[k], ttree[k], path + (k,))]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_and_opt_specs_match_jax(arch):
    """``fsdp_specs`` and ``opt_specs`` are JAX's rules on the port's tree,
    equal leaf for leaf.  Carried from JAX's run-stacked tree they are equal
    too, but at a repeated run's vectors (norms, biases): JAX sees them as
    (L, n) and shards n over data, where the port's (n,) is a 1-D param and
    stays whole (ROADMAP Queue 3)."""
    tcfg, jcfg = t_get_config(arch), j_get_config(arch)
    params = treg.init_params(tcfg, device="meta")
    tshapes = _sds(params)
    jshapes = jax.eval_shape(lambda: jreg.init_params(jcfg, jax.random.PRNGKey(0)))
    for mesh in MESHES:
        tctx, jctx = _mesh_ctx(mesh)
        with tctx, jctx:
            tspec, jspec = treg.param_specs(tcfg), jreg.param_specs(jcfg)
            fsdp = tsh.fsdp_specs(tspec, params, min_dim=1024)
            assert fsdp == jsh.fsdp_specs(tspec, tshapes, min_dim=1024), mesh
            carried = _port_layout(jcfg, jsh.fsdp_specs(jspec, jshapes, min_dim=1024))
            stacked = _stacked_vectors(_port_layout(jcfg, jspec, drop=False), params)
            for path in stacked:
                leaf = _at(carried, path)
                assert _at(fsdp, path) == _at(tspec, path) and leaf in (
                    _at(tspec, path), ("fsdp",)), path
                _at(carried, path[:-1])[path[-1]] = _at(tspec, path)
            assert fsdp == carried, mesh
            for specs in (tspec, fsdp):
                opt = t_opt_specs(specs, params)
                jopt = j_opt_specs(specs, tshapes)
                assert opt == {"m": jopt["m"], "v": jopt["v"], "step": None}, mesh
            assert t_opt_specs(tspec, params)["m"] == _port_layout(
                jcfg, j_opt_specs(jspec, jshapes)["m"]), mesh
