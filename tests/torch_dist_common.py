"""The JAX package's rows at ``RunSpec(devices=N)`` for the port's sharded
tests (not a test module).

A test process holds a jax with one CPU device, and jax fixes its device
count when it starts; so the JAX side of a sharded hold runs in a
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, one
per test module (``jax_jobs``: a list of jobs in, a list of results out, as
JSON).  A job is a dict:

* ``{"kind": "chunked", "trace": T, "policy": {...}, "fleet": {...} | None,
  "dt", "num_nodes", "chunk_ticks", "spec": {...}}`` ->
  ``repro.core.simjax.simulate_chunked``'s row;
* ``{"kind": "points", "trace": T, "policy", "fleet", "points", "devices",
  "dt", "chunk_ticks"}`` -> ``repro.opt.evaluate_points``' rows;
* ``{"kind": "scenario", "name", "spec": {...}}`` -> ``run_scenario``'s rows;
* ``{"kind": "evaluate_scenario", "name", "points", "spec": {...}}``;
* ``{"kind": "cli", "module", "argv"}`` -> ``{"rc", "out"}`` of the CLI's
  ``main``;
* ``{"kind": "dryrun_cell", "arch", "smoke", "overrides", "shape", "mesh":
  [sizes, names]}`` -> ``jax_cell_figures``' dict: the JAX package's dry-run
  cell (``repro.launch.cells.build_cell``) compiled on that mesh of the
  forced host devices; with ``"shapes": {name: [seq_len, global_batch,
  kind]}`` those shapes join the JAX package's shape grid for the job, and
  with ``"collectives": true`` the dict also holds ``hlo_analysis``'
  ``collectives`` table and ``collective_bytes`` a device;
* ``{"kind": "model_mesh", "archs", "mesh": [sizes, names], "batch", "seq",
  "decode_steps", "seed", "out"}`` -> ``{"path": out}``: every arch's smoke
  config in float32 on that mesh, its parameters (the seeded init) and
  inputs (``torch_mesh_common.batch_arrays``) placed by their specs, its
  ``forward``, ``prefill`` and greedy ``decode_step``s jitted under
  ``use_mesh``; the outputs (and the greedy tokens) written to ``out``
  (``.npz``, keys ``arch/call``).

``T`` names a trace: ``{"kind": "events" | "rates", "config": {...},
"tick_s": s}``, plus ``"cluster_below": rps`` to cluster a rate trace.
The same dicts build the port's traces (``port_trace``), whose generators
are the JAX package's bit for bit.

    python tests/torch_dist_common.py < jobs.json   # what jax_jobs runs
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
FORCED_DEVICES = 8

# the 61-function trace of tests/test_sharding.py: prime F, so every device
# count above 1 pads the function axis
TC61 = dict(num_functions=61, duration_s=900.0, target_total_rps=8.0, seed=7)
EVENTS61 = {"kind": "events", "config": TC61}
RATES61 = {"kind": "rates", "config": TC61, "tick_s": 2.0}


def _build_trace(mod_trace, mod_cluster, t: dict):
    cfg = mod_trace.TraceConfig(**t["config"])
    if t["kind"] == "events":
        return mod_trace.synthesize(cfg)
    rt = mod_trace.synthesize_rates(cfg, tick_s=t["tick_s"])
    if "cluster_below" in t:
        rt = mod_cluster.cluster_functions(rt, below_rps=t["cluster_below"])
    return rt


def port_trace(t: dict):
    """The port's trace of a trace dict."""
    import repro_torch.core.trace as TT
    import repro_torch.scenarios.cluster as TC
    return _build_trace(TT, TC, t)


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def hlo_dot_flops(txt: str) -> float:
    """The dot and convolution FLOPs of optimized HLO text, through fusions,
    calls and conditionals, and through loops by their trip count: the
    matmul part of ``repro.launch.hlo_analysis``' count."""
    import re

    from repro.launch.hlo_analysis import HloCostModel
    model = HloCostModel(txt)
    memo: dict[str, float] = {}

    def comp(name: str) -> float:
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        ops = model.comps.get(name, [])
        shapes = {op.name: op.type_str for op in ops}
        total = 0.0
        for op in ops:
            if op.opcode == "dot":
                total += model._dot_flops(op, shapes)
            elif op.opcode == "convolution":
                total += model._conv_flops(op, shapes)
            elif op.opcode == "while":
                m = re.search(r"known_trip_count\D*?(\d+)", op.attrs)
                trip = float(m.group(1)) if m else 1.0
                for key in ("body", "condition"):
                    total += trip * sum(comp(c) for c in model._called(op.attrs, key))
            else:
                keys = {"fusion": ("calls",), "call": ("to_apply", "called_computations"),
                        "async-start": ("to_apply", "called_computations"),
                        "conditional": ("branch_computations", "true_computation",
                                        "false_computation")}.get(op.opcode, ())
                for key in keys:
                    total += sum(comp(c) for c in model._called(op.attrs, key))
        memo[name] = total
        return total
    return comp("__entry__")


def jax_cell_figures(job: dict) -> dict:
    """The JAX package's dry-run cell compiled on a mesh of auto axes ->
    ``{"argument_bytes"`` (``memory_analysis``, per device),
    ``"dot_flops"`` (``hlo_dot_flops``), ``"n_microbatches"``, ``"donate"``,
    ``"pruned"`` / ``"pruned_bytes"}``: the argument leaves the compiled
    program does not take (XLA drops an unused argument) and their bytes a
    device.  A smoke or a full config, with ``overrides``."""
    import math

    import jax
    from jax.sharding import AxisType

    from repro.configs import get_config, get_smoke_config
    from repro.configs.base import SHAPES, ShapeConfig
    from repro.launch import cells as jcells
    from repro.launch.hlo_analysis import analyze_hlo_text
    for name, (seq, rows, kind) in job.get("shapes", {}).items():
        SHAPES[name] = ShapeConfig(name, seq, rows, kind)
    cfg = (get_smoke_config if job["smoke"] else get_config)(job["arch"])
    cfg = cfg.replace(**job.get("overrides", {}))
    sizes, names = job["mesh"]
    mesh = jax.make_mesh(tuple(sizes), tuple(names), axis_types=(AxisType.Auto,) * len(sizes))
    fn, args, donate = jcells.build_cell(cfg, job["shape"], mesh)
    comp = jax.jit(fn, donate_argnums=donate).lower(*args).compile()
    shape = SHAPES[job["shape"]]
    kept = set(comp._executable._kept_var_idx)
    leaves = jax.tree_util.tree_flatten_with_path(args)[0]
    pruned = [(jax.tree_util.keystr(p), sd) for i, (p, sd) in enumerate(leaves) if i not in kept]
    extra = {}
    if job.get("collectives"):
        hlo = analyze_hlo_text(comp.as_text())
        extra = {"collectives": hlo["collectives"],
                 "collective_bytes": hlo["collective_bytes_per_device"]}
    return {**extra, "argument_bytes": comp.memory_analysis().argument_size_in_bytes,
            "pruned": [p for p, _ in pruned],
            "pruned_bytes": sum(math.prod(sd.sharding.shard_shape(sd.shape)) * sd.dtype.itemsize
                                for _, sd in pruned),
            "dot_flops": hlo_dot_flops(comp.as_text()),
            "n_microbatches": jcells.default_microbatches(cfg, shape, mesh)
            if shape.kind == "train" else 1,
            "donate": list(donate)}


def jax_model_mesh(job: dict) -> dict:
    """The JAX package's sharded smoke runs of ``job["archs"]`` (module
    docstring) -> ``{"path": job["out"]}``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import get_smoke_config
    from repro.distributed import sharding as jsh
    from repro.models import registry as jreg
    from torch_mesh_common import F32, batch_arrays
    sizes, names = job["mesh"]
    mesh = jax.make_mesh(tuple(sizes), tuple(names), axis_types=(AxisType.Auto,) * len(sizes))

    def is_spec(leaf):
        return leaf is None or isinstance(leaf, tuple)

    def put(tree, specs):
        def one(x, sp):
            spec = jsh.sanitize_spec(jsh.logical_to_spec(sp or (), mesh), x.shape, mesh)
            return jax.device_put(x, NamedSharding(mesh, spec))
        return jax.tree.map(one, tree, specs, is_leaf=lambda leaf: is_spec(leaf)
                            and not isinstance(leaf, jax.Array))

    out = {}
    b, steps = job["batch"], job["decode_steps"]
    for arch in job["archs"]:
        cfg = get_smoke_config(arch).replace(**F32)
        params = jax.jit(functools.partial(jreg.init_params, cfg))(
            jax.random.PRNGKey(job["seed"]))
        arrays = batch_arrays(cfg, b, job["seq"], job["seed"])
        s = job["seq"] + (cfg.num_patches if cfg.family == "vlm" else 0)
        with jsh.use_mesh(mesh):
            pspecs, cspecs = jreg.param_specs(cfg), jreg.cache_specs(cfg)
            bspecs = {"tokens": ("batch", None), "patch_embeds": ("batch", None, "embed"),
                      "enc_embeds": ("batch", None, "embed")}
            batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, jsh.sanitize_spec(
                jsh.logical_to_spec(bspecs[k], mesh), v.shape, mesh)))
                for k, v in arrays.items() if k in bspecs}
            params = put(params, pspecs)
            cache = put(jreg.init_cache(cfg, b, s + steps), cspecs)
            fwd = jax.jit(lambda p, bt: jreg.forward(cfg, p, bt)[0])(params, batch)
            pre, cache = jax.jit(functools.partial(jreg.prefill, cfg))(params, cache, batch)
            step = jax.jit(functools.partial(jreg.decode_step, cfg))
            out[f"{arch}/forward"], out[f"{arch}/prefill"] = fwd, pre
            tok = jnp.argmax(fwd[:, -1:], axis=-1).astype(jnp.int32)
            feed = []
            for i in range(steps):
                feed.append(tok)
                lg, cache = step(params, cache, tok, jnp.full((b,), s + i, jnp.int32))
                out[f"{arch}/decode{i}"] = lg
                tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
            out[f"{arch}/feed"] = jnp.concatenate(feed, axis=1)
    np.savez(job["out"], **{k: np.asarray(v) for k, v in out.items()})
    return {"path": job["out"]}


def _run_job(job: dict):
    """One job, under the forced host devices (the subprocess side)."""
    from repro.core.runspec import RunSpec
    kind = job["kind"]
    if kind == "dryrun_cell":
        return jax_cell_figures(job)
    if kind == "model_mesh":
        return jax_model_mesh(job)
    if kind == "cli":
        import importlib
        main = importlib.import_module(job["module"]).main
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(job["argv"])
        return {"rc": rc, "out": out.getvalue()}
    if kind == "scenario":
        from repro.scenarios import run_scenario
        return run_scenario(job["name"], spec=RunSpec(**job["spec"]))
    if kind == "evaluate_scenario":
        from repro.opt import evaluate_scenario
        return evaluate_scenario(job["name"], job["points"], spec=RunSpec(**job["spec"]))
    import repro.core.simjax as J
    import repro.core.trace as JT
    import repro.scenarios.cluster as JC
    trace = _build_trace(JT, JC, job["trace"])
    fleet = None if job.get("fleet") is None else J.JaxFleet(**job["fleet"])
    policy = J.JaxPolicy(**job["policy"])
    if kind == "chunked":
        return J.simulate_chunked(trace, policy, dt=job["dt"], num_nodes=job["num_nodes"],
                                  fleet=fleet, chunk_ticks=job["chunk_ticks"],
                                  spec=RunSpec(**job["spec"]))
    if kind == "points":
        from repro.opt import evaluate_points
        return evaluate_points(trace, policy, fleet, job["points"], dt=job["dt"],
                               chunk_ticks=job["chunk_ticks"], devices=job["devices"])
    raise ValueError(f"unknown job kind {kind!r}")


def jax_jobs(jobs: list[dict], timeout: float = 600.0) -> list:
    """Every job's result from the JAX package, in one subprocess that sees
    ``FORCED_DEVICES`` host devices."""
    return start_jax_jobs(jobs)(timeout)


def start_jax_jobs(jobs: list[dict]):
    """:func:`jax_jobs` started in the background -> a function of a timeout
    that waits for the subprocess and returns its results."""
    import tempfile
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={FORCED_DEVICES}")
    files = [tempfile.TemporaryFile("w+") for _ in range(3)]
    files[0].write(json.dumps(jobs))
    files[0].seek(0)
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve())],
                            stdin=files[0], stdout=files[1], stderr=files[2], text=True,
                            env=env, cwd=str(ROOT))

    def wait(timeout: float = 600.0) -> list:
        try:
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
            out, err = (f.seek(0) or f.read() for f in files[1:])
            for f in files:
                f.close()
        if proc.returncode != 0:
            raise RuntimeError(f"the JAX subprocess failed ({proc.returncode}):\n"
                               f"{err[-4000:]}")
        return json.loads(out.strip().splitlines()[-1])
    return wait


def _main() -> int:
    import jax
    if len(jax.devices()) < FORCED_DEVICES:
        raise RuntimeError(f"expected {FORCED_DEVICES} host devices, got {jax.devices()}")
    jobs = json.loads(sys.stdin.read())
    results = [_jsonable(_run_job(job)) for job in jobs]
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
