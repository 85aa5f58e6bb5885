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
  ``main``.

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


def _run_job(job: dict):
    """One job, under the forced host devices (the subprocess side)."""
    from repro.core.runspec import RunSpec
    kind = job["kind"]
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
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={FORCED_DEVICES}")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve())],
                          input=json.dumps(jobs), capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the JAX subprocess failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


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
