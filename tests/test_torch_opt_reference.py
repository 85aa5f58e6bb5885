"""The JAX package's numbers for the optimizer's runs on the card.

``chip_smoke.py`` and ``tools/opt_phases.py`` import no jax, so they hold
the port's optimizer on the card to numbers that the JAX package computed on
the CPU and that this file writes:

    PYTHONPATH=src python tests/test_torch_opt_reference.py   # ~5 minutes

-> ``tests/data/torch_opt_jax_rows.json``:

* ``frontier``: ``repro.scenarios.runner.frontier`` over fleet_cost_stress and
  region_failover at scale 1.0 (the CLI's default pipeline: ``DEFAULT_SPACE``
  coarse at 0.1 x, the pooled survivors refined at 1.0 x), no spot-check: every
  coarse and refined row, each scenario's front (point ids) and hypervolume,
  the robust ids;
* ``evo``: ``frontier_search(["fleet_cost_stress"], algo="evo", scale=0.25,
  coarse_frac=0.4, budget=64, seed=0)`` with an endgame of one elite and two
  Adam steps (``EvoConfig(grad_elites=1, grad_steps=2)``): the evaluated
  points in order (and
  which of them the gradient endgame registered), the budget's ledger
  summary, the refined rows, fronts and hypervolume;
* ``learned``: fleet_cost_stress at 0.25 x (fig11's scenario and scale): the
  surrogate loss and its gradient at ``init_theta(0)``; ``train_policy`` for 3
  steps (the history and the trained ``theta``), its ``evaluate_trained`` row
  and its ``confirm`` verdict;
* ``learned50``: fig11's whole 50-step training at 0.25 x, its history and
  ``theta``, the row and the verdict (``tools/opt_phases.py`` holds the port
  to these);
* ``cli``: what ``python -m repro.launch.frontier`` returns and writes for
  the verify recipe's frontier smoke (``--scenario fleet_cost_stress --scale
  0.1 --coarse-frac 0.5 --spot-check 0 --learned --learn-steps 8``: its CSVs
  and ``frontier.json``), and its exit code and message for ``--algo nope``.

Under pytest the file's arguments are checked and the cheapest entry,
fleet_cost_stress's coarse rows, is recomputed with the JAX package and held
to the file, so the file cannot go stale.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REF = Path(__file__).resolve().parent / "data" / "torch_opt_jax_rows.json"

FRONTIER = dict(scenarios=["fleet_cost_stress", "region_failover"], scale=1.0,
                coarse_frac=0.1, spot_check=0)
# budget 64 reaches grad_min_budget, so the gradient endgame runs; its depth is
# cut to one elite and two Adam steps (the default two and six took 47 s of a
# 60 s phase on the card, PERF.md)
EVO = dict(scenarios=["fleet_cost_stress"], algo="evo", scale=0.25, coarse_frac=0.4,
           budget=64, seed=0, evo_config=dict(grad_elites=1, grad_steps=2))
LEARNED = dict(scenario="fleet_cost_stress", scale=0.25, steps=3, seed=0)
LEARNED50 = dict(scenario="fleet_cost_stress", scale=0.25, steps=50, seed=0)
OUT = "{OUT}"                      # the CLI's --out-dir, as the file spells it
CLI = [dict(name="smoke", argv=["--scenario", "fleet_cost_stress", "--scale", "0.1",
                                "--coarse-frac", "0.5", "--spot-check", "0", "--learned",
                                "--learn-steps", "8", "--out-dir", OUT]),
       dict(name="bad_algo", argv=["--algo", "nope"])]
# rows as in the fluid references; a hypervolume and a loss at the rows'
# tolerance; a gradient within 1e-3 of its leaf's largest entry; a short
# training's losses and weights at 1e-3; fig11's 50 steps at 1e-2 (its
# trajectory compounds 50 Adam steps of float32 sums); the evo candidates
# that the gradient endgame registers (float32 Adam results: on the CPU the
# port's land 2 ulps from JAX's, ROADMAP Queue 3) at 1e-5, every other
# candidate exactly; the CLI's printed numbers as the scenario CLIs'
TOLERANCES = dict(row_rtol=1e-4, slowdown_rtol=1e-3, hv_rtol=1e-4, loss_rtol=1e-4,
                  grad_leaf_frac=1e-3, history_rtol=1e-3, theta_atol=1e-3,
                  history50_rtol=1e-2, evo_grad_rtol=1e-5, cli_rtol=1e-3)


def _plain(x):
    """A JSON-ready copy: numpy numbers and arrays as Python ones."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _rows(rows: list) -> list:
    return [_plain({k: v for k, v in r.items() if k != "stage_wall_s"}) for r in rows]


def _result(res) -> dict:
    from repro.opt.search import _front_hypervolume
    return dict(
        points=_plain(res.points), coarse_scale=res.coarse_scale,
        coarse={n: _rows(r) for n, r in res.coarse.items()},
        refined={n: _rows(r) for n, r in res.refined.items()},
        fronts={n: [r["point_id"] for r in f] for n, f in res.fronts.items()},
        robust_ids=list(res.robust_ids),
        hypervolume={n: _front_hypervolume(r) for n, r in res.refined.items()},
        coarse_hypervolume={n: _front_hypervolume(r) for n, r in res.coarse.items()},
        budget=_plain(res.budget.summary()) if res.budget is not None else None)


def jax_frontier() -> dict:
    from repro.core.runspec import RunSpec
    from repro.scenarios.runner import frontier
    res, checks = frontier(FRONTIER["scenarios"], spot_check=FRONTIER["spot_check"],
                           coarse_frac=FRONTIER["coarse_frac"],
                           spec=RunSpec(scale=FRONTIER["scale"]))
    assert checks == []
    return _result(res)


def grad_point_ids(points: list, log: list) -> list:
    """The ids of the candidates the evo engine's gradient endgame
    registered, from its ``evo grad: refined point i -> {point}`` lines."""
    refined = {line.split(" -> ", 1)[1].rsplit(" on ", 1)[0] for line in log
               if line.startswith("evo grad: refined point")}
    return [i for i, p in enumerate(points) if str(p) in refined]


def jax_evo() -> dict:
    from repro.opt import EvoConfig, frontier_search
    kw = {k: v for k, v in EVO.items() if k not in ("scenarios", "evo_config")}
    kw["evo_config"] = EvoConfig(**EVO["evo_config"])
    log: list = []
    res = frontier_search(EVO["scenarios"], log=log.append, **kw)
    return dict(_result(res), grad_point_ids=grad_point_ids(res.points, log),
                generations=max(e["generation"] or 0 for e in res.budget.ledger))


def jax_coarse_rows(name: str) -> list:
    """One scenario's coarse stage of ``frontier`` alone."""
    from repro.core.runspec import RunSpec
    from repro.opt import DEFAULT_SPACE, evaluate_scenario
    scale = FRONTIER["scale"] * FRONTIER["coarse_frac"]
    return _rows(evaluate_scenario(name, DEFAULT_SPACE.points(), spec=RunSpec(scale=scale)))


def jax_loss_at_init() -> dict:
    """The surrogate loss and its gradient w.r.t. theta at init_theta(seed),
    built as train_policy builds it."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.core.eventsim import SimConfig
    from repro.core.policies import init_theta
    from repro.fleet.billing import apply_throttle
    from repro.opt.learned import make_loss
    from repro.opt.search import default_fleet
    from repro.scenarios import get_scenario
    sc = get_scenario(LEARNED["scenario"])
    spec = dataclasses.replace(sc.policy, kind="learned", theta=init_theta(LEARNED["seed"]))
    trace = apply_throttle(sc.build_trace(LEARNED["scale"]), sc.billing)
    sim = SimConfig(tick_s=sc.policy.tick_s)
    loss_fn, params0 = make_loss(trace, spec.to_jax(), sim=sim, dt=sim.tick_s,
                                 fleet=default_fleet(sc), billing=sc.billing)
    frozen = {k: v for k, v in params0.items() if k != "theta"}
    theta = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params0["theta"])
    val, grad = jax.jit(jax.value_and_grad(
        lambda t: loss_fn({**frozen, "theta": t})))(theta)
    return dict(loss=float(val), grad=_plain(jax.tree.map(np.asarray, grad)),
                ticks=int(np.ceil(sc.scaled_config(LEARNED["scale"]).duration_s
                                  / sc.policy.tick_s)),
                functions=trace.num_functions)


def jax_train(args: dict) -> dict:
    from repro.opt.learned import confirm, evaluate_trained, train_policy
    res = train_policy(args["scenario"], scale=args["scale"], steps=args["steps"],
                       seed=args["seed"])
    row = evaluate_trained(args["scenario"], res, scale=args["scale"])
    return dict(history=res.history, theta=_plain(res.policy.theta),
                row=_plain({k: v for k, v in row.items() if k != "stage_wall_s"}),
                confirm=_plain(confirm(args["scenario"], res, scale=args["scale"])))


def jax_cli(cli: dict) -> dict:
    """Run the JAX CLI in this process -> its exit code, standard error when
    it refuses (the run's own log carries walls), and what it wrote to its
    out-dir: the CSVs as text, frontier.json parsed."""
    import contextlib
    import io
    import tempfile

    from repro.launch.frontier import main
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "out"
        argv = [str(out_dir) if a == OUT else a for a in cli["argv"]]
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = main(argv)
        res = dict(rc=rc)
        if rc == 2:
            res["stderr"] = err.getvalue()
        if out_dir.exists():
            res["files"] = {p.name: p.read_text() for p in sorted(out_dir.glob("*.csv"))}
            res["frontier_json"] = json.loads((out_dir / "frontier.json").read_text())
    return res


def write() -> None:
    out = dict(about="numbers of repro.opt (JAX on the CPU) for the optimizer runs "
                     "chip_smoke.py and tools/opt_phases.py hold the port to; written by "
                     "python tests/test_torch_opt_reference.py",
               tolerances=TOLERANCES, frontier_args=FRONTIER, evo_args=EVO,
               learned_args=LEARNED, learned50_args=LEARNED50)
    out["frontier"] = jax_frontier()
    print("frontier", out["frontier"]["hypervolume"], out["frontier"]["robust_ids"], flush=True)
    out["evo"] = jax_evo()
    print("evo", out["evo"]["hypervolume"], len(out["evo"]["points"]), flush=True)
    out["learned"] = dict(jax_loss_at_init(), **jax_train(LEARNED))
    print("learned", out["learned"]["loss"], out["learned"]["history"], flush=True)
    out["learned50"] = jax_train(LEARNED50)
    print("learned50", out["learned50"]["history"][::10], flush=True)
    out["cli"] = [dict(c, **jax_cli(c)) for c in CLI]
    print("cli", [c["rc"] for c in out["cli"]], flush=True)
    REF.parent.mkdir(parents=True, exist_ok=True)
    REF.write_text(json.dumps(out, indent=1) + "\n")


@pytest.fixture(scope="module")
def ref():
    return json.loads(REF.read_text())


def test_reference_file_matches_the_jax_package(ref):
    assert ref["tolerances"] == TOLERANCES
    assert (ref["frontier_args"], ref["evo_args"]) == (FRONTIER, EVO)
    assert (ref["learned_args"], ref["learned50_args"]) == (LEARNED, LEARNED50)
    assert [{k: c[k] for k in CLI[0]} for c in ref["cli"]] == CLI
    assert [c["rc"] for c in ref["cli"]] == [0, 2]
    fr = ref["frontier"]
    assert set(fr["coarse"]) == set(fr["refined"]) == set(FRONTIER["scenarios"])
    assert len(ref["learned"]["history"]) == LEARNED["steps"] + 1
    assert len(ref["learned50"]["history"]) == LEARNED50["steps"] + 1
    assert ref["evo"]["budget"]["spent"] == EVO["budget"]
    assert ref["evo"]["grad_point_ids"]           # the budget reaches the endgame
    name = FRONTIER["scenarios"][0]
    got = jax_coarse_rows(name)
    want = fr["coarse"][name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-6, abs=1e-12), k
            else:
                assert g[k] == v, k


if __name__ == "__main__":
    sys.exit(write())
