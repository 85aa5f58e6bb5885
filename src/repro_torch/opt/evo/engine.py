"""The NSGA-II-style population search behind ``frontier_search(algo="evo")``.

Where the grid ENUMERATES a cartesian product whose cost is exponential in
the axis count, this engine SEARCHES: a population of candidate
configurations evolves under non-dominated sorting + crowding selection,
simulated-binary crossover and polynomial mutation inside the
AxisSpec-clipped gene boxes (``repro_torch.opt.evo.genome``), with every
generation evaluated as ONE batched chunked run per scenario
(``evaluate_scenario`` — structural ``cell_count`` genes regroup the
per-cell trace partition exactly as grid sweep points do).  The simulator
is cheap; the population exploits that.

Search effort is governed by an ``EvalBudget`` in SIMULATED
CANDIDATE-SCENARIO PAIRS — the same unit the grid pays (``grid_budget``
prices the coarse grid's deduped simulations), so hypervolume-at-budget is
a like-for-like comparison.  The run is seeded from one cheap coarse-grid
generation (evenly strided through the product order, so extremes are
covered), evolves until the budget is exhausted, optionally spends an
endgame slice on GRADIENT refinement of elite individuals' continuous
policy leaves (``opt.learned.refine_leaves``: autograd through the eager
fluid step, charged at 2 pairs per step for the backward pass), and finally
re-runs the per-scenario epsilon-survivors at full scale — the same
coarse -> survive -> refine -> reduce contract as the grid, returning the
same ``FrontierResult`` so the oracle-demotion spot-check gate applies
UNCHANGED.  Candidates listed in ``forbidden`` (e.g. config classes a
previous spot-check demoted) are masked out of seeding and offspring
generation alike.

Every generation reports its per-scenario front hypervolume through the
``RunTelemetry`` hooks (``evo_generation`` events), so convergence is
observable in ``frontier_out/telemetry.json``.

The port of ``repro.opt.evo.engine``: the same loop, draws and budget, with
every evaluation and gradient step on ``device`` (CUDA by default, resolved
once; the CPU only when named).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core.policy_api import get_family
from repro_torch.core.runspec import RunSpec
from repro_torch.device import resolve_device
from repro_torch.fleet.billing import BillingProfile
from repro_torch.opt.evo.budget import EvalBudget
from repro_torch.opt.evo.genome import Genome, genome_from_space, point_key
from repro_torch.opt.evo.nsga import (nsga_rank, polynomial_mutation,
                                      sbx_crossover, tournament_pick)
from repro_torch.opt.frontier import (X_DEFAULT, Y_DEFAULT, epsilon_survivors,
                                      pareto_front, robust_front)
from repro_torch.opt.space import DEFAULT_SPACE, SearchSpace
from repro_torch.scenarios.registry import get_scenario, list_scenarios
from repro_torch.scenarios.spec import Scenario


@dataclasses.dataclass(frozen=True)
class EvoConfig:
    """Population-optimizer knobs (the defaults are what the CI gate and
    the fig15 benchmark run)."""
    population: int = 16          # offspring per generation (upper bound)
    seed_frac: float = 0.5        # budget share of the coarse-grid seeding
    target_generations: int = 3   # sizing aim for the evolution phase
    max_generations: int = 64     # hard stop (budget normally binds first)
    elite_cap: int = 32           # parent-pool truncation (rank, crowding)
    tournament: int = 2
    eta_sbx: float = 12.0         # SBX spread (higher = children nearer)
    eta_mut: float = 20.0         # mutation concentration
    p_cx: float = 0.9
    p_mut: Optional[float] = None  # per-gene mutation prob (None = 1/n)
    # per-gene prob of snapping an offspring gene to a grid rung value —
    # walks the grid graph around the elites, recovering product corners
    # the strided seeding skipped (a pure-continuous mutation almost never
    # re-hits an exact unseeded rung combination)
    p_lattice: float = 0.3
    grad_steps: int = 6           # Adam steps per refined elite (0 = off)
    grad_elites: int = 2
    grad_lr: float = 0.08
    # gradient refinement only fires on budgets where its charge (2 pairs
    # per step — forward + backward) is a minority share
    grad_min_budget: int = 64


def grid_budget(space: SearchSpace,
                scenarios: Sequence[Union[str, Scenario]]) -> int:
    """What the coarse grid would pay, in simulated candidate-scenario
    pairs: per scenario, the number of DISTINCT effective configurations
    (``opt.search._effective_key`` — inert axes collapsed) in the space's
    cartesian product.  ``evo_search``'s default budget, making
    ``algo="evo"`` equal-footed with ``algo="grid"`` by construction."""
    from repro_torch.opt.search import _effective_key
    pts = space.points()
    total = 0
    for s in scenarios:
        sc = get_scenario(s) if isinstance(s, str) else s
        fam = get_family(sc.policy.kind).name
        total += len({_effective_key(p, fam) for p in pts})
    return total


def evo_search(scenarios: Optional[Sequence[Union[str, Scenario]]] = None,
               space: SearchSpace = DEFAULT_SPACE, scale: float = 1.0,
               coarse_frac: float = 0.1, eps: float = 0.15,
               survivor_cap: int = 12,
               billing: Union[str, BillingProfile, None] = None,
               log: Optional[Callable[[str], None]] = None,
               telemetry=None, devices: int = 0, cluster: float = 0.0, *,
               budget: Optional[int] = None, seed: int = 0,
               config: EvoConfig = EvoConfig(), refine: bool = True,
               forbidden: Sequence[dict] = (),
               evaluate: Optional[Callable] = None, device=None):
    """Population search over ``space`` across ``scenarios``; returns the
    same ``FrontierResult`` as ``frontier_search`` (which dispatches here
    for ``algo="evo"``).

    The SEARCH stage runs at ``coarse_frac * scale`` (clamped like the
    grid's coarse stage) under ``budget`` total candidate-scenario pairs
    (default: the grid's own cost, ``grid_budget``).  ``refine=False``
    skips the full-scale survivor pass and reports the search-stage rows
    as the refined set — the hypervolume-at-budget benchmark uses this
    with ``coarse_frac=1.0`` so every simulated pair is at the comparison
    scale.  ``forbidden`` masks candidate config classes (dicts of knob
    values) out of seeding and variation — the re-entry hook for config
    classes the oracle previously demoted.  ``evaluate`` overrides the
    simulator call (tests inject analytic evaluators); it must return
    ``evaluate_scenario``-shaped rows (X/Y metric keys + ``sims``).  The
    simulator calls and the gradient refinement run on ``device`` (CUDA by
    default; an injected ``evaluate`` needs none until the refinement).
    """
    from repro_torch.opt.search import (MIN_COARSE_SCALE, FrontierResult,
                                        _front_hypervolume)
    t_start = time.time()
    say = log or (lambda s: None)
    tel = telemetry.emit if telemetry is not None else (lambda *a, **k: None)
    if scenarios is None:
        scenarios = [n for n in list_scenarios()
                     if not get_scenario(n).rate_trace]
    scs: dict[str, Scenario] = {}
    for s in scenarios:
        sc = get_scenario(s) if isinstance(s, str) else s
        scs[sc.name] = sc
    if not scs:
        raise ValueError("evo_search needs at least one scenario")
    S = len(scs)
    families = sorted({get_family(sc.policy.kind).name
                       for sc in scs.values()})
    genome = genome_from_space(space, families)
    if budget is None:
        budget = grid_budget(space, scs.values())
    bud = EvalBudget(budget)
    rng = np.random.default_rng(seed)
    coarse_scale = min(max(scale * coarse_frac, MIN_COARSE_SCALE), scale)
    run_spec = RunSpec(billing=billing, devices=devices, cluster=cluster)
    if evaluate is None:
        from repro_torch.opt.search import evaluate_scenario
        device = resolve_device(device)

        def evaluate(sc, pts, scale_):
            return evaluate_scenario(sc, pts,
                                     spec=run_spec.replace(scale=scale_),
                                     device=device)

    # -- candidate registry ------------------------------------------------
    points: list[dict] = []
    key_to_pid: dict[tuple, int] = {}
    rows: dict[str, dict[int, dict]] = {name: {} for name in scs}
    forbidden_keys = {point_key(genome.project(p)) for p in forbidden}

    def register(pt: dict) -> Optional[int]:
        k = point_key(pt)
        if k in key_to_pid or k in forbidden_keys:
            return None
        key_to_pid[k] = len(points)
        points.append(pt)
        return key_to_pid[k]

    def eval_generation(pids: Sequence[int], stage: str, gen: int) -> None:
        pts = [points[i] for i in pids]
        for name, sc in scs.items():
            out = evaluate(sc, pts, coarse_scale)
            bud.spend(out[0]["sims"] if out else 0, stage, name, gen)
            for pid, r in zip(pids, out):
                r["point_id"] = pid
                rows[name][pid] = r
            tel("evo_generation", scenario=name, generation=gen,
                stage=stage, new_points=len(pts),
                sims=out[0]["sims"] if out else 0,
                budget_spent=bud.spent, budget_total=bud.total,
                hypervolume=_front_hypervolume(list(rows[name].values())))
        say(f"evo gen {gen} ({stage}): {len(pids)} candidates, "
            f"budget {bud.spent}/{bud.total}")

    def objective_matrix(name: str) -> np.ndarray:
        F = np.full((len(points), 2), np.inf)
        for pid, r in rows[name].items():
            x = r.get(X_DEFAULT, np.nan)
            y = r.get(Y_DEFAULT, np.nan)
            if np.isfinite(x) and np.isfinite(y):
                F[pid] = (x, y)
        return F

    def combined_fitness() -> tuple[np.ndarray, np.ndarray, dict]:
        """Cross-scenario NSGA fitness: a candidate's rank is its BEST
        per-scenario front rank (specialists of any scenario and robust
        all-rounders both score well — mirroring the grid's pooled
        survivor union), crowding its best spread."""
        n = len(points)
        best_rank = np.full(n, np.inf)
        best_crowd = np.zeros(n)
        per_rank: dict[str, np.ndarray] = {}
        for name in scs:
            ranks, crowd = nsga_rank(objective_matrix(name))
            # the quarantine front (non-finite rows) must not count as a
            # real rank: push it to inf so an everywhere-NaN candidate
            # never wins a tournament
            finite = np.isfinite(objective_matrix(name)).all(axis=1)
            r = np.where(finite, ranks.astype(float), np.inf)
            per_rank[name] = r
            better = r < best_rank
            best_crowd = np.where(better, crowd, best_crowd)
            best_rank = np.minimum(best_rank, r)
            same = r == best_rank
            best_crowd = np.where(same, np.maximum(best_crowd, crowd),
                                  best_crowd)
        return best_rank, best_crowd, per_rank

    # -- generation 0: one cheap coarse-grid seeding ----------------------
    seen: set = set()
    cands: list[dict] = []
    for p in space.points():
        q = genome.project(p)
        k = point_key(q)
        if k not in seen and k not in forbidden_keys:
            seen.add(k)
            cands.append(q)
    cap0 = bud.remaining // S
    if cap0 < 2:
        raise ValueError(
            f"budget {budget} cannot seed {S} scenario(s): at least "
            f"{2 * S} candidate-scenario pairs are needed")
    k0 = min(len(cands), max(2, int(round(config.seed_frac * budget)) // S),
             cap0)
    # per-gene grid rung values (variation space): corner seeds + lattice
    # mutation both draw from these
    rungs = [np.unique([genome.encode(c)[gi] for c in cands])
             for gi in range(len(genome.genes))] if cands else []
    # corner-first seeding: on the monotone landscapes grids are built
    # for, the per-scenario optima sit at EXTREME rung combinations — a
    # linspace stride through product order walks the interior and skips
    # most corners, so enumerate the 2^k corner candidates first (seeded
    # shuffle when they exceed the seed allowance) and fill the remainder
    # with the evenly-strided interior
    seed_vecs: list[np.ndarray] = []
    if rungs and len(genome.genes) <= 10:
        import itertools
        corners = [np.asarray(c, dtype=float) for c in
                   itertools.product(*[(r[0], r[-1]) for r in rungs])]
        seed_vecs = [corners[i] for i in rng.permutation(len(corners))]
    idx = np.unique(np.linspace(0, len(cands) - 1, k0).round().astype(int))
    # seeds ride the same encode/decode lattice as offspring, so a later
    # variation landing on a seed value shares its key (no wasted re-sim)
    seed_vecs += [genome.encode(cands[i]) for i in idx]
    pids = []
    for v in seed_vecs:
        if len(pids) >= k0:
            break
        pid = register(genome.decode(v))
        if pid is not None:
            pids.append(pid)
    eval_generation(pids, "seed", 0)

    # -- evolution ---------------------------------------------------------
    lo, hi = genome.lo, genome.hi
    p_mut = config.p_mut if config.p_mut is not None \
        else 1.0 / max(len(genome.genes), 1)
    P_nom = max(2, int(np.ceil(max(budget // S - k0, 1)
                               / max(config.target_generations, 1))))
    grad_done = config.grad_steps <= 0 or budget < config.grad_min_budget
    gen = 0
    while gen < config.max_generations:
        gen += 1
        cap = bud.remaining // S
        if cap < 1:
            break
        best_rank, best_crowd, per_rank = combined_fitness()
        order = np.lexsort((-best_crowd, best_rank))
        pool = np.asarray([i for i in order if np.isfinite(best_rank[i])][
            :config.elite_cap], dtype=int)
        if pool.size == 0:
            pool = np.arange(len(points))

        batch: list[int] = []
        if not grad_done and cap <= P_nom + config.population:
            # endgame: spend a slice on gradient refinement of elites
            grad_done = True
            for pid in _grad_elite_ids(pool, best_rank, best_crowd,
                                       config.grad_elites):
                cost = 2 * config.grad_steps   # forward + backward per step
                if not bud.can_afford(cost + S):
                    break
                name = min(scs, key=lambda nm: per_rank[nm][pid])
                refined = _refine_elite(scs[name], points[pid], genome,
                                        coarse_scale, config, billing,
                                        device=device)
                bud.spend(cost, "grad", name, gen)
                new_pid = register(genome.decode(genome.encode(refined)))
                if new_pid is not None:
                    batch.append(new_pid)
                    say(f"evo grad: refined point {pid} -> "
                        f"{points[new_pid]} on {name}")

        P = min(config.population, P_nom, bud.remaining // S)
        attempts = 0
        while len(batch) < P and attempts < 30 * P:
            attempts += 1
            i = tournament_pick(rng, best_rank, best_crowd, pool,
                                config.tournament)
            j = tournament_pick(rng, best_rank, best_crowd, pool,
                                config.tournament)
            c1, c2 = sbx_crossover(rng, genome.encode(points[i]),
                                   genome.encode(points[j]), lo, hi,
                                   eta=config.eta_sbx, p_cx=config.p_cx)
            for c in (c1, c2):
                if len(batch) >= P:
                    break
                c = polynomial_mutation(rng, c, lo, hi, eta=config.eta_mut,
                                        p_mut=p_mut)
                if rungs and config.p_lattice > 0:
                    # walk the grid graph around the elites: snapped genes
                    # let offspring land exactly on product corners the
                    # strided seeding skipped (dedup makes re-hits free)
                    for gi in np.flatnonzero(
                            rng.random(len(c)) < config.p_lattice):
                        c[gi] = rungs[gi][rng.integers(len(rungs[gi]))]
                pid = register(genome.decode(c))
                if pid is not None:
                    batch.append(pid)
            if attempts > 10 * P and len(batch) < P:
                # random immigrant: small discrete spaces exhaust the
                # neighborhood of the elites long before the budget
                pid = register(genome.decode(rng.uniform(lo, hi)))
                if pid is not None:
                    batch.append(pid)
        if not batch:
            say(f"evo gen {gen}: candidate space exhausted "
                f"({len(points)} distinct points)")
            break
        eval_generation(batch, "evolve", gen)

    # -- reduce (and optionally refine at full scale) ----------------------
    coarse = {name: [rows[name][pid] for pid in sorted(rows[name])]
              for name in scs}
    if refine and scale - coarse_scale > 1e-12:
        survivors = {name: {r["point_id"]
                            for r in epsilon_survivors(rs, eps=eps,
                                                       cap=survivor_cap)}
                     for name, rs in coarse.items()}
        ids = sorted(set().union(*survivors.values())
                     | set(robust_front(coarse)))
        refined: dict[str, list[dict]] = {}
        for name, sc in scs.items():
            out = evaluate(sc, [points[i] for i in ids], scale)
            bud.record(out[0]["sims"] if out else 0, "refine", name)
            for r, pid in zip(out, ids):
                r["point_id"] = pid
            refined[name] = out
            say(f"evo refine {name}: {len(ids)} survivors at {scale}x")
    else:
        refined = {name: list(rs) for name, rs in coarse.items()}
    fronts = {name: pareto_front(rs) for name, rs in refined.items()}
    robust_ids = robust_front(refined)
    tel("evo_done", generations=gen, points=len(points),
        robust_points=len(robust_ids), budget=bud.summary(),
        wall_s=round(time.time() - t_start, 3))
    say(f"evo done: {len(points)} candidates over {gen} generation(s), "
        f"budget {bud.spent}/{bud.total}, robust {len(robust_ids)}")
    return FrontierResult(space=space, points=points, scale=scale,
                          coarse_scale=coarse_scale, coarse=coarse,
                          refined=refined, fronts=fronts,
                          robust_ids=robust_ids,
                          wall_s=time.time() - t_start, billing=billing,
                          devices=devices, cluster=cluster,
                          algo="evo", budget=bud)


def _grad_elite_ids(pool: np.ndarray, ranks: np.ndarray, crowd: np.ndarray,
                    k: int) -> list[int]:
    order = sorted(pool.tolist(), key=lambda i: (ranks[i], -crowd[i]))
    return [int(i) for i in order[:max(k, 0)]]


def _refine_elite(sc: Scenario, point: dict, genome: Genome, scale: float,
                  config: EvoConfig, billing, *, device=None) -> dict:
    """Gradient-refine one elite's continuous policy genes on ``sc`` via
    the existing ``opt.learned`` machinery (autograd through the eager
    fluid step, on ``device``)."""
    from repro_torch.opt.learned import refine_leaves
    fam = get_family(sc.policy.kind)
    axes = [g.name for g in genome.genes
            if not g.fleet and not g.integer and g.name in fam.axis_names()]
    if not axes:
        return dict(point)
    return refine_leaves(sc, point, axes=axes, scale=scale,
                         steps=config.grad_steps, lr=config.grad_lr,
                         billing=billing, device=device)
