"""NSGA-II primitives: non-dominated sort, crowding distance, simulated
binary crossover (SBX), polynomial mutation, tournament selection.

A copy of ``repro.opt.evo.nsga`` (numpy only), kept here so that the port
imports nothing of ``repro``; the two must stay identical in behaviour.

Pure numpy over (n, m) objective matrices (every objective MINIMIZED) and
flat gene vectors — no jax, no simulator: the engine owns the mapping from
gene vectors to simulated rows.  Every stochastic operator takes an
explicit ``numpy.random.Generator``; there is deliberately no module-level
randomness anywhere in this package, so a seeded search replays
bit-for-bit.

Rows with any non-finite objective (the zero-completion NaN convention —
a candidate whose shrunk trace completed nothing) are quarantined in a
final worst front with zero crowding: they lose every selection
tournament but never crash the sort.
"""

from __future__ import annotations

import numpy as np


def non_dominated_sort(F: np.ndarray) -> tuple[np.ndarray, list]:
    """Fast non-dominated sort of an (n, m) objective matrix (minimize).

    Returns ``(ranks, fronts)``: ``ranks[i]`` is the 0-based front index of
    row i, ``fronts`` the list of index arrays front-by-front.  Non-finite
    rows land in one extra trailing front.
    """
    F = np.asarray(F, dtype=float)
    if F.ndim != 2:
        raise ValueError(f"objective matrix must be 2-D, got shape {F.shape}")
    n = F.shape[0]
    ranks = np.full(n, -1, dtype=int)
    finite = np.isfinite(F).all(axis=1)
    idx = np.flatnonzero(finite)
    fronts: list = []
    if idx.size:
        G = F[idx]
        k = idx.size
        # dom[i, j]: i dominates j  (<= everywhere, < somewhere)
        le = (G[:, None, :] <= G[None, :, :]).all(axis=2)
        lt = (G[:, None, :] < G[None, :, :]).any(axis=2)
        dom = le & lt
        n_dominators = dom.sum(axis=0)
        assigned = np.zeros(k, dtype=bool)
        level = 0
        while not assigned.all():
            cur = np.flatnonzero((n_dominators == 0) & ~assigned)
            if cur.size == 0:       # cycles are impossible; guard anyway
                cur = np.flatnonzero(~assigned)
            fronts.append(idx[cur])
            ranks[idx[cur]] = level
            assigned[cur] = True
            # retire the current front's domination edges
            n_dominators = n_dominators - dom[cur].sum(axis=0)
            n_dominators[assigned] = -1
            level += 1
    bad = np.flatnonzero(~finite)
    if bad.size:
        fronts.append(bad)
        ranks[bad] = len(fronts) - 1
    return ranks, fronts


def crowding_distance(F: np.ndarray, front: np.ndarray) -> np.ndarray:
    """Crowding distance of one front's rows (index array into ``F``):
    boundary points get ``inf``, interior points the normalized perimeter
    of their objective-space neighbor box.  Non-finite rows get 0."""
    F = np.asarray(F, dtype=float)
    front = np.asarray(front, dtype=int)
    k = front.size
    dist = np.zeros(k)
    if k == 0:
        return dist
    G = F[front]
    ok = np.isfinite(G).all(axis=1)
    if not ok.any():
        return dist
    for m in range(G.shape[1]):
        col = G[:, m]
        order = np.argsort(col, kind="stable")
        order = order[ok[order]]
        if order.size < 2:
            continue
        span = col[order[-1]] - col[order[0]]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span <= 0:
            continue
        gaps = (col[order[2:]] - col[order[:-2]]) / span
        dist[order[1:-1]] = dist[order[1:-1]] + gaps
    return dist


def nsga_rank(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(ranks, crowding)`` over the whole matrix — the NSGA-II fitness:
    lower rank wins; within a rank, larger crowding wins."""
    ranks, fronts = non_dominated_sort(F)
    crowd = np.zeros(len(F))
    for front in fronts:
        crowd[front] = crowding_distance(F, front)
    return ranks, crowd


def tournament_pick(rng: np.random.Generator, ranks: np.ndarray,
                    crowd: np.ndarray, pool: np.ndarray,
                    k: int = 2) -> int:
    """Binary (size-``k``) tournament over ``pool`` indices: best rank,
    ties broken by crowding, then by the rng."""
    pool = np.asarray(pool, dtype=int)
    picks = pool[rng.integers(0, pool.size, size=max(2, k))]
    best = picks[0]
    for c in picks[1:]:
        if (ranks[c] < ranks[best]
                or (ranks[c] == ranks[best] and crowd[c] > crowd[best])):
            best = c
    return int(best)


def sbx_crossover(rng: np.random.Generator, a: np.ndarray, b: np.ndarray,
                  lo: np.ndarray, hi: np.ndarray, eta: float = 12.0,
                  p_cx: float = 0.9) -> tuple[np.ndarray, np.ndarray]:
    """Simulated binary crossover (Deb & Agrawal): per-gene spread factor
    beta with density ~ beta^eta, children clipped to [lo, hi].  Genes
    cross with probability ``p_cx`` each; otherwise both children inherit
    the parents' values."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    u = rng.random(a.shape)
    beta = np.where(u <= 0.5,
                    (2.0 * u) ** (1.0 / (eta + 1.0)),
                    (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (eta + 1.0)))
    cross = rng.random(a.shape) < p_cx
    beta = np.where(cross, beta, 1.0)
    c1 = 0.5 * ((1.0 + beta) * a + (1.0 - beta) * b)
    c2 = 0.5 * ((1.0 - beta) * a + (1.0 + beta) * b)
    return np.clip(c1, lo, hi), np.clip(c2, lo, hi)


def polynomial_mutation(rng: np.random.Generator, x: np.ndarray,
                        lo: np.ndarray, hi: np.ndarray, eta: float = 20.0,
                        p_mut: float | None = None) -> np.ndarray:
    """Polynomial mutation (Deb): each gene mutates with probability
    ``p_mut`` (default 1/n) by a bounded perturbation whose density
    concentrates near the parent for large ``eta``.  Output is clipped to
    [lo, hi] — mutation can NEVER leave the declared bounds."""
    x = np.asarray(x, dtype=float)
    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    n = x.size
    if p_mut is None:
        p_mut = 1.0 / max(n, 1)
    span = np.maximum(hi - lo, 1e-12)
    u = rng.random(n)
    # distance-to-bound terms keep the perturbation inside the box
    d_lo = (x - lo) / span
    d_hi = (hi - x) / span
    left = u < 0.5
    pw = 1.0 / (eta + 1.0)
    dq_l = (2.0 * u + (1.0 - 2.0 * u)
            * (1.0 - d_lo) ** (eta + 1.0)) ** pw - 1.0
    dq_r = 1.0 - (2.0 * (1.0 - u) + 2.0 * (u - 0.5)
                  * (1.0 - d_hi) ** (eta + 1.0)) ** pw
    delta = np.where(left, dq_l, dq_r)
    mutate = rng.random(n) < p_mut
    y = np.where(mutate, x + delta * span, x)
    return np.clip(y, lo, hi)
