"""The cell router: weighted origin split, spill overflow, failover flux.

Routing is expressed as a (C, C) row-stochastic FLUX MATRIX M, where
``M[c, d]`` is the fraction of traffic originating at cell c that is
served by cell d this tick:

* an ALIVE cell keeps ``1 - s_c`` of its own traffic and spills ``s_c``
  (its overflow fraction, gated by the spill threshold) to warm siblings,
  distributed proportionally to their free warm slots — "the cheapest warm
  sibling" in fluid form;
* a DEAD cell's whole row is the failover distribution — survivors ordered
  by the same ``route_skew`` preference the origin weights use.

Every row sums to exactly 1 (mass conservation), so routing an arrival
matrix through M redistributes, never creates or destroys, load.

The port of ``repro.cells.traffic``.  ``failover_dist_np`` is a copy (the
oracle splits redirected arrivals with it at failover time).  The fluid
engine's three functions are torch and take a leading point axis, as the
port's engine does: ``route_skew`` and ``spill_threshold`` are (P, 1) knobs
(or numbers), ``alive`` is (C,) or (P, C), the per-cell quantities are
(P, C), and the flux matrix is (P, C, C).  Without the point axis they take
and give the JAX package's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.policy_api import _max

_EPS = 1e-9


# ---------------------------------------------------------------------------
# numpy side (oracle / host precomputation)
# ---------------------------------------------------------------------------


def failover_dist_np(alive: np.ndarray, route_skew: float) -> np.ndarray:
    """(C,) redistribution over ALIVE cells, preference exp(-skew * c);
    uniform over alive cells when the skew weights underflow."""
    alive = np.asarray(alive, np.float64)
    w = alive * np.exp(-float(route_skew) * np.arange(len(alive)))
    tot = w.sum()
    if tot <= _EPS:
        n = max(alive.sum(), 1.0)
        return alive / n
    return w / tot


# ---------------------------------------------------------------------------
# torch side (fluid engine)
# ---------------------------------------------------------------------------


def failover_dist(alive, route_skew):
    """Torch twin of ``failover_dist_np``: (..., C) over the alive cells for
    each point's ``route_skew``."""
    c = alive.shape[-1]
    w = alive * torch.exp(-route_skew * torch.arange(c, dtype=torch.float32,
                                                     device=alive.device))
    tot = w.sum(-1, keepdim=True)
    uniform = alive / _max(alive.sum(-1, keepdim=True), 1.0)
    return torch.where(tot > _EPS, w / _max(tot, _EPS), uniform)


def spill_fraction(queue_tot, arr_tot, warm_slots, threshold):
    """(..., C) fraction of each cell's incoming traffic to spill: the
    backlog overflow above ``threshold`` queued-per-warm-slot, expressed as
    a fraction of this tick's arrivals, clipped to [0, 1].  threshold <= 0
    disables spill exactly (the parity scenarios run with it off)."""
    cap = threshold * _max(warm_slots, 1.0)
    overflow = _max(queue_tot + arr_tot - cap, 0.0)
    s = torch.clamp(overflow / _max(arr_tot, _EPS), 0.0, 1.0)
    return torch.where(torch.as_tensor(threshold, device=s.device) > 0.0, s, 0.0)


def flux_matrix(alive, spill, free_slots, fail_d):
    """(..., C, C) row-stochastic routing flux.

    ``alive``, ``spill`` and ``free_slots`` are (..., C); ``fail_d`` is the
    failover distribution over alive cells.  Spill from cell c lands on
    OTHER alive cells proportionally to their free warm slots; when no
    sibling has free capacity the spill stays home (the row falls back to
    the identity), so rows always sum to 1.
    """
    c = alive.shape[-1]
    eye = torch.eye(c, dtype=torch.float32, device=spill.device)
    pref = alive * _max(free_slots, 0.0)
    others = pref[..., None, :] * (1.0 - eye)
    denom = others.sum(-1, keepdim=True)
    spill_rows = torch.where(denom > _EPS, others / _max(denom, _EPS), eye)
    alive_rows = (1.0 - spill)[..., :, None] * eye + spill[..., :, None] * spill_rows
    return alive[..., :, None] * alive_rows \
        + (1.0 - alive)[..., :, None] * fail_d[..., None, :]
