"""Gene encoding: SearchSpace -> bounded real vector and back.

The grid's ``SearchSpace`` names the knobs and (by its candidate values)
seeds the search; the declared ``AxisSpec`` bounds are the SEARCH BOX.  A
policy gene's box is the tightest (lo, hi) any searched family declares
for that axis — NOT the grid's [min, max]: the whole point of replacing
enumeration is that SBX/mutation can interpolate between grid rungs and
push BEYOND them (a keepalive ladder topping out at 1200 s does not bound
where the cost optimum lives), while a mutated candidate can never leave
the declared envelope (``evaluate_points`` would reject it loudly).
Fleet knobs carry no AxisSpec; their box stays the grid's [min, max].

Three gene classes:

* continuous — ordinary traced axes (keepalive, target, warm_frac, ...);
* integer    — axes the engines round (``cc``, ``cell_count``): decoded
  values snap to whole numbers, so crossover cannot manufacture a
  fractional container-concurrency;
* structural — ``cell_count`` additionally regroups the trace partition:
  ``evaluate_scenario`` already buckets sweep points by its rounded value
  and runs one batched multi-cell scan per group, so the evo engine needs
  no special dispatch — it just keeps the gene integral.

Continuous genes whose box is positive and spans two-plus decades (a
keepalive declared over [1 s, 86400 s]) operate in LOG space: SBX and
mutation see log(v), so variation steps are multiplicative — a mutation
from 1200 s explores 800/1800 s, not 1200 +- 2000 s of an 86k-wide linear
box whose perturbations are either negligible or wild.  Timescale knobs
are ratio-scaled quantities; searching them linearly wastes the budget.

Axes a knob grid declares but NO searched scenario's family reads are
DROPPED from the genome (mirroring ``opt.search._effective_key``'s inert-
axis collapse): evolving an axis the simulator ignores would spend budget
mutating noise.  Knob grids with a single candidate become frozen
constants carried into every decoded point.

The port of ``repro.opt.evo.genome`` (numpy over the port's policy
registry and fleet vector); the two must stay identical in behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.policy_api import get_family, list_families
from repro_torch.core.simtorch import _PFLEET
from repro_torch.opt.space import SearchSpace, active_knobs

# axes the engines consume as whole numbers; ``cell_count`` is additionally
# structural (it rebuilds the per-cell trace partition, grouped by
# evaluate_scenario) — see repro_torch.cells.family
INTEGER_AXES = frozenset({"cc", "cell_count"})
STRUCTURAL_AXES = frozenset({"cell_count"})


@dataclasses.dataclass(frozen=True)
class Gene:
    """One evolvable knob: its box (natural units) and its class.  ``log``
    genes expose log-transformed coordinates to the variation operators."""
    name: str
    lo: float
    hi: float
    integer: bool = False
    structural: bool = False
    fleet: bool = False
    log: bool = False

    def to_vec(self, v: float) -> float:
        """Natural value -> variation-space coordinate."""
        return float(np.log(v)) if self.log else float(v)

    def from_vec(self, x: float) -> float:
        """Variation-space coordinate -> natural value.  Log genes snap to
        12 significant digits so exp(log(v)) round-trips exactly — a seed
        decoded through the lattice must simulate the very same knob value
        the grid evaluated, not a 1e-13-perturbed neighbour."""
        if not self.log:
            return float(x)
        v = float(f"{float(np.exp(x)):.12g}")
        return float(min(max(v, self.lo), self.hi))


def _axis_bounds(name: str, families: Optional[Iterable[str]]) -> tuple:
    """The tightest declared (lo, hi) for a policy axis across the searched
    families (falling back to every registered family when none of the
    searched ones declares it — the knob is then inert anyway)."""
    fams = list(families) if families else list_families()
    los, his = [], []
    for f in fams:
        fam = get_family(f)
        if name in fam.axis_names():
            ax = fam.axis(name)
            los.append(ax.lo)
            his.append(ax.hi)
    if not los:
        for f in list_families():
            fam = get_family(f)
            if name in fam.axis_names():
                ax = fam.axis(name)
                los.append(ax.lo)
                his.append(ax.hi)
    if not los:                      # fleet knobs have no AxisSpec
        return -np.inf, np.inf
    return max(los), min(his)


@dataclasses.dataclass(frozen=True)
class Genome:
    """An ordered gene tuple + frozen constants; encode/decode both ways."""
    genes: tuple
    fixed: tuple = ()                # ((knob, value), ...) single-candidate

    def __post_init__(self):
        if not self.genes:
            raise ValueError("genome has no evolvable genes: every searched "
                             "knob is either inert for the searched "
                             "scenarios' families or single-valued")

    @property
    def names(self) -> tuple:
        return tuple(g.name for g in self.genes)

    @property
    def lo(self) -> np.ndarray:
        """Variation-space lower bounds (log-transformed for log genes) —
        what SBX/mutation receive as the box."""
        return np.asarray([g.to_vec(g.lo) for g in self.genes])

    @property
    def hi(self) -> np.ndarray:
        return np.asarray([g.to_vec(g.hi) for g in self.genes])

    def encode(self, point: dict) -> np.ndarray:
        """Point dict -> variation-space gene vector (missing genes sit at
        their lower bound; values clipped into the box)."""
        return np.asarray([
            g.to_vec(float(np.clip(float(point.get(g.name, g.lo)),
                                   g.lo, g.hi)))
            for g in self.genes])

    def repair(self, vec: np.ndarray) -> np.ndarray:
        """Clip into the variation-space box and snap integer genes —
        idempotent; applied after every variation so decoded candidates
        are always legal."""
        v = np.clip(np.asarray(vec, dtype=float), self.lo, self.hi)
        for i, g in enumerate(self.genes):
            if g.integer:                       # integer genes never log
                v[i] = float(np.clip(np.round(v[i]), g.lo, g.hi))
        return v

    def decode(self, vec: np.ndarray) -> dict:
        """Variation-space vector -> point dict in natural units
        (repaired), frozen constants included so decoded points stay
        comparable with grid points."""
        v = self.repair(vec)
        out = {g.name: g.from_vec(v[i]) for i, g in enumerate(self.genes)}
        out.update(dict(self.fixed))
        return out

    def project(self, point: dict) -> dict:
        """Restrict a (grid) point to the genome's knobs — the inert-axis
        collapse applied to candidate identity."""
        out = {g.name: float(point[g.name]) for g in self.genes
               if g.name in point}
        out.update((k, v) for k, v in self.fixed if k in point)
        return out


def genome_from_space(space: SearchSpace,
                      families: Optional[Sequence[str]] = None) -> Genome:
    """Build the genome a ``SearchSpace`` spans for the given scenario
    families (None = keep every knob)."""
    act: Optional[set] = None
    if families is not None:
        act = set()
        for f in families:
            act |= set(active_knobs(f))
    genes, fixed = [], []
    for knob, vals in {**space.policy, **space.fleet}.items():
        is_fleet = knob in _PFLEET
        if act is not None and not is_fleet and knob not in act:
            continue                     # inert for every searched family
        vals = [float(v) for v in vals]
        lo, hi = min(vals), max(vals)
        if not is_fleet:
            ax_lo, ax_hi = _axis_bounds(knob, families)
            if lo < ax_lo or hi > ax_hi:
                raise ValueError(f"knob {knob!r}: grid range [{lo}, {hi}] "
                                 f"leaves the declared axis bounds "
                                 f"[{ax_lo}, {ax_hi}]")
            if len(set(vals)) > 1 and np.isfinite([ax_lo, ax_hi]).all():
                # the grid SEEDS; the declared axis bounds are the box
                lo, hi = ax_lo, ax_hi
        integer = knob in INTEGER_AXES
        if integer:
            lo, hi = float(np.ceil(lo)), float(np.floor(hi))
        if lo == hi:
            fixed.append((knob, lo))
            continue
        # ratio-scaled knobs (positive box spanning 2+ decades, e.g. a
        # keepalive over [1 s, 86400 s]) vary in log space
        use_log = not integer and lo > 0 and hi / lo >= 100.0
        genes.append(Gene(name=knob, lo=lo, hi=hi, integer=integer,
                          structural=knob in STRUCTURAL_AXES,
                          fleet=is_fleet, log=use_log))
    return Genome(genes=tuple(genes), fixed=tuple(fixed))


def point_key(point: dict, decimals: int = 9) -> tuple:
    """Canonical hashable identity of a candidate (rounded so float noise
    from crossover arithmetic cannot mint spurious 'new' candidates)."""
    return tuple(sorted((k, round(float(v), decimals))
                        for k, v in point.items()))
