"""Exact evaluation-budget accounting for the population optimizer.

A copy of ``repro.opt.evo.budget`` (pure Python), kept here so that the
port imports nothing of ``repro``; the two must stay identical in behaviour.

The unit of account is one SIMULATED CANDIDATE-SCENARIO PAIR — the same
thing the grid pays for: ``evaluate_scenario`` reports its deduped
simulation count as ``rows[0]["sims"]``, and ``grid_budget`` (in
``repro_torch.opt.evo.engine``) prices the coarse grid in exactly those units,
so "evo at the grid's budget" is a like-for-like claim, not a vibe.

Two kinds of entries:

* ``spend``  — search-stage work (seed generation, offspring evaluations,
  gradient-refinement steps).  Counted against ``total``; overdrawing
  raises ``BudgetExhausted`` so a mis-sized generation fails loudly
  instead of quietly inflating the comparison.
* ``record`` — off-budget work the ledger still tracks (the full-scale
  refine pass mirrors the grid pipeline's refine stage, which the
  hypervolume-at-budget comparisons never count for the grid either).

``spent`` is always exactly ``sum(n for on-budget entries)`` — the
invariant ``tests/test_evo.py`` and ``tests/test_torch_opt.py`` pin.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional


class BudgetExhausted(RuntimeError):
    """A search stage tried to simulate past the declared budget."""


@dataclasses.dataclass
class EvalBudget:
    """Append-only ledger of candidate-scenario-pair evaluations."""
    total: int
    ledger: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.total <= 0:
            raise ValueError(f"EvalBudget total must be positive, got "
                             f"{self.total}")

    # -- accounting --------------------------------------------------------

    @property
    def spent(self) -> int:
        """On-budget pairs consumed so far (exact: the ledger sum)."""
        return sum(e["n"] for e in self.ledger if e["on_budget"])

    @property
    def recorded(self) -> int:
        """Every pair the ledger saw, off-budget refine work included."""
        return sum(e["n"] for e in self.ledger)

    @property
    def remaining(self) -> int:
        return self.total - self.spent

    @property
    def exhausted(self) -> bool:
        return self.remaining <= 0

    def can_afford(self, n: int) -> bool:
        return n <= self.remaining

    def spend(self, n: int, stage: str, scenario: Optional[str] = None,
              generation: Optional[int] = None) -> None:
        """Charge ``n`` pairs against the budget; raises on overdraft."""
        if n < 0:
            raise ValueError(f"cannot spend a negative pair count ({n})")
        if n > self.remaining:
            raise BudgetExhausted(
                f"stage {stage!r} needs {n} candidate-scenario pairs but "
                f"only {self.remaining} of {self.total} remain")
        self.ledger.append({"stage": stage, "scenario": scenario,
                            "generation": generation, "n": int(n),
                            "on_budget": True})

    def record(self, n: int, stage: str, scenario: Optional[str] = None,
               generation: Optional[int] = None) -> None:
        """Track ``n`` pairs of off-budget work (refine fidelity pass)."""
        if n < 0:
            raise ValueError(f"cannot record a negative pair count ({n})")
        self.ledger.append({"stage": stage, "scenario": scenario,
                            "generation": generation, "n": int(n),
                            "on_budget": False})

    # -- reporting ---------------------------------------------------------

    def by_stage(self) -> dict:
        out: dict = {}
        for stage, group in itertools.groupby(
                sorted(self.ledger, key=lambda e: e["stage"]),
                key=lambda e: e["stage"]):
            out[stage] = sum(e["n"] for e in group)
        return out

    def summary(self) -> dict:
        return {"total": self.total, "spent": self.spent,
                "remaining": self.remaining, "recorded": self.recorded,
                "by_stage": self.by_stage()}
