"""Population-based multi-objective optimizer (NSGA-II style) for the
policy/fleet search space — the ``algo="evo"`` engine behind
``repro_torch.opt.search.frontier_search``.

Layout:

* ``budget``  — ``EvalBudget``: exact candidate-scenario-pair accounting.
* ``nsga``    — sort/crowding/SBX/mutation primitives (pure numpy).
* ``genome``  — SearchSpace -> bounded gene vectors (AxisSpec-clipped,
  integer/structural axes honored).
* ``engine``  — ``evo_search``: the generational loop, batched simulator
  evaluation, gradient elite refinement, FrontierResult construction.

The port of ``repro.opt.evo``, with the same exports.
"""

from repro_torch.opt.evo.budget import BudgetExhausted, EvalBudget
from repro_torch.opt.evo.engine import EvoConfig, evo_search, grid_budget
from repro_torch.opt.evo.genome import (INTEGER_AXES, STRUCTURAL_AXES, Gene,
                                  Genome, genome_from_space, point_key)
from repro_torch.opt.evo.nsga import (crowding_distance, non_dominated_sort,
                                nsga_rank, polynomial_mutation,
                                sbx_crossover, tournament_pick)

__all__ = [
    "BudgetExhausted", "EvalBudget", "EvoConfig", "evo_search",
    "grid_budget", "INTEGER_AXES", "STRUCTURAL_AXES", "Gene", "Genome",
    "genome_from_space", "point_key", "crowding_distance",
    "non_dominated_sort", "nsga_rank", "polynomial_mutation",
    "sbx_crossover", "tournament_pick",
]
