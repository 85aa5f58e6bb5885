# Frontier engine: cross-scenario multi-objective search over the joint
# (policy x fleet) parameter space — coarse batched grid or the NSGA-II
# population optimizer (repro_torch.opt.evo), successive-halving refine,
# per-scenario Pareto fronts, the cross-scenario robust frontier, oracle
# spot-checks on sampled winners, and gradient-learned policies through
# the differentiable eager fluid step.  The port of repro.opt, with the same
# exports; every entry point that simulates takes device=None (CUDA by
# default, the CPU only when named).
from repro_torch.opt.evo import (  # noqa: F401
    BudgetExhausted,
    EvalBudget,
    EvoConfig,
    evo_search,
    grid_budget,
)
from repro_torch.opt.frontier import (  # noqa: F401
    epsilon_survivors,
    frontier_slack,
    hypervolume,
    pareto_front,
    robust_front,
)
from repro_torch.opt.learned import (  # noqa: F401
    TrainResult,
    confirm,
    evaluate_trained,
    make_loss,
    refine_leaves,
    train_policy,
)
from repro_torch.opt.search import (  # noqa: F401
    SEARCH_ALGOS,
    FrontierResult,
    default_fleet,
    evaluate_points,
    evaluate_scenario,
    frontier_search,
    oracle_spot_check,
    point_scenario,
    sample_front,
)
from repro_torch.opt.space import (  # noqa: F401
    DEFAULT_SPACE,
    SWEEPABLE,
    SearchSpace,
    active_knobs,
    grid_points,
)
