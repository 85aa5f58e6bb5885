# Declarative workload scenarios: a registry of named (trace x transforms x
# policy x fleet) specs, replayable through both the discrete-event oracle
# and the chunked fluid simulator from one spec.  The port of
# repro.scenarios: the same names, the fluid leg on repro_torch.core.simtorch.
from repro_torch.scenarios.cluster import cluster_functions  # noqa: F401
from repro_torch.scenarios.registry import (  # noqa: F401
    get_scenario,
    list_scenarios,
    register,
)
from repro_torch.scenarios.runner import (  # noqa: F401
    ENGINES,
    PARITY_KEYS,
    frontier,
    parity_report,
    run_scenario,
)
from repro_torch.scenarios.spec import PolicySpec, Scenario  # noqa: F401
from repro_torch.scenarios.transforms import (  # noqa: F401
    BurstInject,
    RateScale,
    Splice,
    TenantMerge,
    TimeWarp,
    Transform,
    apply_transforms,
)
