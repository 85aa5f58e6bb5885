# Two-level autoscaling: the node-fleet layer under the per-function
# instance policies — node lifecycle + fleet policies + dollar-cost
# accounting + the provider-calibrated billing engine + the control-plane
# capacity manager + the vmapped policy-parameter sweep over the lax.scan
# simulator + the spot capacity tiers (preemption hazards, reclaim
# notices, per-tier billing).
from repro_torch.fleet.billing import (  # noqa: F401
    AWS_LAMBDA,
    GCR,
    IDEAL,
    BillingProfile,
    BillReport,
    apply_throttle,
    bill_sim,
    bill_summary,
    get_profile,
    list_profiles,
    register_profile,
    resolve_profile,
)
from repro_torch.fleet.costs import CostReport, PriceBook, cost_from_sim, cost_report  # noqa: F401
from repro_torch.fleet.manager import FleetManager  # noqa: F401
from repro_torch.fleet.nodes import NodeFleet, NodeType  # noqa: F401
from repro_torch.fleet.policies import (  # noqa: F401
    FleetPolicy,
    ScheduleFleetPolicy,
    ThresholdFleetPolicy,
    UtilizationFleetPolicy,
)
from repro_torch.fleet.spot import (  # noqa: F401
    CapacityTier,
    SpotMarket,
    SpotNodeFleet,
    get_tier,
    list_tiers,
    register_tier,
)
