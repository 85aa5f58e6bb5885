# Autoscaling policies and the real control plane that runs them.
from repro_torch.core.policies import (  # noqa: F401
    AsyncConcurrencyPolicy,
    HybridHistogramPolicy,
    Policy,
    PolicyDecision,
    SyncKeepalivePolicy,
    make_policy,
)
