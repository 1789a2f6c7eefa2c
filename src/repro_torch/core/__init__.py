"""The paper's host-side planning: placement plans, Algorithm 1 expert
duplication, imbalance metrics and the Distribution-Only estimator
(numpy-only copies of the JAX package's ``core`` modules)."""
from repro_torch.core.duplication import (DuplicationResult, bottleneck_load,
                                          duplicate_experts_host, skewness)
from repro_torch.core.placement import (PlacementPlan, identity_plan,
                                        plan_from_assignments,
                                        quota_limited_plan, stack_plans)
from repro_torch.core.predictors import DistributionEstimator

__all__ = [
    "DistributionEstimator", "DuplicationResult", "PlacementPlan",
    "bottleneck_load", "duplicate_experts_host", "identity_plan",
    "plan_from_assignments", "quota_limited_plan", "skewness", "stack_plans",
]
