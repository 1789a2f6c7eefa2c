"""The paper's host-side planning and strategy selection: placement plans,
Algorithm 1 expert duplication, imbalance metrics, the Distribution-Only
estimator, the latency simulator and MoE-GPS (numpy-only copies of the JAX
package's ``core`` modules; no TPU hardware preset)."""
from repro_torch.core.duplication import (DuplicationResult, bottleneck_load,
                                          duplicate_experts_host, skewness)
from repro_torch.core.placement import (PlacementPlan, identity_plan,
                                        plan_from_assignments,
                                        quota_limited_plan, stack_plans)
from repro_torch.core.predictors import DistributionEstimator
from repro_torch.core.simulator import (A100_NVLINK, A100_PCIE,
                                        H100_SXM_NVLINK, HardwareConfig,
                                        LatencyBreakdown, layer_latency)
from repro_torch.core.gps import (LEVERS, GPSReport, StrategyVerdict,
                                  T2EPoint, recommend_strategy, run_gps,
                                  sweep)

__all__ = [
    "A100_NVLINK", "A100_PCIE", "DistributionEstimator", "DuplicationResult",
    "GPSReport", "H100_SXM_NVLINK", "HardwareConfig", "LEVERS",
    "LatencyBreakdown", "PlacementPlan", "StrategyVerdict", "T2EPoint",
    "bottleneck_load", "duplicate_experts_host", "identity_plan",
    "layer_latency", "plan_from_assignments", "quota_limited_plan",
    "recommend_strategy", "run_gps", "skewness", "stack_plans", "sweep",
]
