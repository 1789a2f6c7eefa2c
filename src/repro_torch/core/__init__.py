"""The paper's host-side planning and strategy selection: placement plans,
Algorithm 1 expert duplication, imbalance metrics, the predictor ladder
(the Distribution-Only estimator and the Token-to-Expert predictors), the
latency simulator and MoE-GPS (copies of the JAX package's ``core``
modules: numpy, and PyTorch for the neural predictors; no TPU hardware
preset)."""
from repro_torch.core.duplication import (DuplicationResult, bottleneck_load,
                                          duplicate_experts_host, skewness)
from repro_torch.core.placement import (PlacementPlan, identity_plan,
                                        plan_from_assignments,
                                        quota_limited_plan, stack_plans)
from repro_torch.core.predictors import (ConditionalProbabilityModel,
                                         DistributionEstimator, FFNPredictor,
                                         LSTMPredictor, ProbabilityModel,
                                         accuracy)
from repro_torch.core.simulator import (A100_NVLINK, A100_PCIE,
                                        H100_SXM_NVLINK, HardwareConfig,
                                        LatencyBreakdown, layer_latency)
from repro_torch.core.gps import (LEVERS, GPSReport, StrategyVerdict,
                                  T2EPoint, recommend_strategy, run_gps,
                                  sweep)

__all__ = [
    "A100_NVLINK", "A100_PCIE", "ConditionalProbabilityModel",
    "DistributionEstimator", "DuplicationResult", "FFNPredictor",
    "GPSReport", "H100_SXM_NVLINK", "HardwareConfig", "LEVERS",
    "LSTMPredictor", "LatencyBreakdown", "PlacementPlan", "ProbabilityModel",
    "StrategyVerdict", "T2EPoint", "accuracy", "bottleneck_load", "duplicate_experts_host", "identity_plan",
    "layer_latency", "plan_from_assignments", "quota_limited_plan",
    "recommend_strategy", "run_gps", "skewness", "stack_plans", "sweep",
]
