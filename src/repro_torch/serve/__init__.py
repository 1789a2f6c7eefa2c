"""Serving runtime: continuous batching over a paged KV block pool, with
the Distribution-Only predict -> plan loop in every step."""
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      StepEvents)
from repro_torch.serve.kvcache import BlockAllocator, init_block_pool
from repro_torch.serve.metrics import (RequestTiming, ServeMetrics, imbalance,
                                       plan_rank_loads)
from repro_torch.serve.scheduler import (ContinuousScheduler, IterationPlan,
                                         RequestState, ServeRequest)

__all__ = [
    "BlockAllocator", "ContinuousConfig", "ContinuousEngine",
    "ContinuousScheduler", "IterationPlan", "RequestState", "RequestTiming",
    "ServeMetrics", "ServeRequest", "StepEvents", "imbalance",
    "init_block_pool", "plan_rank_loads",
]
