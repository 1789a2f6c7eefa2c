"""Serving runtime: the batched ``ServeEngine`` and continuous batching
over a paged KV block pool, with the Distribution-Only predict -> plan
loop and an online GPS controller that switches strategy on live skew."""
from repro_torch.serve.controller import (ControllerConfig, Decision,
                                          OnlineGPSController)
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      ServeConfig, ServeEngine, StepEvents)
from repro_torch.serve.kvcache import BlockAllocator, init_block_pool
from repro_torch.serve.metrics import (RequestTiming, ServeMetrics, imbalance,
                                       plan_rank_loads)
from repro_torch.serve.scheduler import (BatchScheduler, ContinuousScheduler,
                                         IterationPlan, Request, RequestState,
                                         ServeRequest, pad_fifo_batch)

__all__ = [
    "BatchScheduler", "BlockAllocator", "ContinuousConfig",
    "ContinuousEngine", "ContinuousScheduler", "ControllerConfig",
    "Decision", "IterationPlan", "OnlineGPSController", "Request",
    "RequestState", "RequestTiming", "ServeConfig", "ServeEngine",
    "ServeMetrics", "ServeRequest", "StepEvents", "imbalance",
    "init_block_pool", "pad_fifo_batch", "plan_rank_loads",
]
