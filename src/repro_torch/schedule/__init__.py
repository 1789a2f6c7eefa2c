"""Token-level rescheduling: the second balancing lever next to expert
duplication (the port of the JAX package's ``schedule/``, numpy only).

Duplication moves *weights* toward hot experts; rescheduling moves *tokens*
toward spare capacity. Two halves:

* a host-side scheduler (this package) that turns the per-expert token
  histogram into per-copy **quotas**: fractional shares of each expert's
  traffic per replica, chosen to minimise the max EP-rank load subject to
  per-slot capacity. Two implementations behind one interface: ``greedy``
  (waterfill over the expert x rank histogram) and ``lp`` (binary search
  on the load bound with a max-flow feasibility check, dependency-free).
* the dispatch's consumer (``repro_torch.moe.dispatch.choose_replica_quota``)
  that reads the quantised quota tensor ``(E, C_max) int32`` and a
  per-(token, k) salt to pick replicas, plus a *rescue round* that
  re-dispatches capacity-overflow pairs to an alternate copy, which is
  what absorbs drops at dispatch time.
"""

from repro_torch.schedule.base import (RESCHED_Q, RescheduleResult,
                                       TokenScheduler, even_quota,
                                       even_quota_stack, even_shares,
                                       make_scheduler, quota_realized_shares,
                                       shares_to_quota)
from repro_torch.schedule.greedy import GreedyWaterfill
from repro_torch.schedule.lp import TransportLP

__all__ = [
    "RESCHED_Q", "RescheduleResult", "TokenScheduler", "GreedyWaterfill",
    "TransportLP", "even_quota", "even_quota_stack", "even_shares",
    "make_scheduler", "quota_realized_shares", "shares_to_quota",
]
