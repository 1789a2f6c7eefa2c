"""Replica-weight migration runtime (the port of the JAX package's
``runtime``).

The paper's transfer model (Sec 5) charges duplication ONE weight movement
per re-plan. This package keeps replica weights *persistent* so the EP
engine pays weight movement only when the plan changes:

  ``ReplicaStore``       — per-layer row tensors on the device: the home
                           experts, and a live and a back row for every
                           replica slot; versioned per layer.
  ``plan_diff``          — exactly which (layer, slot) entries change
                           expert assignment between two stacked plans.
  ``MigrationExecutor``  — serve -> diff -> chunked fill -> swap: fills
                           only changed slots' back rows, chunked to a
                           per-step budget, on a side CUDA stream, while
                           the engine keeps serving on the live rows
                           until the swap commits.
  ``LayerStagedExecutor``— fills in layer order and exposes a per-layer
                           ready mask and fill event, so the forward pass
                           adopts each layer the moment its fill lands.
  ``cost``               — bytes-moved / stall model with the
                           hidden-vs-exposed overlap split.
"""

from repro_torch.runtime.cost import (KindWindowEMA, entry_bytes,
                                      migration_stall_s, overlap_chunk_budget,
                                      plan_migration_bytes, should_migrate,
                                      split_hidden_exposed)
from repro_torch.runtime.diff import (PlanDiff, apply_diff, plan_diff,
                                      plans_equal, stacked_slot_experts,
                                      vacated_slots)
from repro_torch.runtime.migrate import (LayerStagedExecutor,
                                         MigrationExecutor, make_migrate_step,
                                         migrate_all)
from repro_torch.runtime.store import ReplicaStore

__all__ = [
    "KindWindowEMA", "LayerStagedExecutor", "MigrationExecutor", "PlanDiff",
    "ReplicaStore",
    "apply_diff", "entry_bytes", "make_migrate_step", "migrate_all",
    "migration_stall_s", "overlap_chunk_budget", "plan_diff",
    "plan_migration_bytes", "plans_equal", "should_migrate",
    "split_hidden_exposed", "stacked_slot_experts", "vacated_slots",
]
