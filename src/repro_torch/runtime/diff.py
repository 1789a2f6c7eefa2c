"""Plan diffing: which slot-weight entries a plan switch must move.

Plans are compared through their slot->expert maps
(`repro_torch.core.placement.slot_expert_map`). Only *replica* slots can ever
differ — home slots are fixed by construction — so a diff is bounded by
``L * ep_ranks * dup_slots`` entries. Slots that become UNUSED under the
new plan (expert -1) need no transfer: round-robin dispatch never routes
tokens to a slot outside some expert's live replica set, so stale weights
there are unreachable.

The port's copy of the JAX package's ``runtime/diff.py`` (host numpy).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.placement import PlacementPlan, slot_expert_map


class PlanDiff(NamedTuple):
    """Host-side migration work list for one plan switch.

    Entry arrays have shape (n_entries,). ``dst_slot`` is a GLOBAL slot id
    (rank = dst_slot // n_slots); ``src_expert`` is the expert whose home
    rank sources the weights. ``target_slot_experts`` is the (L, S) slot
    map of the TARGET plan — carried here so the executor/store commit
    does not recompute the per-expert scan ``plan_diff`` already did.
    """
    layer: np.ndarray
    dst_slot: np.ndarray
    src_expert: np.ndarray
    target_slot_experts: np.ndarray

    @property
    def num_entries(self) -> int:
        return int(self.layer.shape[0])

    def bytes_moved(self, entry_bytes: int) -> int:
        return self.num_entries * int(entry_bytes)


def _layer_plan(plan_stack: PlacementPlan, l: int) -> PlacementPlan:
    return PlacementPlan(*(np.asarray(a)[l] for a in plan_stack))


def stacked_slot_experts(plan_stack: PlacementPlan, ep_ranks: int,
                         dup_slots: int) -> np.ndarray:
    """(L, S) slot->expert maps for a stacked (L, ...) plan."""
    L = int(np.asarray(plan_stack.n_replicas).shape[0])
    return np.stack([slot_expert_map(_layer_plan(plan_stack, l), ep_ranks,
                                     dup_slots) for l in range(L)])


def plan_diff(old_stack: PlacementPlan, new_stack: PlacementPlan,
              ep_ranks: int, dup_slots: int) -> PlanDiff:
    """Entries whose expert assignment changes old -> new and is LIVE under
    the new plan. ``plan_diff(p, p)`` is empty; applying the diff to the
    old slot map reproduces the new one on every used slot
    (see ``apply_diff``)."""
    se_old = stacked_slot_experts(old_stack, ep_ranks, dup_slots)
    se_new = stacked_slot_experts(new_stack, ep_ranks, dup_slots)
    layer, slot = np.nonzero((se_new != se_old) & (se_new >= 0))
    return PlanDiff(layer=layer.astype(np.int32),
                    dst_slot=slot.astype(np.int32),
                    src_expert=se_new[layer, slot].astype(np.int32),
                    target_slot_experts=se_new)


def vacated_slots(old_stack: PlacementPlan, new_stack: PlacementPlan,
                  ep_ranks: int, dup_slots: int) -> int:
    """Slot-entries LIVE under the old plan but UNUSED under the new one.

    This is the fleet arbiter's shrink accounting: when a cold model's
    dup-slot quota drops, the next re-plan leaves replica slots with
    ``expert == -1`` — those entries move ZERO bytes (round-robin dispatch
    never reads an unused slot, see the module docstring), so shrinking a
    replica set is free and only growth pays migration stall. The count
    times ``entry_bytes`` is the HBM the budget ledger hands back."""
    se_old = stacked_slot_experts(old_stack, ep_ranks, dup_slots)
    se_new = stacked_slot_experts(new_stack, ep_ranks, dup_slots)
    return int(np.count_nonzero((se_old >= 0) & (se_new < 0)))


def plans_equal(a: PlacementPlan, b: PlacementPlan) -> bool:
    """True iff two stacked plans are identical in EVERY array (slot map
    AND replica counts/tables — two plans can share a slot map yet split
    tokens differently). The prefetch controller uses this to detect a
    misprediction: a pre-begun migration whose target differs from the
    boundary re-plan is cancelled, not committed."""
    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def apply_diff(se_old: np.ndarray, diff: PlanDiff) -> np.ndarray:
    """Apply a diff to an (L, S) slot map (the host-side model of what the
    MigrationExecutor does to the store)."""
    se = np.array(se_old, copy=True)
    se[diff.layer, diff.dst_slot] = diff.src_expert
    return se
