"""Expert placement plans — the interface between the duplication planner
(Algorithm 1, `core.duplication`) and the EP dispatch runtime
(the JAX package's `moe/dispatch.py`; not ported yet).

A plan describes, for one MoE layer, which expert occupies each *slot*:

* every EP rank owns ``E_loc = E / R`` fixed slots (its home experts);
* every rank additionally has ``D`` *replica* slots, filled from a global
  pool of up to ``R`` duplicated experts (one contributed per source rank
  via all_gather — matching the paper's "one expert sent/received per GPU
  per layer" transfer model, Sec 5);
* tokens routed to expert ``e`` are split round-robin across its
  ``n_replicas[e]`` copies (home slot + replica slots).

All arrays are replicated (identical on every rank) and dynamically valued
(recomputed per prediction interval) but statically shaped.

Port note: the same functions as the JAX package's ``core/placement.py``,
with numpy arrays (int32) in place of jnp arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PlacementPlan(NamedTuple):
    """Slot layout for one MoE layer. Shapes are static given (E, R, D, C_max)."""
    n_replicas: np.ndarray     # (E,)   int32, >= 1
    replica_table: np.ndarray  # (E, C_max) int32 global slot ids; [:,0] = home
    pool_expert: np.ndarray    # (R,)   int32 expert contributed by each source rank
    pool_sel: np.ndarray       # (R, D) int32 pool index filling each replica slot

    @property
    def num_experts(self) -> int:
        return self.n_replicas.shape[0]

    @property
    def max_copies(self) -> int:
        return self.replica_table.shape[1]


def plan_dims(num_experts: int, ep_ranks: int, dup_slots: int):
    assert num_experts % ep_ranks == 0, (num_experts, ep_ranks)
    e_loc = num_experts // ep_ranks
    return e_loc, e_loc + dup_slots


def home_slot(expert: np.ndarray, e_loc: int, n_slots: int):
    """Global slot id of an expert's home copy."""
    return (expert // e_loc) * n_slots + (expert % e_loc)


def identity_plan(num_experts: int, ep_ranks: int, dup_slots: int,
                  max_copies: int) -> PlacementPlan:
    """No duplication: every expert lives only in its home slot."""
    e_loc, n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
    e = np.arange(num_experts)
    home = home_slot(e, e_loc, n_slots)
    table = np.tile(home[:, None], (1, max_copies))
    return PlacementPlan(
        n_replicas=np.ones((num_experts,), np.int32),
        replica_table=np.asarray(table, np.int32),
        pool_expert=np.zeros((ep_ranks,), np.int32),
        pool_sel=np.zeros((ep_ranks, max(dup_slots, 1)), np.int32),
    )


def stack_plans(plans) -> PlacementPlan:
    """Stack per-layer plans into (L, ...) arrays for the scanned forward."""
    return PlacementPlan(*(np.stack(xs) for xs in zip(*plans)))


def slot_expert_map(plan: PlacementPlan, ep_ranks: int,
                    dup_slots: int) -> np.ndarray:
    """(S,) expert id occupying each global slot; -1 = unused replica slot.

    Home slots are fixed by construction; replica slots are read off the
    plan's ``replica_table`` rows (entries ``1..n_replicas-1`` are live
    extra copies). This is the host-side view the replica-weight runtime
    diffs between plans — a slot's *contents* only matter while some
    expert's replica set points at it.
    """
    E = int(np.asarray(plan.n_replicas).shape[-1])
    e_loc, n_slots = plan_dims(E, ep_ranks, dup_slots)
    se = -np.ones((ep_ranks * n_slots,), np.int64)
    e = np.arange(E)
    se[home_slot(e, e_loc, n_slots)] = e
    n_rep = np.asarray(plan.n_replicas)
    table = np.asarray(plan.replica_table)
    for ei in range(E):
        for c in range(1, int(n_rep[ei])):
            se[int(table[ei, c])] = ei
    return se


def quota_limited_plan(assignments, num_experts: int, ep_ranks: int,
                       dup_slots: int, max_copies: int, *,
                       quota: int) -> PlacementPlan:
    """Plan at the FULL compiled replica-slot geometry, using at most
    ``quota`` replica slots per rank.

    The fleet arbiter moves duplication capacity between co-resident
    models as a *logical* quota: every engine keeps the ``dup_slots`` it
    compiled with (so no jit signature ever changes), but the planner's
    extra-copy assignments are truncated to the first ``quota`` per
    destination rank. ``quota=0`` degenerates to the identity plan at
    full geometry; ``quota>=dup_slots`` is the unrestricted plan.
    """
    q = max(0, min(int(quota), int(dup_slots)))
    if q < dup_slots:
        taken = np.zeros((ep_ranks,), np.int64)
        kept = []
        for expert, dest in assignments:
            if taken[dest] >= q:
                continue
            taken[dest] += 1
            kept.append((expert, dest))
        assignments = kept
    return plan_from_assignments(assignments, num_experts, ep_ranks,
                                 dup_slots, max_copies)


def plan_from_assignments(assignments, num_experts: int, ep_ranks: int,
                          dup_slots: int, max_copies: int) -> PlacementPlan:
    """Build a PlacementPlan from a host-side list of extra copies.

    assignments: list of (expert, dest_rank) pairs — the duplication
    decisions from Algorithm 1. Constraints enforced here:
      * <= dup_slots extra copies hosted per rank,
      * <= max_copies total copies per expert,
      * one pool contribution per source (home) rank.
    Violations are skipped (planner should already respect them).
    """
    e_loc, n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
    n_rep = np.ones((num_experts,), np.int64)
    table = np.tile(home_slot(np.arange(num_experts), e_loc, n_slots)[:, None],
                    (1, max_copies))
    pool_expert = np.zeros((ep_ranks,), np.int64)
    pool_used = np.zeros((ep_ranks,), bool)
    pool_sel = np.zeros((ep_ranks, max(dup_slots, 1)), np.int64)
    rank_extra = np.zeros((ep_ranks,), np.int64)

    for expert, dest in assignments:
        src = expert // e_loc
        if n_rep[expert] >= max_copies or rank_extra[dest] >= dup_slots:
            continue
        if pool_used[src] and pool_expert[src] != expert:
            continue                      # source already ships a different expert
        pool_expert[src] = expert
        pool_used[src] = True
        slot_j = rank_extra[dest]
        pool_sel[dest, slot_j] = src
        gslot = dest * n_slots + e_loc + slot_j
        table[expert, n_rep[expert]] = gslot
        n_rep[expert] += 1
        rank_extra[dest] += 1

    return PlacementPlan(
        n_replicas=np.asarray(n_rep, np.int32),
        replica_table=np.asarray(table, np.int32),
        pool_expert=np.asarray(pool_expert, np.int32),
        pool_sel=np.asarray(pool_sel, np.int32),
    )
