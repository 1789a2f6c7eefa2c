"""Expert placement plans — the interface between the duplication planner
(Algorithm 1, `core.duplication`) and the EP dispatch runtime
(`moe.dispatch`).

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
with numpy arrays (int32) in place of jnp arrays. ``slot_experts`` and
``to_device`` are the port's own: the dispatch reads each slot's weights
as one row of a weight tensor, through a slot -> row map (the expert's
home row, or under the replica store the slot's own row).
``device_slot_experts`` and ``device_plan`` build the same from a plan
whose fields are tensors on the device (an in-graph plan).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def store_bytes_per_rank(num_experts: int, ep_ranks: int, dup_slots: int, *,
                         entry_bytes: int, num_layers: int) -> int:
    """Device memory one EP rank spends on a persistent replica store in
    the JAX package's accounting: ``L x n_slots`` slot entries (a second
    copy of the home experts plus the replica slots). The budget clamp
    reads this figure, so plans match the reference's under one budget;
    the port's store holds less (``runtime.store``)."""
    _, n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
    return int(num_layers) * n_slots * int(entry_bytes)


def clamp_dup_slots(num_experts: int, ep_ranks: int, dup_slots: int, *,
                    entry_bytes: int, num_layers: int,
                    hbm_budget_bytes: float) -> int:
    """Largest ``d <= dup_slots`` whose replica store fits the per-rank
    HBM budget (``MoEConfig.store_hbm_budget_gb``). 0 disables the clamp.
    Can return 0 (no replica slots fit — duplication off)."""
    if hbm_budget_bytes <= 0 or dup_slots <= 0:
        return dup_slots
    d = int(dup_slots)
    while d > 0 and store_bytes_per_rank(
            num_experts, ep_ranks, d, entry_bytes=entry_bytes,
            num_layers=num_layers) > hbm_budget_bytes:
        d -= 1
    return d


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


def slot_experts(plan: PlacementPlan, num_experts: int, ep_ranks: int,
                 dup_slots: int) -> np.ndarray:
    """(..., R * n_slots) int32: for every global slot, the expert whose
    weights the JAX package's dispatch puts there (``gather_replica_pool``
    and ``_slot_weights`` in its ``moe/dispatch.py``). ``plan`` may be one
    layer's or a stacked (L, ...) plan.

    Home slot ``(r, j < E_loc)`` holds expert ``r * E_loc + j``. Replica slot
    ``(r, E_loc + i)`` holds what source rank ``src = pool_sel[r, i]``
    contributed to the pool: its local expert ``pool_expert[src] % E_loc``,
    i.e. expert ``src * E_loc + pool_expert[src] % E_loc``. Under the
    identity plan JAX fills the pool with zeros instead; no (token, k) pair
    is routed to a replica slot then, so any map gives the same output."""
    e_loc, n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
    pool_expert = np.asarray(plan.pool_expert, np.int64)       # (..., R)
    src = np.asarray(plan.pool_sel, np.int64)[..., :dup_slots]  # (..., R, D)
    lead = pool_expert.shape[:-1]
    home = np.broadcast_to(np.arange(num_experts).reshape(ep_ranks, e_loc),
                           lead + (ep_ranks, e_loc))
    contrib = np.take_along_axis(pool_expert, src.reshape(lead + (-1,)),
                                 axis=-1).reshape(src.shape)
    rep = src * e_loc + contrib % e_loc
    out = np.concatenate([home, rep], axis=-1)
    return out.reshape(lead + (ep_ranks * n_slots,)).astype(np.int32)


class DevicePlan(NamedTuple):
    """What the dispatch reads of a placement plan, as device tensors: one
    layer's, or stacked over layers (index with ``layer``). ``slot_rows``
    is the row of the layer's weight tensors each slot computes with:
    ``slot_experts`` when the weights are the (E, ...) home experts, the
    replica store's rows (``runtime.store``) when they are its tensors."""
    n_replicas: torch.Tensor     # (..., E) int64
    replica_table: torch.Tensor  # (..., E, C_max) int64 global slot ids
    slot_experts: torch.Tensor   # (..., R * n_slots) int32
    slot_rows: torch.Tensor      # (..., R * n_slots) int32

    def layer(self, l: int) -> "DevicePlan":
        return DevicePlan(*(t[l] for t in self))


def device_slot_experts(plan: PlacementPlan, num_experts: int,
                        ep_ranks: int, dup_slots: int) -> torch.Tensor:
    """``slot_experts`` of a plan whose fields are torch tensors (one
    layer's or stacked), computed on their device: (..., R * n_slots)
    int32, equal to the numpy ``slot_experts`` of the same plan."""
    e_loc, n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
    pool_expert = plan.pool_expert.long()                      # (..., R)
    src = plan.pool_sel.long()[..., :dup_slots]                # (..., R, D)
    lead = tuple(pool_expert.shape[:-1])
    home = torch.arange(num_experts, device=pool_expert.device) \
        .reshape(ep_ranks, e_loc).expand(lead + (ep_ranks, e_loc))
    contrib = torch.gather(pool_expert, -1, src.reshape(lead + (-1,))) \
        .reshape(src.shape)
    rep = src * e_loc + contrib % e_loc
    out = torch.cat([home, rep], dim=-1)
    return out.reshape(lead + (ep_ranks * n_slots,)).to(torch.int32)


def device_plan(plan: PlacementPlan, num_experts: int, ep_ranks: int,
                dup_slots: int, rows=None) -> DevicePlan:
    """The ``DevicePlan`` of a plan whose fields are already tensors on the
    device (an in-graph plan, ``core.duplication.
    duplicate_experts_device``), built there: nothing is copied to or from
    the host. ``rows``: the slot -> row map, a tensor shaped as the slot
    map; None reads every slot's expert from its home row."""
    se = device_slot_experts(plan, num_experts, ep_ranks, dup_slots)
    return DevicePlan(plan.n_replicas.long(), plan.replica_table.long(), se,
                      se if rows is None else rows.to(torch.int32))


class MetaPlan(DevicePlan):
    """A ``DevicePlan`` on the ``meta`` device (the dry run), with the same
    plan on the CPU as ``host``: what the dispatch reads of a plan on the
    host (``moe.dispatch.gather_replica_pool``) it reads there."""

    def layer(self, l: int) -> "MetaPlan":
        out = MetaPlan(*(t[l] for t in self))
        out.host = self.host.layer(l)
        return out


def host_plan(plan: DevicePlan) -> DevicePlan:
    """The plan whose values the host may read: a ``MetaPlan``'s CPU copy,
    else the plan itself."""
    return getattr(plan, "host", plan)


def to_device(plan: PlacementPlan, num_experts: int, ep_ranks: int,
              dup_slots: int, device, rows=None) -> DevicePlan:
    """Move a (stacked) plan to ``device`` once, at each re-plan, so the
    forward passes between re-plans copy nothing from the host. ``rows``:
    the slot -> row map (shaped as ``slot_experts``); None reads every
    slot's expert from its home row. A plan of tensors is moved to
    ``device`` (no copy where it already lies there, as an in-graph plan
    does: ``device_plan``). On ``meta`` the result is a ``MetaPlan``, the
    plan kept on the CPU beside it."""
    def dev(a):
        return a.to(device) if torch.is_tensor(a) else torch.tensor(
            np.array(a), device=device)
    out = device_plan(PlacementPlan(*(dev(a) for a in plan)), num_experts,
                      ep_ranks, dup_slots,
                      rows=None if rows is None else dev(rows))
    if torch.device(device).type != "meta":
        return out
    meta = MetaPlan(*out)
    meta.host = to_device(plan, num_experts, ep_ranks, dup_slots, "cpu",
                          rows)
    return meta
