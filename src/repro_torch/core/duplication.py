"""Algorithm 1 from MoE-GPS: greedy expert duplication for load balance.

Given a token->expert map (or just a predicted expert *distribution* — the
Distribution-Only strategy needs nothing more), iteratively copy the
hottest expert from the most-loaded rank to the least-loaded rank, moving
half the load gap, until ranks are balanced or constraints bind
(max copies per expert C_max, per-rank replica-slot memory M, one pool
contribution per source rank — see `core.placement`).

Two implementations:

* ``duplicate_experts_host`` — numpy, host-side, used by the serving loop
  at every prediction interval (placement is a host decision in real
  deployments: it changes collective *contents*, not shapes).
* ``duplicate_experts_device`` — the port of the JAX package's jittable
  ``duplicate_experts_jax``: a fixed number of masked iterations in torch
  tensors on the device, for every layer at once, with no host round-trip
  (in-graph planning, ``train.steps.make_prefill_replan_step``).
* ``balanced_loads`` / ``bottleneck_load`` — analytical helpers used by the
  simulator (the JAX package's `core/simulator.py`) to score a plan.

Port note: the host planner is a numpy copy of the JAX package's.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.placement import PlacementPlan, plan_from_assignments, plan_dims


class DuplicationResult(NamedTuple):
    plan: PlacementPlan
    rank_loads: np.ndarray          # fraction of tokens per rank after balancing
    assignments: List[Tuple[int, int]]


def _rank_loads(dist: np.ndarray, ep_ranks: int, n_rep: np.ndarray,
                copy_ranks: List[List[int]]) -> np.ndarray:
    """Per-rank load fraction given per-expert distribution and replica sets.

    Tokens of expert e are split evenly (round-robin dispatch) across its
    replicas, so each hosting rank carries dist[e] / n_rep[e].
    """
    loads = np.zeros((ep_ranks,), np.float64)
    for e, ranks in enumerate(copy_ranks):
        share = dist[e] / len(ranks)
        for r in ranks:
            loads[r] += share
    return loads


def duplicate_experts_host(
    dist: Sequence[float],
    ep_ranks: int,
    dup_slots: int,
    max_copies: int = 4,
    max_iters: int = 64,
    tol: float = 1e-3,
) -> DuplicationResult:
    """Algorithm 1, host-side. ``dist``: per-expert token fraction
    (predicted or observed), sums to 1."""
    dist = np.asarray(dist, np.float64)
    E = dist.shape[0]
    e_loc, n_slots = plan_dims(E, ep_ranks, dup_slots)

    copy_ranks: List[List[int]] = [[e // e_loc] for e in range(E)]
    n_rep = np.ones((E,), np.int64)
    rank_extra = np.zeros((ep_ranks,), np.int64)
    pool_expert = -np.ones((ep_ranks,), np.int64)     # one contribution per src
    assignments: List[Tuple[int, int]] = []

    for _ in range(max_iters):
        loads = _rank_loads(dist, ep_ranks, n_rep, copy_ranks)
        g_hot, g_cold = int(np.argmax(loads)), int(np.argmin(loads))
        if loads[g_hot] - loads[g_cold] <= tol:
            break
        # hottest per-replica load among experts hosted on g_hot
        cand, cand_share = -1, -1.0
        for e in range(E):
            if g_hot in copy_ranks[e]:
                share = dist[e] / n_rep[e]
                if share > cand_share:
                    cand, cand_share = e, share
        if cand < 0:
            break
        src = cand // e_loc
        feasible = (
            n_rep[cand] < max_copies
            and rank_extra[g_cold] < dup_slots
            and g_cold not in copy_ranks[cand]
            and (pool_expert[src] in (-1, cand))
        )
        if not feasible:
            # try the next-hottest feasible expert on g_hot
            order = sorted(
                (e for e in range(E) if g_hot in copy_ranks[e]),
                key=lambda e: dist[e] / n_rep[e], reverse=True)
            placed = False
            for e in order:
                src_e = e // e_loc
                if (n_rep[e] < max_copies and rank_extra[g_cold] < dup_slots
                        and g_cold not in copy_ranks[e]
                        and pool_expert[src_e] in (-1, e)):
                    cand, src = e, src_e
                    placed = True
                    break
            if not placed:
                break
        # accept only if the move improves the bottleneck (greedy with
        # lookahead — the even round-robin split can otherwise overload
        # the cold rank when E/R is small)
        trial_ranks = [list(r) for r in copy_ranks]
        trial_ranks[cand] = trial_ranks[cand] + [g_cold]
        trial_rep = n_rep.copy()
        trial_rep[cand] += 1
        trial_loads = _rank_loads(dist, ep_ranks, trial_rep, trial_ranks)
        if trial_loads.max() >= loads.max() - tol:
            break
        copy_ranks[cand].append(g_cold)
        n_rep[cand] += 1
        rank_extra[g_cold] += 1
        pool_expert[src] = cand
        assignments.append((int(cand), int(g_cold)))

    plan = plan_from_assignments(assignments, E, ep_ranks, dup_slots, max_copies)
    loads = _rank_loads(dist, ep_ranks, n_rep, copy_ranks)
    return DuplicationResult(plan=plan, rank_loads=loads, assignments=assignments)


# ---------------------------------------------------------------------------
# Fixed-iteration variant on the device (in-graph planning)
# ---------------------------------------------------------------------------

def duplicate_experts_device(dist: torch.Tensor, ep_ranks: int,
                             dup_slots: int,
                             max_copies: int = 4) -> PlacementPlan:
    """In-graph Algorithm 1: ``dist`` (L, E) per-layer expert counts or
    fractions (a device tensor) -> a PlacementPlan of (L, ...) int32
    tensors on the same device, equal to ``jax.vmap`` of the JAX package's
    ``duplicate_experts_jax`` over the layers.

    Runs exactly ``ep_ranks * max(dup_slots, 1)`` greedy iterations, each
    masked where no move is feasible, so nothing reads a device value on
    the host: every update is a ``torch.where`` over an indexed write."""
    dist = dist.to(torch.float32)
    L, E = dist.shape
    R, C = ep_ranks, max_copies
    dev = dist.device
    e_loc, n_slots = plan_dims(E, R, dup_slots)
    dist = dist / torch.clamp(dist.sum(-1, keepdim=True), min=1e-9)
    lidx = torch.arange(L, device=dev)
    experts = torch.arange(E, device=dev)
    home_rank = experts // e_loc
    home = home_rank * n_slots + experts % e_loc

    n_rep = torch.ones((L, E), dtype=torch.int32, device=dev)
    # hosted[l, e, r]: expert e has a copy on rank r
    hosted = (home_rank[:, None] == torch.arange(R, device=dev)) \
        .expand(L, E, R).clone()
    table = home.to(torch.int32)[None, :, None].expand(L, E, C).clone()
    pool_expert = torch.full((L, R), -1, dtype=torch.int32, device=dev)
    pool_sel = torch.zeros((L, R, max(dup_slots, 1)), dtype=torch.int32,
                           device=dev)
    rank_extra = torch.zeros((L, R), dtype=torch.int32, device=dev)

    for _ in range(R * max(dup_slots, 1)):
        share = dist / n_rep.to(torch.float32)                 # per-copy load
        # loads[l, r] = sum_e share[l, e] * hosted[l, e, r], a plain fp32
        # sum over e in index order: its summation order is the one place
        # where the plan could differ from XLA's einsum
        hf = hosted.to(torch.float32)
        loads = share[:, 0, None] * hf[:, 0]
        for e in range(1, E):
            loads = loads + share[:, e, None] * hf[:, e]
        g_hot = loads.argmax(-1)                               # first max
        g_cold = loads.argmin(-1)                              # first min
        extra_cold = rank_extra[lidx, g_cold]
        src_pe = pool_expert[:, home_rank]                     # (L, E)
        feasible = (hosted[lidx, :, g_hot]
                    & (n_rep < C)
                    & ~hosted[lidx, :, g_cold]
                    & (extra_cold < dup_slots)[:, None]
                    & ((src_pe == -1) | (src_pe == experts)))
        score = torch.where(feasible, share, -1.0)
        e_star = score.argmax(-1)
        do = ((score[lidx, e_star] > 0.0)
              & (loads[lidx, g_hot] - loads[lidx, g_cold] > 1e-3))

        gslot = (g_cold * n_slots + e_loc + extra_cold).to(torch.int32)
        src_star = home_rank[e_star]
        copy_idx = torch.clamp(n_rep[lidx, e_star], max=C - 1).long()
        table[lidx, e_star, copy_idx] = torch.where(
            do, gslot, table[lidx, e_star, copy_idx])
        n_rep[lidx, e_star] += do.to(torch.int32)
        hosted[lidx, e_star, g_cold] |= do
        pool_expert[lidx, src_star] = torch.where(
            do, e_star.to(torch.int32), pool_expert[lidx, src_star])
        sel_j = torch.clamp(extra_cold, max=pool_sel.shape[2] - 1).long()
        pool_sel[lidx, g_cold, sel_j] = torch.where(
            do, src_star.to(torch.int32), pool_sel[lidx, g_cold, sel_j])
        rank_extra[lidx, g_cold] += do.to(torch.int32)

    return PlacementPlan(n_replicas=n_rep, replica_table=table,
                         pool_expert=torch.clamp(pool_expert, min=0),
                         pool_sel=pool_sel)


def bottleneck_load(dist: np.ndarray, ep_ranks: int) -> float:
    """Max per-rank load fraction with NO duplication (home placement)."""
    E = dist.shape[0]
    e_loc = E // ep_ranks
    loads = np.asarray(dist, np.float64).reshape(ep_ranks, e_loc).sum(-1)
    return float(loads.max())


def skewness(dist: np.ndarray) -> float:
    """Paper Sec 2: max expert share / mean expert share."""
    dist = np.asarray(dist, np.float64)
    dist = dist / max(dist.sum(), 1e-12)
    return float(dist.max() / (1.0 / dist.shape[0]))
