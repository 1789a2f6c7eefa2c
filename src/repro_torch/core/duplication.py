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
* ``balanced_loads`` / ``bottleneck_load`` — analytical helpers used by the
  simulator (the JAX package's `core/simulator.py`) to score a plan.

Port note: numpy-only copy of the JAX package's host planner; the
jittable in-graph variant is not ported yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

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
