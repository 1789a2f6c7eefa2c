"""Scheduler interface + quota representation.

A *quota* row for expert ``e`` is the quantised cumulative distribution of
its per-copy shares: ``quota[e, c]`` is the threshold (in ``[0, RESCHED_Q]``)
below which a uniform draw lands on copy ``<= c``. Dead copy columns
(``c >= n_replicas[e]``) sit at ``RESCHED_Q`` so they can never be chosen.
The in-graph consumer draws ``u = hash(salt, expert) % RESCHED_Q`` and picks
``choice = #{c : quota[e, c] <= u}`` — an odd multiplicative hash makes the
draws equidistributed, so realized shares track quotas to O(1/T).

Shapes are static: ``(E, C_max) int32`` per layer, stacked to
``(L, E, C_max)`` for the forward. Even quotas reproduce the legacy
round-robin split exactly in expectation.

Port note: the JAX package's ``schedule/base.py`` as it is, numpy only.
``plan_layer`` takes a host ``core.placement.PlacementPlan``; a caller
holding a ``DevicePlan`` passes the host plan it was made from.
"""

from __future__ import annotations

import dataclasses
from abc import ABC, abstractmethod
from typing import Optional, Sequence

import numpy as np

RESCHED_Q = 1 << 16          # quota quantisation denominator
_HASH_MULT = 40503           # odd -> coprime with RESCHED_Q -> equidistributed
_HASH_EXPERT = 131           # decorrelates same-salt draws across experts


@dataclasses.dataclass(frozen=True)
class RescheduleResult:
    """One layer's scheduling decision + predicted effect.

    ``shares`` rows hold fractional per-copy splits (sum to 1 over live
    copies); ``quota`` is their quantised cumulative form consumed by
    dispatch. Overflow numbers are in tokens, measured against the per-slot
    capacity the scheduler was given.
    """
    quota: np.ndarray                # (E, C_max) int32 in [0, RESCHED_Q]
    shares: np.ndarray               # (E, C_max) float64, rows sum to 1
    overflow_even: float             # tokens over slot cap at even split
    overflow_sched: float            # tokens over slot cap at scheduled split
    moved_tokens: float              # tokens redirected vs the even split
    rank_loads_even: np.ndarray      # (R,) tokens per EP rank, even split
    rank_loads_sched: np.ndarray     # (R,) tokens per EP rank, scheduled

    @property
    def imbalance_even(self) -> float:
        m = float(self.rank_loads_even.mean())
        return float(self.rank_loads_even.max() / m) if m > 0 else 1.0

    @property
    def imbalance_sched(self) -> float:
        m = float(self.rank_loads_sched.mean())
        return float(self.rank_loads_sched.max() / m) if m > 0 else 1.0

    @property
    def overflow_absorbed_frac(self) -> float:
        """Predicted fraction of even-split slot overflow the scheduled
        split removes; 1.0 when there was nothing to absorb."""
        if self.overflow_even <= 0:
            return 1.0
        return max(0.0, 1.0 - self.overflow_sched / self.overflow_even)


def _plan_host(plan):
    """(n_rep, table) as host arrays from a host plan."""
    return (np.asarray(plan.n_replicas, np.int64),
            np.asarray(plan.replica_table, np.int64))


def shares_to_quota(shares: np.ndarray, n_rep: np.ndarray) -> np.ndarray:
    """Quantise fractional shares to cumulative int32 thresholds.

    Dead columns are pinned to RESCHED_Q; the last live column is pinned to
    RESCHED_Q too so rounding can never leak probability mass off the end.
    """
    E, C = shares.shape
    cum = np.cumsum(shares, axis=1)
    q = np.rint(cum * RESCHED_Q).astype(np.int64)
    cols = np.arange(C)[None, :]
    live_last = np.maximum(n_rep, 1)[:, None] - 1
    q = np.where(cols >= live_last, RESCHED_Q, q)
    return np.clip(q, 0, RESCHED_Q).astype(np.int32)


def even_shares(n_rep: np.ndarray, max_copies: int) -> np.ndarray:
    """The legacy round-robin split: 1/n_rep on each live copy."""
    E = n_rep.shape[0]
    cols = np.arange(max_copies)[None, :]
    live = cols < np.maximum(n_rep, 1)[:, None]
    return np.where(live, 1.0 / np.maximum(n_rep, 1)[:, None], 0.0)


def even_quota(plan) -> np.ndarray:
    """(E, C_max) int32 quota reproducing the even round-robin split."""
    n_rep, table = _plan_host(plan)
    return shares_to_quota(even_shares(n_rep, table.shape[1]), n_rep)


def even_quota_stack(num_layers: int, plan) -> np.ndarray:
    """(L, E, C_max) even quotas — the lever-off tensor engines feed so the
    jitted signature stays fixed across lever switches."""
    q = even_quota(plan)
    return np.broadcast_to(q, (num_layers,) + q.shape).copy()


def quota_realized_shares(quota: np.ndarray) -> np.ndarray:
    """Invert a quota row back to fractional shares (for tests/audit)."""
    q = quota.astype(np.float64) / RESCHED_Q
    return np.diff(np.concatenate([np.zeros((q.shape[0], 1)), q], axis=1),
                   axis=1)


def rank_loads(shares: np.ndarray, counts: np.ndarray, rank_of: np.ndarray,
               ep_ranks: int) -> np.ndarray:
    """(R,) tokens landing on each EP rank under fractional shares."""
    tok = shares * counts[:, None]                       # (E, C)
    out = np.zeros((ep_ranks,), np.float64)
    np.add.at(out, rank_of.reshape(-1), tok.reshape(-1))
    return out


def slot_overflow(shares: np.ndarray, counts: np.ndarray, n_rep: np.ndarray,
                  cap: float) -> float:
    """Tokens exceeding per-slot capacity, summed over live copies."""
    tok = shares * counts[:, None]
    cols = np.arange(shares.shape[1])[None, :]
    live = cols < np.maximum(n_rep, 1)[:, None]
    return float(np.maximum(np.where(live, tok, 0.0) - cap, 0.0).sum())


class TokenScheduler(ABC):
    """One-layer scheduling interface: histogram in, quota + prediction out.

    ``cap`` is the aggregate per-slot token capacity for the window being
    planned (source-rank capacity x EP ranks on the sharded prefill path).
    """

    name: str = "base"

    @abstractmethod
    def shares(self, counts: np.ndarray, n_rep: np.ndarray,
               rank_of: np.ndarray, *, ep_ranks: int,
               cap: float) -> np.ndarray:
        """Return (E, C_max) fractional per-copy shares (rows sum to 1)."""

    def plan_layer(self, counts: np.ndarray, plan, *, ep_ranks: int,
                   dup_slots: int, cap: float) -> RescheduleResult:
        counts = np.asarray(counts, np.float64)
        n_rep, table = _plan_host(plan)
        n_slots = counts.shape[0] // ep_ranks + dup_slots
        # rank hosting each copy; dead columns alias the home rank (share 0)
        rank_of = (table // n_slots).astype(np.int64)

        ev = even_shares(n_rep, table.shape[1])
        sh = self.shares(counts, n_rep, rank_of, ep_ranks=ep_ranks, cap=cap)
        # normalise defensively: rows must be a distribution over live copies
        cols = np.arange(sh.shape[1])[None, :]
        live = cols < np.maximum(n_rep, 1)[:, None]
        sh = np.where(live, np.maximum(sh, 0.0), 0.0)
        norm = sh.sum(axis=1, keepdims=True)
        sh = np.where(norm > 0, sh / np.maximum(norm, 1e-12), ev)

        moved = 0.5 * float((np.abs(sh - ev) * counts[:, None]).sum())
        return RescheduleResult(
            quota=shares_to_quota(sh, n_rep),
            shares=sh,
            overflow_even=slot_overflow(ev, counts, n_rep, cap),
            overflow_sched=slot_overflow(sh, counts, n_rep, cap),
            moved_tokens=moved,
            rank_loads_even=rank_loads(ev, counts, rank_of, ep_ranks),
            rank_loads_sched=rank_loads(sh, counts, rank_of, ep_ranks),
        )

    def plan_stack(self, counts: np.ndarray, plans: Sequence, *,
                   ep_ranks: int, dup_slots: int, cap: float):
        """Plan L layers: counts (L, E), per-layer plans. Returns the
        stacked (L, E, C_max) int32 quota plus per-layer results."""
        results = [self.plan_layer(counts[l], plans[l], ep_ranks=ep_ranks,
                                   dup_slots=dup_slots, cap=cap)
                   for l in range(counts.shape[0])]
        return np.stack([r.quota for r in results]), results


def make_scheduler(impl: str) -> TokenScheduler:
    from repro_torch.schedule.greedy import GreedyWaterfill
    from repro_torch.schedule.lp import TransportLP
    impls = {"greedy": GreedyWaterfill, "lp": TransportLP}
    if impl not in impls:
        raise ValueError(f"unknown scheduler impl {impl!r}; "
                         f"choose from {sorted(impls)}")
    return impls[impl]()
