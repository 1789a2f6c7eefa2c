"""Greedy waterfill scheduler.

Starts from the even round-robin split and repeatedly moves share of some
expert from a copy on the most-loaded rank to a same-expert copy on the
least-loaded rank, subject to per-slot capacity. Each move levels the pair
of ranks as far as the donor copy and the receiver slot's spare capacity
allow, so the max rank load is non-increasing and the loop terminates when
no expert bridges the extreme ranks (or the gap is negligible).

O(iters * E * C) host-side work per layer, run once per replan window.
"""

from __future__ import annotations

import numpy as np

from repro_torch.schedule.base import TokenScheduler, even_shares


def _loads(tok: np.ndarray, rank_of: np.ndarray, ep_ranks: int) -> np.ndarray:
    out = np.zeros((ep_ranks,), np.float64)
    np.add.at(out, rank_of.reshape(-1), tok.reshape(-1))
    return out


class GreedyWaterfill(TokenScheduler):
    name = "greedy"

    def __init__(self, max_iters: int = 128, tol: float = 1e-6):
        self.max_iters = max_iters
        self.tol = tol

    def shares(self, counts: np.ndarray, n_rep: np.ndarray,
               rank_of: np.ndarray, *, ep_ranks: int,
               cap: float) -> np.ndarray:
        E, C = rank_of.shape
        cols = np.arange(C)[None, :]
        live = cols < np.maximum(n_rep, 1)[:, None]
        sh = even_shares(n_rep, C)
        tok = sh * counts[:, None]                        # (E, C) tokens
        # a copy may legally hold up to `cap`, except when even split
        # already exceeds it (then capacity can't be met; keep even level).
        cap_ec = np.where(live, np.maximum(cap, tok), 0.0)

        for _ in range(self.max_iters):
            loads = _loads(tok, rank_of, ep_ranks)
            tol = self.tol * max(loads.max(), 1.0)
            moved = False
            # donors from most-loaded down, receivers from least-loaded up;
            # take the first donor/receiver pair bridged by some expert
            for r_hi in np.argsort(-loads):
                r_hi = int(r_hi)
                on_hi = live & (rank_of == r_hi) & (tok > 1e-9)
                if not on_hi.any():
                    continue
                for r_lo in np.argsort(loads):
                    r_lo = int(r_lo)
                    gap = loads[r_hi] - loads[r_lo]
                    if gap <= tol:
                        break                      # receivers only get worse
                    on_lo = live & (rank_of == r_lo) & (cap_ec - tok > 1e-9)
                    cand = np.where(on_hi.any(axis=1) & on_lo.any(axis=1))[0]
                    if cand.size == 0:
                        continue
                    # move from the candidate whose donor copy is largest
                    give = np.where(on_hi[cand], tok[cand], 0.0)
                    e = int(cand[np.argmax(give.max(axis=1))])
                    c_hi = int(np.argmax(np.where(on_hi[e], tok[e], -1.0)))
                    spare = np.where(on_lo[e], cap_ec[e] - tok[e], 0.0)
                    c_lo = int(np.argmax(spare))
                    delta = min(gap / 2.0, tok[e, c_hi], spare[c_lo])
                    if delta <= tol:
                        continue
                    tok[e, c_hi] -= delta
                    tok[e, c_lo] += delta
                    moved = True
                    break
                if moved:
                    break
            if not moved:
                break

        safe = np.maximum(counts, 1e-12)[:, None]
        out = np.where(live, tok / safe, 0.0)
        # zero-traffic experts keep the even split
        return np.where(counts[:, None] > 0, out, even_shares(n_rep, C))
