"""Transportation-LP scheduler (refinement of the greedy waterfill).

The exact problem — minimise the max EP-rank load subject to per-slot
capacity and per-expert conservation — is a transportation LP over the
(expert x rank) histogram. We solve it dependency-free by binary-searching
the load bound ``z`` and checking feasibility with a max-flow:

    source --counts[e]--> expert e --cap(e,r)--> rank r --z--> sink

where ``cap(e, r)`` sums the slot capacities of ``e``'s live copies on
``r``. A bound is feasible iff the max flow saturates every source edge.
The smallest feasible ``z`` (to ``tol`` x total tokens) gives the optimal
assignment; per-copy shares are recovered by filling each rank's copies in
table order. Greedy's solution seeds the upper bound, so the LP never
returns a worse max load than the waterfill.

Edmonds–Karp on a ``2 + E + R`` node graph; ~30 feasibility probes per
layer per replan window, on the host.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.schedule.base import TokenScheduler, even_shares
from repro_torch.schedule.greedy import GreedyWaterfill, _loads


def _max_flow(cap: np.ndarray, s: int, t: int) -> np.ndarray:
    """Edmonds–Karp. cap: (V, V) float capacities. Returns the flow matrix."""
    V = cap.shape[0]
    flow = np.zeros_like(cap)
    while True:
        # BFS for a shortest augmenting path in the residual graph
        parent = np.full((V,), -1, np.int64)
        parent[s] = s
        q = deque([s])
        while q and parent[t] < 0:
            u = q.popleft()
            resid = cap[u] - flow[u]
            for v in np.where((resid > 1e-12) & (parent < 0))[0]:
                parent[v] = u
                q.append(int(v))
        if parent[t] < 0:
            return flow
        # bottleneck along the path, then augment
        push = np.inf
        v = t
        while v != s:
            u = int(parent[v])
            push = min(push, cap[u, v] - flow[u, v])
            v = u
        v = t
        while v != s:
            u = int(parent[v])
            flow[u, v] += push
            flow[v, u] -= push
            v = u


class TransportLP(TokenScheduler):
    name = "lp"

    def __init__(self, tol: float = 1e-3, max_probes: int = 30):
        self.tol = tol
        self.max_probes = max_probes
        self._greedy = GreedyWaterfill()

    def shares(self, counts: np.ndarray, n_rep: np.ndarray,
               rank_of: np.ndarray, *, ep_ranks: int,
               cap: float) -> np.ndarray:
        E, C = rank_of.shape
        total = float(counts.sum())
        if total <= 0:
            return even_shares(n_rep, C)
        cols = np.arange(C)[None, :]
        live = cols < np.maximum(n_rep, 1)[:, None]
        even_tok = even_shares(n_rep, C) * counts[:, None]
        cap_ec = np.where(live, np.maximum(cap, even_tok), 0.0)  # per copy

        # aggregate copy capacity per (expert, rank)
        cap_er = np.zeros((E, ep_ranks), np.float64)
        for e in range(E):
            for c in range(int(max(n_rep[e], 1))):
                cap_er[e, int(rank_of[e, c])] += cap_ec[e, c]

        greedy_sh = self._greedy.shares(counts, n_rep, rank_of,
                                        ep_ranks=ep_ranks, cap=cap)
        greedy_tok = greedy_sh * counts[:, None]
        hi = float(_loads(greedy_tok, rank_of, ep_ranks).max())
        lo = total / ep_ranks

        # node ids: 0 = source, 1..E = experts, E+1..E+R = ranks, last = sink
        V = 2 + E + ep_ranks
        s, t = 0, V - 1
        base = np.zeros((V, V), np.float64)
        base[s, 1:1 + E] = counts
        base[1:1 + E, 1 + E:1 + E + ep_ranks] = cap_er

        best_flow = None
        for _ in range(self.max_probes):
            if hi - lo <= self.tol * total:
                break
            z = 0.5 * (lo + hi)
            g = base.copy()
            g[1 + E:1 + E + ep_ranks, t] = z
            f = _max_flow(g, s, t)
            if f[s].sum() >= total - 1e-6 * total:
                hi = z
                best_flow = f
            else:
                lo = z

        if best_flow is None:
            return greedy_sh                      # LP couldn't beat greedy
        flow_er = best_flow[1:1 + E, 1 + E:1 + E + ep_ranks]  # (E, R)

        # recover per-copy tokens: fill each rank's copies in table order
        tok = np.zeros((E, C), np.float64)
        for e in range(E):
            remaining = flow_er[e].copy()
            for c in range(int(max(n_rep[e], 1))):
                r = int(rank_of[e, c])
                take = min(cap_ec[e, c], remaining[r])
                tok[e, c] = take
                remaining[r] -= take
        safe = np.maximum(counts, 1e-12)[:, None]
        out = np.where(live, tok / safe, 0.0)
        return np.where(counts[:, None] > 0, out, even_shares(n_rep, C))
