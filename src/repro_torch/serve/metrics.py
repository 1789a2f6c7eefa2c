"""SLO metrics for the serving subsystem (the port's copy of the JAX
package's ``serve/metrics.py``, without the migration, rescheduling and
dispatch-phase columns of the paths not ported yet).

Per-request: TTFT (arrival -> first token), TPOT (mean inter-token time),
end-to-end latency. Per-window: throughput, goodput (completions meeting
their SLOs), measured skew, and per-rank load imbalance derived from the
expert histogram + the ACTIVE placement plan (so the reported imbalance is
what the cluster would carry under the engine's current duplication plan,
not the raw expert skew).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.placement import PlacementPlan, plan_dims
from repro_torch.obs.metrics import MetricsRegistry


# ---------------------------------------------------------------------------
# per-request accounting
# ---------------------------------------------------------------------------

@dataclass
class RequestTiming:
    rid: int
    arrival: float
    t_first_token: float
    t_finished: float
    prompt_len: int
    new_tokens: int
    n_preemptions: int = 0
    tenant: str = ""

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.arrival

    @property
    def tpot(self) -> float:
        if self.new_tokens <= 1:
            return 0.0
        return (self.t_finished - self.t_first_token) / (self.new_tokens - 1)

    @property
    def latency(self) -> float:
        return self.t_finished - self.arrival


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


# ---------------------------------------------------------------------------
# plan-aware imbalance
# ---------------------------------------------------------------------------

def plan_rank_loads(counts: np.ndarray, plan: Optional[PlacementPlan],
                    ep_ranks: int, dup_slots: int) -> np.ndarray:
    """Expected per-rank token load for one window.

    counts: (L, E) expert histogram. Tokens for expert e split round-robin
    over its ``n_replicas[e]`` copies (plan semantics); with no plan every
    expert sits in its home slot. Returns (L, R) loads."""
    counts = np.asarray(counts, np.float64)
    L, E = counts.shape
    e_loc, n_slots = plan_dims(E, ep_ranks, dup_slots)
    loads = np.zeros((L, ep_ranks), np.float64)
    if plan is None:
        home_rank = np.arange(E) // e_loc
        for l in range(L):
            np.add.at(loads[l], home_rank, counts[l])
        return loads
    n_rep = np.asarray(plan.n_replicas)          # (L, E) stacked plans
    table = np.asarray(plan.replica_table)       # (L, E, C_max)
    for l in range(L):
        for e in range(E):
            k = max(int(n_rep[l, e]), 1)
            share = counts[l, e] / k
            for c in range(k):
                rank = int(table[l, e, c]) // n_slots
                loads[l, rank] += share
    return loads


def imbalance(loads: np.ndarray) -> float:
    """max/mean over ranks, averaged over layers (1.0 = perfect)."""
    loads = np.asarray(loads, np.float64)
    mean = np.maximum(loads.mean(axis=-1), 1e-12)
    return float((loads.max(axis=-1) / mean).mean())


def window_skew(counts: np.ndarray) -> float:
    """Measured skewness of an aggregated (L, E) expert histogram:
    max share x E per layer, averaged over layers (paper Sec 2). The ONE
    definition both the metrics windows and the GPS controller report —
    the controller's switching signal must equal the printed skew column."""
    c = np.asarray(counts, np.float64)
    p = c / np.maximum(c.sum(axis=1, keepdims=True), 1e-12)
    return float((p.max(axis=1) * p.shape[1]).mean())


# ---------------------------------------------------------------------------
# rolling serve metrics
# ---------------------------------------------------------------------------

@dataclass
class WindowRecord:
    t_start: float
    t_end: float
    iterations: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    completions: int = 0
    skew: float = 0.0
    imbalance: float = 1.0
    strategy: str = ""
    # predictor accuracy of the prediction window(s) closing inside this
    # metrics window (repro.obs.accuracy; nan until one closes)
    pred_hit_rate: float = float("nan")
    pred_kl: float = float("nan")


class ServeMetrics:
    """Collects per-iteration + per-request events; summarises SLOs."""

    def __init__(self, window_iters: int = 16, slo_ttft: float = float("inf"),
                 slo_tpot: float = float("inf"),
                 registry: Optional[MetricsRegistry] = None,
                 model: str = ""):
        self.window_iters = window_iters
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        # every summary() key is published here as a serve_* gauge, and
        # per-request timings as histograms — scrape via
        # registry.to_prometheus() / registry.to_jsonl(). When several
        # model instances share one registry (fleet serving), ``model``
        # becomes a label on every serve_* series so co-resident engines
        # don't overwrite each other; empty keeps the historical unlabeled
        # series names.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.model = model
        self._labels: Dict[str, str] = {"model": model} if model else {}
        self.timings: List[RequestTiming] = []
        self.windows: List[WindowRecord] = []
        # re-plan accounting: how many re-plans ran, and how many of them
        # replicated at least one expert (any layer's plan holds an extra
        # copy); the port's engine swaps plans without weight migration
        self.replan_count: float = 0.0
        self.replicated_replans: float = 0.0
        # every iteration's wall seconds (host clock, after the step's
        # results reached the host) for the step-time percentiles
        self.step_walls: List[float] = []
        # decode fast-path accounting: wall seconds and emitted tokens of
        # pure-decode iterations (prefill_tokens == 0) feed the
        # decode_toks_per_s summary column; live/alloc block counts from
        # the paged-attention block tables feed the fused-vs-gather
        # attention-compute roofline (the gather oracle materializes and
        # attends over every allocated table column, the fused kernel only
        # touches live blocks)
        self._decode_wall_s: float = 0.0
        self._decode_tokens_n: float = 0.0
        self._attn_live_blocks: float = 0.0
        self._attn_alloc_blocks: float = 0.0
        self._win_counts: Optional[np.ndarray] = None
        self._win: Optional[WindowRecord] = None
        self._t0: Optional[float] = None
        self._t_last: float = 0.0

    # ------------------------------------------------------------- per-iter
    def record_iteration(self, now: float, dt: float, *, prefill_tokens: int,
                         decode_tokens: int, counts: Optional[np.ndarray],
                         plan: Optional[PlacementPlan], ep_ranks: int,
                         dup_slots: int, strategy: str = "",
                         wall_s: float = 0.0,
                         attn_live_blocks: float = 0.0,
                         attn_alloc_blocks: float = 0.0):
        if self._t0 is None:
            self._t0 = now
        self._t_last = now + dt
        self.step_walls.append(float(wall_s))
        if prefill_tokens == 0 and decode_tokens > 0:
            self._decode_wall_s += float(wall_s)
            self._decode_tokens_n += float(decode_tokens)
            self._attn_live_blocks += float(attn_live_blocks)
            self._attn_alloc_blocks += float(attn_alloc_blocks)
        if self._win is None:
            self._win = WindowRecord(t_start=now, t_end=now + dt,
                                     strategy=strategy)
        w = self._win
        w.iterations += 1
        w.t_end = now + dt
        w.prefill_tokens += prefill_tokens
        w.decode_tokens += decode_tokens
        w.strategy = strategy
        if counts is not None:
            c = np.asarray(counts, np.float64)
            self._win_counts = c if self._win_counts is None \
                else self._win_counts + c
        if w.iterations >= self.window_iters:
            self._close_window(plan, ep_ranks, dup_slots)

    def _close_window(self, plan, ep_ranks: int, dup_slots: int):
        w = self._win
        if w is None:
            return
        if self._win_counts is not None:
            agg = self._win_counts
            w.skew = window_skew(agg)
            if ep_ranks > 1:
                w.imbalance = imbalance(
                    plan_rank_loads(agg, plan, ep_ranks, dup_slots))
        self.windows.append(w)
        self._win = None
        self._win_counts = None

    def flush(self, plan=None, ep_ranks: int = 1, dup_slots: int = 0):
        self._close_window(plan, ep_ranks, dup_slots)

    # -------------------------------------------------------------- replans
    def record_replan(self, extra_copies: int) -> None:
        """Account one re-plan; ``extra_copies`` = replica copies beyond
        the home copies, summed over layers and experts."""
        self.replan_count += 1.0
        self.replicated_replans += float(extra_copies > 0)

    # ---------------------------------------------------------- per-request
    def record_completion(self, t: RequestTiming):
        self.timings.append(t)
        if self._win is not None:
            self._win.completions += 1
        reg = self.registry
        lbl = self._labels
        reg.counter("serve_requests_completed_total",
                    "Requests that finished decoding", **lbl).inc()
        reg.histogram("serve_ttft_seconds",
                      "Time to first token", **lbl).observe(t.ttft)
        if t.new_tokens > 1:
            reg.histogram("serve_tpot_seconds",
                          "Mean inter-token time per request",
                          **lbl).observe(t.tpot)
        reg.histogram("serve_latency_seconds",
                      "End-to-end request latency", **lbl).observe(t.latency)

    # ------------------------------------------------- predictor accuracy
    def record_accuracy(self, hit_rate: float, kl: float) -> None:
        """Attach the score of the prediction window that just closed to
        the open (or latest) metrics window, so per-window rows carry the
        predictor-accuracy columns next to skew/imbalance."""
        w = self._win if self._win is not None else \
            (self.windows[-1] if self.windows else None)
        if w is not None:
            w.pred_hit_rate = float(hit_rate)
            w.pred_kl = float(kl)
        reg = self.registry
        reg.gauge("serve_pred_hit_rate",
                  "Predictor top-1 hot-expert hit rate, last closed "
                  "prediction window", **self._labels).set(float(hit_rate))
        reg.gauge("serve_pred_kl",
                  "KL(realized || predicted), last closed prediction "
                  "window", **self._labels).set(float(kl))

    # -------------------------------------------------------------- summary
    def summary(self) -> Dict[str, float]:
        ts = self.timings
        ttfts = [t.ttft for t in ts]
        tpots = [t.tpot for t in ts if t.new_tokens > 1]
        lats = [t.latency for t in ts]
        horizon = max((self._t_last - self._t0) if self._t0 is not None
                      else 0.0, 1e-9)
        good = [t for t in ts
                if t.ttft <= self.slo_ttft and t.tpot <= self.slo_tpot]
        total_tokens = sum(t.new_tokens for t in ts)
        out = {
            "replans": self.replan_count,
            "replicated_replans": self.replicated_replans,
            "step_p50_s": _pct(self.step_walls, 50),
            "step_p99_s": _pct(self.step_walls, 99),
            "completed": float(len(ts)),
            "ttft_p50": _pct(ttfts, 50), "ttft_p99": _pct(ttfts, 99),
            "tpot_mean": float(np.mean(tpots)) if tpots else 0.0,
            "tpot_p99": _pct(tpots, 99),
            "latency_p50": _pct(lats, 50), "latency_p99": _pct(lats, 99),
            "throughput_tok_s": total_tokens / horizon,
            "throughput_req_s": len(ts) / horizon,
            "goodput_req_s": len(good) / horizon,
            "preemptions": float(sum(t.n_preemptions for t in ts)),
        }
        # decode fast path: wall-clock decode throughput plus the
        # attention-compute roofline ratio (allocated table blocks the
        # gather oracle covers / live blocks the fused kernel computes).
        # The ratio is structurally >= 1.0 — it is the fused kernel's
        # block-skip advantage measured from real engine block-table state.
        if self._decode_wall_s > 0:
            out["decode_toks_per_s"] = \
                self._decode_tokens_n / self._decode_wall_s
        if self._attn_alloc_blocks > 0:
            out["fused_vs_gather_speedup"] = (
                self._attn_alloc_blocks / max(self._attn_live_blocks, 1.0))
        # publish every summary column through the registry so the same
        # numbers are scrapeable (Prometheus text / JSONL) without a second
        # hand-rolled aggregation path
        for k, v in out.items():
            self.registry.gauge(
                f"serve_{k}", f"ServeMetrics summary column {k}",
                **self._labels).set(v)
        return out

    # --------------------------------------------------------- SLO per tenant
    def slo_attainment(self, *, tenant: Optional[str] = None,
                       slo_ttft: Optional[float] = None,
                       slo_tpot: Optional[float] = None) -> float:
        """Fraction of completed requests meeting the SLOs, optionally
        restricted to one tenant and/or overriding the instance SLOs with
        a tenant class's targets. 1.0 with no matching completions — no
        evidence of violation is not a violation (the fleet arbiter must
        not starve a model for having served nothing yet)."""
        ttft = self.slo_ttft if slo_ttft is None else slo_ttft
        tpot = self.slo_tpot if slo_tpot is None else slo_tpot
        ts = [t for t in self.timings
              if tenant is None or t.tenant == tenant]
        if not ts:
            return 1.0
        good = sum(1 for t in ts if t.ttft <= ttft and t.tpot <= tpot)
        return good / len(ts)

    def imbalance_over_time(self) -> List[float]:
        return [w.imbalance for w in self.windows]

    def skew_over_time(self) -> List[float]:
        return [w.skew for w in self.windows]
