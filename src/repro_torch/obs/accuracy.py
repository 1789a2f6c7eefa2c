"""Predictor-accuracy tracking: predicted vs realized expert histograms.

The paper trades predictor accuracy against overhead; "Prediction Is All
MoE Needs" (arXiv 2404.16914) shows that accuracy drifts over a serving
session as expert load stabilises. This tracker makes the tradeoff
measurable at runtime: at every re-plan boundary the engine snapshots the
(L, E) distribution the predictor committed to (the one Algorithm 1 just
planned from) and, one prediction window later, scores it against the
expert histogram the window actually routed:

  * ``hit_rate`` — per-layer top-1 hot-expert agreement (did the planned
    hottest expert stay the hottest?), the quantity duplication quality
    depends on;
  * ``kl``       — KL(realized || predicted), the estimation error the
    simulator's ``eps`` models (paper Table 1);
  * ``l1``       — total-variation distance, a bounded [0, 1] drift column.

The window's ``strategy`` tag separates Distribution-Only error (EMA
staleness: the estimate lags a shifting distribution) from
Token-to-Expert error (model quality: the predictor's histogram simply
misses), the two failure modes the GPS guideline arbitrates between.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

_EPS = 1e-9


def hist_hit_rate(predicted: np.ndarray, realized: np.ndarray) -> float:
    """Fraction of layers whose predicted argmax expert matched the
    realized argmax."""
    p = np.asarray(predicted, np.float64)
    r = np.asarray(realized, np.float64)
    return float((p.argmax(axis=1) == r.argmax(axis=1)).mean())


def hist_kl(predicted: np.ndarray, realized: np.ndarray) -> float:
    """KL(realized || predicted) per layer, averaged (nats). Smoothed so
    experts the predictor zeroed out stay finite."""
    p = np.asarray(predicted, np.float64) + _EPS
    r = np.asarray(realized, np.float64) + _EPS
    p /= p.sum(axis=1, keepdims=True)
    r /= r.sum(axis=1, keepdims=True)
    return float((r * np.log(r / p)).sum(axis=1).mean())


def hist_l1(predicted: np.ndarray, realized: np.ndarray) -> float:
    """Total-variation distance per layer, averaged (in [0, 1])."""
    p = np.asarray(predicted, np.float64) + _EPS
    r = np.asarray(realized, np.float64) + _EPS
    p /= p.sum(axis=1, keepdims=True)
    r /= r.sum(axis=1, keepdims=True)
    return float(0.5 * np.abs(p - r).sum(axis=1).mean())


@dataclass
class WindowAccuracy:
    """Score of one prediction window."""
    index: int
    strategy: str          # dist_only | token_to_expert (the predictor used)
    tokens: float          # realized routed tokens in the window
    hit_rate: float
    kl: float
    l1: float


class PredictorAccuracyTracker:
    """Accumulates realized histograms against the window's prediction."""

    def __init__(self, num_layers: int, num_experts: int):
        self.num_layers = int(num_layers)
        self.num_experts = int(num_experts)
        self.windows: List[WindowAccuracy] = []
        self._pred: Optional[np.ndarray] = None
        self._strategy: str = ""
        self._realized: Optional[np.ndarray] = None

    def begin_window(self, predicted_dist: Optional[np.ndarray],
                     strategy: str) -> None:
        """Snapshot the (L, E) distribution a re-plan just committed to.
        ``None`` (strategy "none", or nothing predicted yet) records no
        window — there is no prediction to score."""
        self._pred = (None if predicted_dist is None
                      else np.asarray(predicted_dist, np.float64).copy())
        self._strategy = strategy
        self._realized = None

    def observe(self, counts: Optional[np.ndarray]) -> None:
        """Feed one iteration's realized (L, E) expert histogram."""
        if counts is None:
            return
        c = np.asarray(counts, np.float64)
        self._realized = c.copy() if self._realized is None \
            else self._realized + c

    def close_window(self) -> Optional[WindowAccuracy]:
        """Score the open window; returns None when there was no
        prediction or no routed tokens to score it against."""
        pred, realized = self._pred, self._realized
        self._pred = None
        self._realized = None
        if pred is None or realized is None or realized.sum() <= 0:
            return None
        w = WindowAccuracy(index=len(self.windows), strategy=self._strategy,
                           tokens=float(realized.sum()),
                           hit_rate=hist_hit_rate(pred, realized),
                           kl=hist_kl(pred, realized),
                           l1=hist_l1(pred, realized))
        self.windows.append(w)
        return w

    # ----------------------------------------------------------- reporting
    def summary(self) -> Dict[str, float]:
        """Flat scalar columns for the bench JSON schema: overall means
        plus per-error-mode means (dist_only vs token_to_expert)."""
        out: Dict[str, float] = {"pred_windows": float(len(self.windows))}
        if not self.windows:
            return out
        def _mean(ws, attr):
            return float(np.mean([getattr(w, attr) for w in ws]))
        out["pred_hit_rate"] = _mean(self.windows, "hit_rate")
        out["pred_kl"] = _mean(self.windows, "kl")
        out["pred_l1"] = _mean(self.windows, "l1")
        for mode in ("dist_only", "token_to_expert"):
            ws = [w for w in self.windows if w.strategy == mode]
            if ws:
                key = "dist" if mode == "dist_only" else "t2e"
                out[f"pred_{key}_windows"] = float(len(ws))
                out[f"pred_{key}_hit_rate"] = _mean(ws, "hit_rate")
                out[f"pred_{key}_kl"] = _mean(ws, "kl")
        return out

    def to_obj(self) -> List[Dict]:
        return [{"index": w.index, "strategy": w.strategy,
                 "tokens": w.tokens, "hit_rate": w.hit_rate, "kl": w.kl,
                 "l1": w.l1} for w in self.windows]
