"""MoE-GPS: select the prediction strategy that minimises end-to-end latency.

Sweeps {no prediction, Distribution-Only, Token-to-Expert x accuracy ladder}
through the simulator for a (model, hardware, skewness) point and returns
the argmin plus the Fig-1-style guideline decision. The port's copy of the
JAX package's ``core/gps.py`` (numpy only, the same arithmetic); the
Token-to-Expert ladder here is arithmetic and needs no predictor.

Inputs that come from *measurement* (the JAX package's
``benchmarks/bench_fig4.py`` measures them on synthetic corpora with its
predictor ladder):
  * ``dist_eps(skew)``      — Distribution-Only estimation error vs skew
                              (paper Table 1).
  * ``t2e_curve(skew)``     — list of (accuracy, overhead_frac) points for
                              the Token-to-Expert ladder (paper Fig 4); the
                              paper fits an exponential overhead(accuracy).

Defaults below are calibrated to the paper's reported numbers so the
simulator reproduces Fig 6/7 without re-measuring.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.simulator import (HardwareConfig, LatencyBreakdown,
                                  layer_latency)


# ---------------------------------------------------------------------------
# measured-input defaults (paper-calibrated)
# ---------------------------------------------------------------------------

# Paper Table 1: (skew, error_rate). Error grows superlinearly with skew
# because cold experts see few tokens (Sec 3.2.1).
_TABLE1 = [(1.39, 0.018), (1.40, 0.0098), (1.99, 0.16)]


def default_dist_eps(skew: float) -> float:
    """Piecewise-linear interpolation of Table 1 (clamped outside)."""
    pts = sorted(_TABLE1)
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return float(np.interp(skew, xs, ys))


# Paper Fig 4: the predictor ladder. Accuracy rises with skew (hot experts
# are easy targets); overhead_frac is overhead / model runtime measured on
# the same device. Exponential fit overhead(acc) = a * exp(b * acc) with
# skew-dependent ease: at higher skew the same accuracy costs less.
@dataclass(frozen=True)
class T2EPoint:
    name: str
    accuracy: float
    overhead_frac: float


def default_t2e_curve(skew: float) -> List[T2EPoint]:
    """Predictor ladder calibrated to Fig 4 (Mixtral; skew in [1.4, 2.0]).

    Baseline accuracy floor = probability model ~= skew/E by construction
    (always guess the hottest expert); neural predictors climb toward ~0.9
    with exponentially growing overhead, discounted by skew (Sec 4:
    "higher skewness makes prediction easier").
    """
    e_floor = min(0.95, skew / 8.0)           # hottest-expert hit rate
    ease = 1.0 / max(skew, 1.0) ** 2          # overhead discount at high skew
    ladder = [
        ("probability", max(0.18, e_floor), 0.001),
        ("conditional", min(0.55, e_floor + 0.25), 0.01),
        ("ffn", 0.75, 0.08 * ease * 4),
        ("ffn-wide", 0.85, 0.20 * ease * 4),
        ("lstm", 0.92, 0.45 * ease * 4),
        ("lstm-large", 0.97, 0.90 * ease * 4),
    ]
    return [T2EPoint(n, a, o) for n, a, o in ladder]


def fit_overhead_curve(points: Sequence[T2EPoint]) -> Callable[[float], float]:
    """Paper Sec 3.2.2: exponential fit overhead(acc) = a * exp(b * acc).
    Least squares in log space over points with positive overhead."""
    xs = np.array([p.accuracy for p in points if p.overhead_frac > 0])
    ys = np.array([p.overhead_frac for p in points if p.overhead_frac > 0])
    if len(xs) < 2:
        return lambda a: float(ys[0]) if len(ys) else 0.0
    b, log_a = np.polyfit(xs, np.log(ys), 1)
    return lambda acc: float(math.exp(log_a) * math.exp(b * acc))


# ---------------------------------------------------------------------------
# strategy selection
# ---------------------------------------------------------------------------

LEVERS = ("duplicate", "reschedule", "both")


class StrategyVerdict(str):
    """Verdict over the combined strategy space (prediction x lever).

    Subclasses ``str`` so it compares, hashes and serialises as the
    prediction-mode name ("none" | "dist_only" | "token_to_expert") —
    pre-lever callers that do ``name == "dist_only"`` keep working — while
    carrying which balancing *lever* the prediction should drive:
    ``duplicate`` (move weights), ``reschedule`` (move tokens) or ``both``.
    """
    lever: str

    def __new__(cls, prediction: str, lever: str = "duplicate"):
        self = super().__new__(cls, prediction)
        self.lever = "none" if prediction == "none" else lever
        return self

    @property
    def prediction(self) -> str:
        return str(self)

    @property
    def combined(self) -> str:
        """Render for audit logs: e.g. ``dist_only+reschedule``."""
        if str(self) == "none":
            return "none"
        return f"{str(self)}+{self.lever}"


@dataclass
class StrategyResult:
    strategy: str                     # none | dist_only | token_to_expert
    accuracy: float
    latency: LatencyBreakdown
    predictor: str = ""
    lever: str = "duplicate"

    @property
    def total(self) -> float:
        return self.latency.total


@dataclass
class GPSReport:
    model: str
    hardware: str
    skew: float
    baseline: StrategyResult
    dist_only: StrategyResult
    t2e_points: List[StrategyResult]
    comm_model: str = "paper"
    # lever-costed grid {dist_only, t2e ladder} x levers (run_gps(levers=...));
    # empty when only the paper's duplicate lever was evaluated pre-lever-API.
    combos: List[StrategyResult] = field(default_factory=list)

    @property
    def best_t2e(self) -> StrategyResult:
        return min(self.t2e_points, key=lambda r: r.total)

    @property
    def best(self) -> StrategyResult:
        return min([self.dist_only, self.best_t2e], key=lambda r: r.total)

    @property
    def dist_only_saving(self) -> float:
        return 1.0 - self.dist_only.total / self.baseline.total

    @property
    def t2e_saving(self) -> float:
        return 1.0 - self.best_t2e.total / self.baseline.total

    @property
    def saving_difference(self) -> float:
        """Fig 7: dist_only saving - best t2e saving ( >0 => dist_only wins)."""
        return self.dist_only_saving - self.t2e_saving

    @property
    def best_combo(self) -> StrategyResult:
        """Argmin over the lever-costed grid (falls back to the duplicate
        lever's legacy results when no combos were evaluated)."""
        pool = self.combos or ([self.dist_only] + self.t2e_points)
        return min(pool, key=lambda r: r.total)

    def best_for_lever(self, lever: str) -> Optional[StrategyResult]:
        pool = [r for r in self.combos if r.lever == lever]
        return min(pool, key=lambda r: r.total) if pool else None

    def saving_of(self, r: StrategyResult) -> float:
        return 1.0 - r.total / self.baseline.total

    @property
    def reschedule_saving(self) -> float:
        """Best reschedule-lever saving vs no balancing (0 if not costed)."""
        best = self.best_for_lever("reschedule")
        return self.saving_of(best) if best is not None else 0.0

    @property
    def dist_only_speedup_over_t2e(self) -> float:
        """Headline metric: how much faster dist-only is than the best T2E
        point (paper: >23% on Mixtral/MMLU/NVLink)."""
        return self.best_t2e.total / self.dist_only.total - 1.0

    def guideline(self) -> str:
        """Fig 1 decision, phrased as the paper's guidance."""
        comm_frac = ((self.baseline.latency.dispatch
                      + self.baseline.latency.combine
                      + self.baseline.latency.allreduce)
                     / self.baseline.latency.total)
        who = ("Distribution-Only" if self.best is self.dist_only
               else f"Token-to-Expert (acc={self.best.accuracy:.2f})")
        why = []
        why.append(f"communication is {comm_frac:.0%} of baseline latency"
                   + (" (not a bottleneck)" if comm_frac < 0.3 else
                      " (a bottleneck)"))
        why.append(f"skewness {self.skew:.2f} is "
                   + ("low: accurate token-level prediction is expensive"
                      if self.skew < 1.7 else
                      "high: accurate token-level prediction is cheap"))
        return f"use {who} — " + "; ".join(why)

    def summary_rows(self) -> List[Dict]:
        rows = [
            dict(strategy="none", accuracy=0.0, predictor="-",
                 **self.baseline.latency.as_dict()),
            dict(strategy="dist_only", accuracy=self.dist_only.accuracy,
                 predictor="mle", **self.dist_only.latency.as_dict()),
        ]
        for r in self.t2e_points:
            rows.append(dict(strategy="token_to_expert", accuracy=r.accuracy,
                             predictor=r.predictor, **r.latency.as_dict()))
        return rows


def run_gps(
    cfg: ModelConfig,
    hw: HardwareConfig,
    *,
    batch: int = 1,
    seq: int = 512,
    skew: float = 1.4,
    dist_eps: Optional[Callable[[float], float]] = None,
    t2e_curve: Optional[Sequence[T2EPoint]] = None,
    scenario: str = "typical",
    comm_model: str = "paper",
    migration_stall_s: float = 0.0,
    migration_hidden_frac: float = 0.0,
    levers: Sequence[str] = ("duplicate",),
    resched_residual: float = 0.05,
    resched_extra_frac: float = 0.10,
    dup_hbm_bytes: float = 0.0,
) -> GPSReport:
    """Evaluate all strategies for one (model, hardware, skew) point.

    ``migration_stall_s``: per-layer-per-step replica-weight migration
    stall (the plan-churn cost of the persistent-store runtime,
    ``repro_torch.runtime.cost.amortized_layer_stall_s``). Charged as overhead
    to every DUPLICATING strategy, so a strategy whose predicted balance
    gain is smaller than its weight movement loses to the baseline.

    ``migration_hidden_frac``: fraction of that stall the deployment's
    async prefetcher hides under forward compute (layer-staged overlapped
    fills, ``repro_torch.runtime.LayerStagedExecutor``) — only the EXPOSED
    remainder ``(1 - frac) * stall`` is charged, so the verdict reflects
    overlapped-transfer economics: duplication that was too churn-heavy
    for synchronous migration can win once the transfer rides for free.

    Combined strategy space (``report.combos``): every prediction mode is
    additionally costed per balancing *lever* in ``levers``. The lever
    changes which costs apply in the same roofline:

      duplicate    migration stall + ``dup_hbm_bytes`` replica-weight reads.
      reschedule   no migration (the plan stays put); instead the rescue
                   round ships ``resched_extra_frac`` more dispatch bytes
                   and FFN balance only reaches ``resched_residual``.
      both         pays both costs; FFN load is the finer of the two.

    ``resched_residual``: rank-imbalance the token scheduler could not
    remove (measured: ``RescheduleResult.imbalance_sched - 1``).
    ``resched_extra_frac``: rescue-round a2a bytes / primary dispatch
    bytes (measured from ``MoEStats.overflow``).
    ``dup_hbm_bytes``: per-device replica-slot weight bytes read per step
    (0 keeps the legacy duplicate costing; engines pass the real size).
    """
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE FFN: the paper's technique "
                         "is inapplicable")
    dist_eps = dist_eps or default_dist_eps
    curve = list(t2e_curve) if t2e_curve is not None else default_t2e_curve(skew)
    lat = lambda **kw: layer_latency(cfg, hw, batch=batch, seq=seq, skew=skew,
                                     scenario=scenario, comm_model=comm_model,
                                     **kw)

    exposed_stall_s = migration_stall_s * (
        1.0 - min(max(migration_hidden_frac, 0.0), 1.0))

    def charge_migration(r: StrategyResult) -> StrategyResult:
        if exposed_stall_s <= 0.0:
            return r
        lb = dataclasses.replace(
            r.latency, overhead=r.latency.overhead + exposed_stall_s)
        return dataclasses.replace(r, latency=lb)

    baseline = StrategyResult("none", 0.0, lat(strategy="none"))
    eps_d = dist_eps(skew)
    dist_only = charge_migration(
        StrategyResult("dist_only", 1.0 - eps_d,
                       lat(strategy="dist_only", eps=eps_d)))
    t2e_points = [
        charge_migration(StrategyResult(
            "token_to_expert", p.accuracy,
            lat(strategy="token_to_expert", eps=1.0 - p.accuracy,
                overhead_frac=p.overhead_frac),
            predictor=p.name))
        for p in curve
    ]

    combos: List[StrategyResult] = []
    for lever in levers:
        if lever not in LEVERS:
            raise ValueError(f"unknown lever {lever!r}; want one of {LEVERS}")
        duplicating = lever in ("duplicate", "both")
        lkw = dict(lever=lever,
                   resched_residual=resched_residual,
                   resched_extra_frac=resched_extra_frac,
                   dup_hbm_bytes=dup_hbm_bytes if duplicating else 0.0)
        price = charge_migration if duplicating else (lambda r: r)
        combos.append(price(StrategyResult(
            "dist_only", 1.0 - eps_d,
            lat(strategy="dist_only", eps=eps_d, **lkw), lever=lever)))
        for p in curve:
            combos.append(price(StrategyResult(
                "token_to_expert", p.accuracy,
                lat(strategy="token_to_expert", eps=1.0 - p.accuracy,
                    overhead_frac=p.overhead_frac, **lkw),
                predictor=p.name, lever=lever)))

    return GPSReport(model=cfg.name, hardware=hw.name, skew=skew,
                     baseline=baseline, dist_only=dist_only,
                     t2e_points=t2e_points, comm_model=comm_model,
                     combos=combos)


def sweep(
    cfg: ModelConfig,
    hardwares: Sequence[HardwareConfig],
    skews: Sequence[float],
    **kw,
) -> List[GPSReport]:
    """Fig 6/7 sweep: every (hardware, skew) point."""
    return [run_gps(cfg, hw, skew=s, **kw) for hw in hardwares for s in skews]


# ---------------------------------------------------------------------------
# online (serving-loop) entry point
# ---------------------------------------------------------------------------

def recommend_strategy(
    cfg: ModelConfig,
    hw: HardwareConfig,
    *,
    skew: float,
    batch: int = 8,
    seq: int = 256,
    allow_t2e: bool = True,
    min_saving: float = 0.02,
    levers: Sequence[str] = ("duplicate",),
    **kw,
) -> Tuple[StrategyVerdict, GPSReport]:
    """One-shot guideline for the ONLINE controller: given the skew the
    serving loop just *measured* (instead of an offline dataset estimate),
    return the (prediction, lever) verdict to run with next. The verdict
    compares as the prediction-mode string (``StrategyVerdict`` subclasses
    ``str``) and carries ``.lever``.

    ``allow_t2e`` — False when no Token-to-Expert predictor is loaded in
    the engine (the controller must not pick an unrunnable strategy).
    ``min_saving`` — below this predicted end-to-end saving, balancing
    is not worth its churn: run plain EP (verdict "none"/"none").
    ``levers`` — which balancing levers the engine can actually drive;
    the default keeps the pre-lever duplicate-only arbitration.
    ``migration_stall_s`` (kw) — measured replica-migration stall per
    layer-step; duplicating levers carry it, so heavy plan churn tips
    the verdict toward "reschedule" or "none" (see ``run_gps``).
    ``migration_hidden_frac`` (kw) — the fraction of that stall the
    engine's overlapped prefetcher measured as hidden under compute;
    only the exposed remainder is charged.
    ``resched_residual`` / ``resched_extra_frac`` / ``dup_hbm_bytes``
    (kw) — measured lever costs, see ``run_gps``.
    """
    report = run_gps(cfg, hw, batch=batch, seq=seq,
                     skew=max(float(skew), 1.0), levers=tuple(levers), **kw)
    pool = [r for r in report.combos
            if allow_t2e or r.strategy != "token_to_expert"]
    best = min(pool, key=lambda r: r.total)
    saving = report.saving_of(best)
    if saving < min_saving:
        return StrategyVerdict("none"), report
    return StrategyVerdict(best.strategy, best.lever), report
