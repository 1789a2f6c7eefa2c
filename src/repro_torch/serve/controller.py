"""Online GPS controller: re-runs the paper's strategy selection on LIVE
traffic instead of fixing the strategy at engine construction.

The paper's core claim is that the best predictor depends on the
deployment point (model, hardware, skew) — and skew is a property of the
*traffic*, which drifts ("Prediction Is All MoE Needs" observes expert
distributions fluctuating early in a serving session and stabilising
later). So the controller:

  1. aggregates the engine's per-iteration expert histograms over a
     sliding window;
  2. measures the window's skewness and its volatility across windows;
  3. feeds the measured skew into ``repro_torch.core.gps.recommend_strategy``
     for the deployment's (model, hardware) point;
  4. switches the engine strategy (none / dist_only / token_to_expert)
     with hysteresis — a switch needs ``patience`` consecutive windows
     agreeing, so a single bursty window can't thrash the plan;
  5. adapts ``predict_interval``: volatile windows re-plan every batch,
     stable windows stretch the interval (stale plans are fine when the
     distribution stops moving).

The port's copy of the JAX package's ``serve/controller.py``: the same
fields, defaults (``hardware=A100_PCIE`` included) and arithmetic, numpy
only. The engine that drives it (``ContinuousEngine(controller=...)``)
runs the duplicate lever and Distribution-Only prediction; the controller
itself also arbitrates the other levers and Token-to-Expert when asked.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gps import GPSReport, recommend_strategy
from repro_torch.core.simulator import A100_PCIE, HardwareConfig, expert_bytes
from repro_torch.obs.audit import GPSAuditLog, GPSAuditRecord
from repro_torch.runtime.cost import amortized_layer_stall_s
from repro_torch.serve.metrics import window_skew


@dataclass
class ControllerConfig:
    hardware: HardwareConfig = A100_PCIE
    window_iters: int = 16          # iterations aggregated per decision
    patience: int = 2               # consecutive agreeing windows to switch
    min_saving: float = 0.02        # below this, run strategy "none"
    batch: int = 8                  # simulator operating point
    seq: int = 256
    # predict_interval ladder by skew volatility (std/mean across windows)
    volatile_interval: int = 1
    stable_interval: int = 8
    volatility_threshold: float = 0.05
    history_windows: int = 4        # windows used for the volatility estimate
    # Migration-aware hysteresis: charge duplicating strategies the stall
    # of the replica-weight traffic the engine MEASURED last window
    # (repro_torch.runtime), amortized per layer-step, so the guideline
    # rejects a strategy whose plan churn outweighs its balance gain. The scale
    # knob compensates when the engine serves a reduced smoke model while
    # the controller simulates the production point (cf. skew transfer).
    migration_aware: bool = True
    migration_bytes_scale: float = 1.0
    # Combined strategy space: which balancing levers the engine can drive.
    # The default keeps the pre-lever duplicate-only arbitration (and its
    # exact costing — replica HBM reads are only charged once a second
    # lever exists to arbitrate against). Add "reschedule"/"both" to let
    # the engine's token scheduler (repro_torch.schedule) be chosen.
    levers: tuple = ("duplicate",)
    # Scheduler residual imbalance assumed until the engine reports a
    # measured one via observe(resched_residual=...).
    resched_residual_default: float = 0.05
    # Skew transfer: when the engine measures skew on a REDUCED smoke model
    # while the controller simulates the production deployment point, the
    # achievable skew caps differ (max share is bounded by top_k/E, so
    # skew <= E/top_k). Mapping preserves relative concentration:
    #   c = (skew - 1) / (cap_obs - 1);  skew' = 1 + c * (cap_target - 1).
    # 0 disables the transfer (engine and controller share one model).
    skew_cap_observed: float = 0.0
    skew_cap_target: float = 0.0


@dataclass
class Decision:
    """One controller evaluation (ticked every ``window_iters``)."""
    t: float
    skew: float
    volatility: float
    recommended: str
    strategy: str                   # strategy actually in force after this tick
    predict_interval: int
    switched: bool
    migration_stall_s: float = 0.0  # per-layer-step stall charged this tick
    migration_hidden_frac: float = 0.0  # window fraction hidden by overlap
    lever: str = "duplicate"        # balancing lever in force after this tick
    lever_recommended: str = "duplicate"
    overflow_realized_frac: float = -1.0  # window's absorbed overflow share
    report: Optional[GPSReport] = field(default=None, repr=False)


class OnlineGPSController:
    """Feeds measured per-window skew back into the GPS guideline."""

    def __init__(self, model_cfg: ModelConfig, cfg: ControllerConfig = None,
                 *, predictor_available: bool = False,
                 initial_strategy: str = "dist_only",
                 initial_lever: str = "duplicate",
                 audit: Optional[GPSAuditLog] = None):
        if not model_cfg.is_moe:
            raise ValueError("the GPS controller needs a MoE model")
        self.model_cfg = model_cfg
        self.cfg = cfg or ControllerConfig()
        self.predictor_available = predictor_available
        self.strategy = initial_strategy
        self.lever = "none" if initial_strategy == "none" else initial_lever
        self.predict_interval = self.cfg.volatile_interval
        # every _evaluate appends its full recommend_strategy input vector
        # + outcome here (repro_torch.obs.audit), so verdicts are replayable
        self.audit = audit if audit is not None else GPSAuditLog()
        self.decisions: List[Decision] = []
        self._iters = 0
        self._counts: Optional[np.ndarray] = None
        self._skew_history: List[float] = []
        self._pending: Optional[str] = None
        self._pending_votes = 0
        self._migration_bytes = 0.0
        self._migration_hidden_bytes = 0.0
        # token-rescheduling lever measurements
        self._overflow_tokens = 0.0
        self._dropped_tokens = 0.0
        self._resched_residual: Optional[float] = None
        self._resched_absorbed_pred: Optional[float] = None

    # ------------------------------------------------------------- observe
    def observe(self, counts: Optional[np.ndarray], now: float,
                migration_bytes: float = 0.0,
                migration_hidden_bytes: float = 0.0,
                overflow_tokens: float = 0.0,
                dropped_tokens: float = 0.0,
                resched_residual: Optional[float] = None,
                resched_absorbed_pred: Optional[float] = None,
                ) -> Optional[Decision]:
        """Feed one iteration's (L, E) expert histogram (None for MoE-less
        iterations) plus the replica-weight bytes the engine's migration
        executor moved this iteration. ``migration_hidden_bytes`` is the
        share of those bytes whose transfer the overlapped prefetcher hid
        under forward compute — only the exposed remainder is charged to
        duplicating strategies.

        Token-rescheduling measurements (all optional):
        ``overflow_tokens`` / ``dropped_tokens`` — capacity-overflow tokens
        this iteration and how many the rescue round still dropped; their
        window ratio is the REALIZED absorbed fraction, and overflow over
        routed tokens prices the rescue round's extra a2a bytes.
        ``resched_residual`` — the scheduler's leftover rank imbalance for
        the current quota plan (``RescheduleResult.imbalance_sched - 1``).
        ``resched_absorbed_pred`` — the scheduler's predicted absorbed
        overflow fraction, audited against the realized one.

        Returns a Decision when a window closes, else None."""
        self._iters += 1
        self._migration_bytes += float(migration_bytes)
        self._migration_hidden_bytes += min(float(migration_hidden_bytes),
                                            float(migration_bytes))
        self._overflow_tokens += float(overflow_tokens)
        self._dropped_tokens += float(dropped_tokens)
        if resched_residual is not None:
            self._resched_residual = float(resched_residual)
        if resched_absorbed_pred is not None:
            self._resched_absorbed_pred = float(resched_absorbed_pred)
        if counts is not None:
            c = np.asarray(counts, np.float64)
            self._counts = c if self._counts is None else self._counts + c
        if self._iters < self.cfg.window_iters:
            return None
        decision = self._evaluate(now)
        self._iters = 0
        self._counts = None
        self._migration_bytes = 0.0
        self._migration_hidden_bytes = 0.0
        self._overflow_tokens = 0.0
        self._dropped_tokens = 0.0
        return decision

    # ------------------------------------------------------------ evaluate
    def _measured_skew(self) -> Optional[float]:
        if self._counts is None:
            return None
        return window_skew(self._counts)

    def _volatility(self) -> float:
        h = self._skew_history[-self.cfg.history_windows:]
        if len(h) < 2:
            return 0.0
        return float(np.std(h) / max(np.mean(h), 1e-9))

    def _transfer_skew(self, skew: float) -> float:
        c = self.cfg
        if not (c.skew_cap_observed > 1.0 and c.skew_cap_target > 1.0):
            return skew
        conc = (skew - 1.0) / (c.skew_cap_observed - 1.0)
        return 1.0 + float(np.clip(conc, 0.0, 1.0)) * (c.skew_cap_target - 1.0)

    def _evaluate(self, now: float) -> Optional[Decision]:
        skew = self._measured_skew()
        if skew is None:
            return None
        self._skew_history.append(skew)
        vol = self._volatility()
        strategy_before = self.strategy

        mig_stall = 0.0
        hidden_frac = 0.0
        if self.cfg.migration_aware and self._migration_bytes > 0:
            hidden_frac = min(
                self._migration_hidden_bytes / self._migration_bytes, 1.0)
            # charge only the EXPOSED traffic (overlapped fills ride under
            # forward compute and cost the serving path nothing)
            mig_stall = amortized_layer_stall_s(
                (self._migration_bytes - self._migration_hidden_bytes)
                * self.cfg.migration_bytes_scale,
                self.cfg.hardware, num_layers=self.model_cfg.num_layers,
                window_steps=self.cfg.window_iters)

        # lever costs measured this window (see observe docstring)
        routed = float(self._counts.sum()) if self._counts is not None else 0.0
        resched_extra_frac = (self._overflow_tokens / routed
                              if routed > 0 else 0.0)
        resched_residual = (self._resched_residual
                            if self._resched_residual is not None
                            else self.cfg.resched_residual_default)
        overflow_realized = (1.0 - self._dropped_tokens / self._overflow_tokens
                             if self._overflow_tokens > 0 else -1.0)
        # replica-slot weight reads; charged only once a second lever exists
        # to arbitrate against, so duplicate-only costing stays pre-lever.
        dup_hbm = 0.0
        if len(self.cfg.levers) > 1 and self.model_cfg.moe is not None:
            dup_hbm = (expert_bytes(self.model_cfg)
                       * max(self.model_cfg.moe.duplication_slots, 0))

        skew_input = self._transfer_skew(skew)
        recommended, report = recommend_strategy(
            self.model_cfg, self.cfg.hardware, skew=skew_input,
            batch=self.cfg.batch, seq=self.cfg.seq,
            allow_t2e=self.predictor_available,
            min_saving=self.cfg.min_saving,
            migration_stall_s=mig_stall,
            levers=tuple(self.cfg.levers),
            resched_residual=resched_residual,
            resched_extra_frac=resched_extra_frac,
            dup_hbm_bytes=dup_hbm)

        # hysteresis over the COMBINED (prediction, lever) verdict: require
        # `patience` consecutive windows agreeing on the same pair — a lever
        # flip alone (same prediction mode) still re-wires the engine, so it
        # gates exactly like a prediction switch.
        rec_lever = getattr(recommended, "lever", "duplicate")
        rec_key = (recommended if recommended == "none"
                   else f"{recommended}+{rec_lever}")
        cur_key = (self.strategy if self.strategy == "none"
                   else f"{self.strategy}+{self.lever}")
        switched = False
        if rec_key != cur_key:
            if rec_key == self._pending:
                self._pending_votes += 1
            else:
                self._pending, self._pending_votes = rec_key, 1
            if self._pending_votes >= self.cfg.patience:
                self.strategy = str(recommended)
                self.lever = rec_lever if recommended != "none" else "none"
                self._pending, self._pending_votes = None, 0
                switched = True
        else:
            self._pending, self._pending_votes = None, 0

        self.predict_interval = (
            self.cfg.volatile_interval
            if vol >= self.cfg.volatility_threshold
            else self.cfg.stable_interval)

        d = Decision(t=now, skew=skew, volatility=vol,
                     recommended=recommended, strategy=self.strategy,
                     predict_interval=self.predict_interval,
                     switched=switched, migration_stall_s=mig_stall,
                     migration_hidden_frac=hidden_frac,
                     lever=self.lever, lever_recommended=rec_lever,
                     overflow_realized_frac=overflow_realized, report=report)
        self.decisions.append(d)

        gate = ("switched" if switched
                else "pending" if self._pending is not None else "unchanged")
        self.audit.append(GPSAuditRecord(
            seq=len(self.audit.records) + self.audit.dropped,
            t=float(now),
            window_iters=self.cfg.window_iters,
            skew_measured=float(skew),
            skew_input=float(skew_input),
            volatility=float(vol),
            migration_bytes=float(self._migration_bytes),
            migration_hidden_bytes=float(self._migration_hidden_bytes),
            migration_hidden_frac=float(hidden_frac),
            migration_stall_s=float(mig_stall),
            batch=self.cfg.batch,
            seq_len=self.cfg.seq,
            allow_t2e=self.predictor_available,
            min_saving=self.cfg.min_saving,
            recommended=recommended,
            strategy_before=strategy_before,
            strategy_after=self.strategy,
            gate=gate,
            pending_votes=self._pending_votes,
            predict_interval=self.predict_interval,
            dist_only_saving=float(report.dist_only_saving),
            t2e_saving=float(report.t2e_saving),
            baseline_total_s=float(report.baseline.total),
            best_total_s=float(report.best.total),
            lever_recommended=rec_lever,
            lever_after=self.lever,
            resched_saving=float(report.reschedule_saving),
            resched_residual=float(resched_residual),
            resched_extra_frac=float(resched_extra_frac),
            overflow_pred_frac=float(self._resched_absorbed_pred or 0.0),
            overflow_realized_frac=float(overflow_realized)))
        return d

    # ------------------------------------------------------------ reporting
    @property
    def num_switches(self) -> int:
        return sum(d.switched for d in self.decisions)

    def switch_log(self) -> List[str]:
        return [f"t={d.t:8.2f}s skew={d.skew:.2f} vol={d.volatility:.3f} "
                f"-> {d.strategy if d.strategy == 'none' else d.strategy + '+' + d.lever} "
                f"(interval={d.predict_interval})"
                for d in self.decisions if d.switched]
