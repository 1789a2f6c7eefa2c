"""GPS decision audit log: every controller verdict with its full inputs.

The paper's thesis is that the right prediction strategy is a function of
measured system state — so every ``OnlineGPSController`` verdict must be
explainable post-hoc from the exact numbers it saw. Each evaluation
appends one ``GPSAuditRecord`` carrying the complete input vector fed to
``repro_torch.core.gps.recommend_strategy`` (measured + transferred skew,
volatility, migration bytes/hidden fraction/amortized stall, simulator
operating point) plus the outcome (recommendation, hysteresis state, the
strategy actually in force, predicted savings per strategy), so a run can
be replayed and every switch — or refusal to switch — justified.

The port's copy of the JAX package's ``obs/audit.py``: the same fields,
defaults and ``explain()`` text, so a log reads the same from either.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional


@dataclass
class GPSAuditRecord:
    """One controller evaluation, inputs and outcome."""
    seq: int                         # evaluation index within the run
    t: float                         # engine clock at the verdict
    # ----------------------------------------------------- measured inputs
    window_iters: int                # iterations aggregated into the window
    skew_measured: float             # window_skew of the aggregated counts
    skew_input: float                # post skew-transfer, what run_gps saw
    volatility: float                # skew std/mean over recent windows
    migration_bytes: float           # replica bytes the window moved
    migration_hidden_bytes: float    # share hidden under forward compute
    migration_hidden_frac: float
    migration_stall_s: float         # amortized exposed stall charged
    # ------------------------------------------------- simulator operating
    batch: int
    seq_len: int
    allow_t2e: bool
    min_saving: float
    # ---------------------------------------------------------- the verdict
    recommended: str                 # what recommend_strategy returned
    strategy_before: str
    strategy_after: str              # in force after hysteresis
    gate: str                        # switched | pending | unchanged
    pending_votes: int
    predict_interval: int
    # ------------------------------------------- predicted economics (why)
    dist_only_saving: float = 0.0
    t2e_saving: float = 0.0
    baseline_total_s: float = 0.0
    best_total_s: float = 0.0
    # ------------------------------ combined strategy space (lever choice)
    # Fields below default so pre-lever JSONL rows stay schema-compatible.
    lever_recommended: str = "duplicate"
    lever_after: str = "duplicate"
    resched_saving: float = 0.0      # best reschedule-lever predicted saving
    resched_residual: float = 0.0    # scheduler residual imbalance fed in
    resched_extra_frac: float = 0.0  # rescue-round a2a surcharge fed in
    overflow_pred_frac: float = 0.0  # scheduler-predicted overflow absorbed
    overflow_realized_frac: float = -1.0  # engine-realized (-1 = no overflow)
    # Model instance this verdict belongs to (fleet serving: one audit log
    # per resident model). Defaults empty so pre-fleet JSONL rows load.
    model: str = ""

    def explain(self) -> str:
        verdict = (self.recommended if self.recommended == "none"
                   else f"{self.recommended}+{self.lever_recommended}")
        running = (self.strategy_after if self.strategy_after == "none"
                   else f"{self.strategy_after}+{self.lever_after}")
        resched = ""
        if self.lever_recommended in ("reschedule", "both") \
                or self.overflow_realized_frac >= 0.0:
            realized = ("?" if self.overflow_realized_frac < 0.0
                        else f"{self.overflow_realized_frac:.0%}")
            resched = (f"resched(save={self.resched_saving:.1%}, "
                       f"absorbed pred={self.overflow_pred_frac:.0%}/"
                       f"real={realized}) ")
        tag = f"{self.model} " if self.model else ""
        return (f"[{tag}{self.seq}] t={self.t:8.2f}s "
                f"skew={self.skew_measured:.2f}"
                f"->{self.skew_input:.2f} vol={self.volatility:.3f} "
                f"mig={self.migration_bytes / 1e6:.2f}MB "
                f"(hidden {self.migration_hidden_frac:.0%}, "
                f"stall {self.migration_stall_s * 1e6:.0f}us) "
                f"savings(dist={self.dist_only_saving:.1%}, "
                f"t2e={self.t2e_saving:.1%}) {resched}=> {verdict} "
                f"[{self.gate}] running={running} "
                f"interval={self.predict_interval}")


class GPSAuditLog:
    """Bounded append-only record of controller evaluations."""

    def __init__(self, maxlen: int = 4096, model: str = ""):
        self.maxlen = int(maxlen)
        self.model = model
        self.records: List[GPSAuditRecord] = []
        self.dropped = 0

    def append(self, rec: GPSAuditRecord) -> None:
        if self.model and not rec.model:
            rec.model = self.model
        if len(self.records) >= self.maxlen:
            self.records.pop(0)
            self.dropped += 1
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    @property
    def switches(self) -> List[GPSAuditRecord]:
        return [r for r in self.records if r.gate == "switched"]

    def to_obj(self) -> List[Dict[str, Any]]:
        return [asdict(r) for r in self.records]

    def to_jsonl(self, path: str, mode: str = "w") -> None:
        with open(path, mode) as f:
            for r in self.records:
                f.write(json.dumps(asdict(r)) + "\n")

    def explain(self, last: Optional[int] = None) -> str:
        recs = self.records if last is None else self.records[-last:]
        return "\n".join(r.explain() for r in recs)

    def summary(self) -> Dict[str, float]:
        n = len(self.records)
        return {
            "gps_verdicts": float(n),
            "gps_switches": float(len(self.switches)),
            "gps_t2e_verdicts": float(sum(
                r.recommended == "token_to_expert" for r in self.records)),
            "gps_none_verdicts": float(sum(
                r.recommended == "none" for r in self.records)),
            "gps_resched_verdicts": float(sum(
                r.recommended != "none"
                and r.lever_recommended in ("reschedule", "both")
                for r in self.records)),
        }
