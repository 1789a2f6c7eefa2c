"""Cross-model resource arbiter: moves quota toward SLO pressure (the
port's copy of the JAX package's ``fleet/arbiter.py``).

Each evaluation window the arbiter scores every resident model with a
scalar **pressure** built from the three signals the serving stack
already measures:

  * SLO attainment shortfall — worst-tenant attainment (from the model's
    ``ServeMetrics`` timings judged per tenant class) below the target;
  * queue depth — eligible-but-unadmitted requests
    (``ContinuousScheduler.queue_depth``), the backpressure a starved
    slot/KV share produces;
  * window skew — the last closed metrics window's expert skew, which is
    what makes extra ``dup_slots`` worth having at all.

It then proposes moving quota from the lowest-pressure model to the
highest-pressure one, with two brakes:

  **Hysteresis** — the same (hot, cold) pair must win ``patience``
  consecutive windows before anything moves, so one bursty window
  cannot thrash capacity (mirrors `serve.controller`'s vote gate).

  **Cost gate** — a dup-slot grant makes the hot model's next re-plan
  migrate weights in (one slot entry per layer); the modeled stall must
  pass `runtime.cost.should_migrate` against the pressure gap expressed
  as step-seconds at stake over the coming window. KV-quota moves are
  ledger-only (no bytes move; handback is deferred via the allocator),
  so they carry no gate.

Dup-slot SHRINK on the cold model is free: its next re-plan strands the
vacated slots with zero transfer (`runtime.diff.vacated_slots`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.simulator import A100_PCIE, HardwareConfig
from repro_torch.fleet.budget import FleetBudget
from repro_torch.runtime.cost import migration_stall_s, should_migrate


@dataclass
class ArbiterConfig:
    window_iters: int = 8          # fleet iterations per evaluation
    patience: int = 2              # consecutive windows before a move
    pressure_gap: float = 0.25     # min hot-cold gap to even vote
    attainment_target: float = 0.95
    queue_norm: float = 8.0        # queue depth saturating the queue term
    skew_weight: float = 0.25      # weight of the (capped) skew term
    dup_slots_per_move: int = 1
    kv_blocks_per_move: int = 4
    kv_floor_blocks: int = 4       # donor keeps at least this much KV
    max_moves: int = 0             # 0 = unlimited
    hardware: HardwareConfig = A100_PCIE


@dataclass
class ModelSignals:
    """One model's window inputs to the pressure score."""
    slo_attainment: float
    queue_depth: int
    window_skew: float
    step_s: float = 0.0            # recent per-step seconds (engine EMA)
    dup_entry_bytes: int = 0       # bytes one dup-slot grant migrates


@dataclass
class ArbiterMove:
    """One committed reallocation, with the inputs that justified it."""
    seq: int
    t: float
    src: str                       # cold model (quota shrinks)
    dst: str                       # hot model (quota grows)
    dup_slots: int
    kv_blocks: int
    pressure_src: float
    pressure_dst: float
    stall_s: float = 0.0           # modeled dup-grant migration stall
    gain_s: float = 0.0            # step-seconds at stake that paid it

    def explain(self) -> str:
        return (f"[{self.seq}] t={self.t:8.2f}s {self.src}->{self.dst} "
                f"dup+{self.dup_slots} kv+{self.kv_blocks} "
                f"pressure {self.pressure_src:.2f}->{self.pressure_dst:.2f} "
                f"stall={self.stall_s * 1e3:.2f}ms "
                f"gain={self.gain_s * 1e3:.2f}ms")


class FleetArbiter:
    """Windowed quota reallocation over a `FleetBudget`."""

    def __init__(self, cfg: Optional[ArbiterConfig], budget: FleetBudget):
        self.cfg = cfg if cfg is not None else ArbiterConfig()
        self.budget = budget
        self.moves: List[ArbiterMove] = []
        self.evaluations = 0
        self._pending: Optional[Tuple[str, str]] = None
        self._votes = 0
        self.last_pressure: Dict[str, float] = {}

    # -------------------------------------------------------------- pressure
    def pressure(self, s: ModelSignals) -> float:
        c = self.cfg
        slo_term = max(0.0, c.attainment_target - s.slo_attainment) \
            / max(c.attainment_target, 1e-9)
        queue_term = min(s.queue_depth / max(c.queue_norm, 1e-9), 1.0)
        # skew is max-share x E in [1, E]; cap the term at skew 2.0 so a
        # pathological histogram cannot drown the SLO/queue signals
        skew_term = min(max(s.window_skew - 1.0, 0.0), 1.0)
        return slo_term + queue_term + c.skew_weight * skew_term

    # --------------------------------------------------------------- observe
    def observe(self, t: float,
                signals: Dict[str, ModelSignals]) -> List[ArbiterMove]:
        """Score one closed window; returns the moves committed (possibly
        empty). The CALLER applies the returned moves to the engines
        (dup-slot quota + allocator quota) — the arbiter only mutates
        the ledger."""
        self.evaluations += 1
        c = self.cfg
        self.last_pressure = {n: self.pressure(s)
                              for n, s in signals.items()}
        if len(signals) < 2:
            return []
        hot = max(self.last_pressure, key=self.last_pressure.get)
        cold = min(self.last_pressure, key=self.last_pressure.get)
        gap = self.last_pressure[hot] - self.last_pressure[cold]
        if hot == cold or gap < c.pressure_gap:
            self._pending, self._votes = None, 0
            return []
        if self._pending != (hot, cold):
            self._pending, self._votes = (hot, cold), 1
        else:
            self._votes += 1
        if self._votes < c.patience:
            return []
        if c.max_moves and len(self.moves) >= c.max_moves:
            return []

        dup = 0
        stall_s = gain_s = 0.0
        want_dup = c.dup_slots_per_move
        if want_dup > 0 and self.budget.can_transfer(cold, hot,
                                                     dup_slots=want_dup):
            # the grant is worth taking iff the migration it triggers is
            # cheaper than the pressure gap expressed as hot-model step
            # time over the next window
            nbytes = signals[hot].dup_entry_bytes * want_dup
            stall_s = migration_stall_s(nbytes, c.hardware)
            gain_s = gap * signals[hot].step_s * c.window_iters
            if should_migrate(stall_s, gain_s):
                dup = want_dup
            else:
                stall_s = gain_s = 0.0
        kv = 0
        want_kv = c.kv_blocks_per_move
        cold_kv = self.budget.shares[cold].kv_block_quota
        if want_kv > 0 and cold_kv - want_kv >= c.kv_floor_blocks \
                and self.budget.can_transfer(cold, hot, kv_blocks=want_kv):
            kv = want_kv
        if dup == 0 and kv == 0:
            return []
        self.budget.transfer(cold, hot, dup_slots=dup, kv_blocks=kv)
        move = ArbiterMove(seq=len(self.moves), t=t, src=cold, dst=hot,
                           dup_slots=dup, kv_blocks=kv,
                           pressure_src=self.last_pressure[cold],
                           pressure_dst=self.last_pressure[hot],
                           stall_s=stall_s, gain_s=gain_s)
        self.moves.append(move)
        self._pending, self._votes = None, 0
        return [move]

    def explain(self) -> str:
        return "\n".join(m.explain() for m in self.moves)
