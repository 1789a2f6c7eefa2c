"""Migration cost model: bytes moved per plan switch and the stall they
cost on the deployment's interconnect (the roofline's collective term).

The port's copy of the JAX package's ``runtime/cost.py``: numpy only, the
same arithmetic. ``entry_bytes`` also takes the replica store's per-layer
row tensors (``runtime.store``).

Three consumers:

* ``core.gps.run_gps``, through the online controller
  (``serve.controller``) — an amortized per-layer-per-step migration stall
  is added to the *duplicating* strategies' overhead, so the guideline
  rejects a strategy whose plan churn costs more than its balance gain.
  With overlapped (async-prefetch) migration only the EXPOSED fraction of
  the stall is charged (``migration_hidden_frac``).
* the serving engines — ``should_migrate`` gates an individual re-plan:
  serving stays on the old plan when the predicted *exposed* stall exceeds
  the predicted imbalance gain until the next re-plan. The hidden portion
  (transfer time overlapped with forward compute) is free by construction.
* the overlap scheduler — ``overlap_chunk_budget`` converts the measured
  non-migration step time (the overlap window) into a per-step chunk
  budget, replacing the fixed ``migrate_chunks_per_step`` knob.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def entry_bytes(weights: dict) -> int:
    """Bytes one slot entry (one expert's weights) occupies, from the
    actual stacked weights {name: (L, E_or_S, ...)} (arrays or tensors) or
    per-layer sequences {name: [(E_or_S, ...)] * L}."""
    total = 0
    for w in weights.values():
        shape = w[0].shape[1:] if isinstance(w, (list, tuple)) else w.shape[2:]
        item = (w[0] if isinstance(w, (list, tuple)) else w).itemsize
        per = 1
        for d in shape:
            per *= int(d)
        total += per * int(item)
    return total


def plan_migration_bytes(diff, weights: dict) -> int:
    """Logical bytes a diff moves: one send + receive per changed entry
    (the paper's Sec 5 transfer accounting, per entry instead of per
    rank)."""
    return diff.bytes_moved(entry_bytes(weights))


def migration_stall_s(nbytes: float, hw) -> float:
    """Serialized wire time of a migration on ``hw``
    (`repro_torch.core.simulator.HardwareConfig`). With synchronous adoption the
    whole figure lands between engine steps; with the overlapped executor
    it is an upper bound split by ``split_hidden_exposed``."""
    return float(nbytes) / max(float(hw.link_bw), 1.0)


def amortized_layer_stall_s(window_bytes: float, hw, *, num_layers: int,
                            window_steps: int) -> float:
    """Measured migration traffic of a serving window -> the per-layer
    per-step stall `run_gps` should charge duplicating strategies.

    ``window_bytes`` spans all layers and all steps of the window, while
    ``layer_latency`` models one layer of one step — divide accordingly.
    """
    steps = max(int(window_steps), 1) * max(int(num_layers), 1)
    return migration_stall_s(window_bytes, hw) / steps


# ---------------------------------------------------------------------------
# overlap scheduling (async predicted-hot prefetch)
# ---------------------------------------------------------------------------

class KindWindowEMA:
    """Per-iteration-kind EMA of the migration-free step wall time.

    The overlap chunk budget is sized against the compute window of the
    step the fills ride under — but prefill-bearing iterations run orders
    of magnitude longer than decode-only ones, so one mixed EMA
    overestimates the window during decode phases (overdriving the chunk
    budget onto the serving path) and underestimates it during prefill
    bursts (starving the drain). One EMA per kind ("prefill" / "decode")
    sizes the budget to the step actually being shadowed; an unseeded
    kind falls back to whatever kind has been measured (the only estimate
    available until the first step of its own kind lands)."""

    def __init__(self, beta: float = 0.9):
        self.beta = float(beta)
        self._v: dict = {}

    def update(self, kind: str, dt: float) -> float:
        prev = self._v.get(kind, 0.0)
        self._v[kind] = (float(dt) if prev <= 0
                         else self.beta * prev + (1 - self.beta) * float(dt))
        return self._v[kind]

    def window(self, kind: str) -> float:
        w = self._v.get(kind, 0.0)
        if w > 0:
            return w
        return max(self._v.values(), default=0.0)

    def kinds(self) -> dict:
        return dict(self._v)


def overlap_chunk_budget(window_s: float, *, chunk_entries: int,
                         entry_bytes: int, hw, min_chunks: int = 1,
                         max_chunks: int = 1024) -> int:
    """Chunk-steps per engine iteration that fit inside one step's compute
    window (the measured non-migration step time). The wire time of one
    fixed-shape chunk is ``chunk_entries * entry_bytes / link_bw``; issuing
    at most ``window / chunk_wire`` chunks per step keeps the transfer
    inside the forward's shadow. At least ``min_chunks`` per step so a
    migration always drains even when the window estimate collapses."""
    wire = migration_stall_s(max(int(chunk_entries), 1)
                             * max(int(entry_bytes), 1), hw)
    if wire <= 0.0:
        return int(max_chunks)
    budget = int(max(float(window_s), 0.0) / wire)
    return int(np.clip(budget, min_chunks, max_chunks))


def split_hidden_exposed(stall_s: float, window_s: float
                         ) -> Tuple[float, float]:
    """Split a migration stall into the portion HIDDEN under an overlap
    window (transfer concurrent with forward compute) and the EXPOSED
    remainder that still lands on the serving critical path. Returns
    ``(hidden_s, exposed_s)`` with ``hidden + exposed == stall``."""
    stall = max(float(stall_s), 0.0)
    hidden = min(stall, max(float(window_s), 0.0))
    return hidden, stall - hidden


def should_migrate(stall_s: float, gain_s: float,
                   hidden_s: float = 0.0) -> bool:
    """Accept a re-plan iff the EXPOSED migration stall (total minus the
    portion hidden under forward compute) is repaid by the predicted
    imbalance gain accrued before the next re-plan."""
    exposed = max(float(stall_s) - max(float(hidden_s), 0.0), 0.0)
    return exposed <= float(gain_s)
