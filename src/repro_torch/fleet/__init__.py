"""Multi-tenant fleet serving: N models, one HBM budget, one arbiter (the
port of the JAX package's ``fleet``).

  ``FleetBudget``    — per-rank byte ledger over (weights + replica-store
                       dup slots + paged KV blocks), with the global clamp
                       ``core.placement.clamp_dup_slots`` applied to the
                       fleet's joint footprint.
  ``FleetAdmission`` — tenant -> model routing + per-tenant SLO classes.
  ``FleetArbiter``   — windowed quota reallocation (hysteresis + the
                       ``runtime.cost.should_migrate`` cost gate).
  ``FleetEngine``    — N ``ContinuousEngine`` instances time-sharing one
                       card, each with its own online GPS loop; every
                       arbiter move is a quota inside what the engines
                       allocated at build time.
"""

from repro_torch.fleet.admission import (BATCH, INTERACTIVE, FleetAdmission,
                                         SLOClass)
from repro_torch.fleet.arbiter import (ArbiterConfig, ArbiterMove,
                                       FleetArbiter, ModelSignals)
from repro_torch.fleet.budget import (FleetBudget, ModelShare, kv_block_bytes,
                                      params_bytes)
from repro_torch.fleet.engine import FleetEngine, FleetModelSpec

__all__ = [
    "ArbiterConfig", "ArbiterMove", "BATCH", "FleetAdmission", "FleetArbiter",
    "FleetBudget", "FleetEngine", "FleetModelSpec", "INTERACTIVE",
    "ModelShare", "ModelSignals", "SLOClass", "kv_block_bytes",
    "params_bytes",
]
