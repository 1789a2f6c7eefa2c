"""Fleet HBM budget ledger: one device-memory budget, N resident models
(the port's copy of the JAX package's ``fleet/budget.py``; numpy-only
arithmetic, so one fleet gives the same ledger in both packages).

Every co-resident model instance costs three kinds of bytes per EP rank:

  weights   — its sharded parameters (fixed while the model is resident);
  store     — the persistent replica store, ``L x (E_loc + dup_slots)``
              slot entries in the JAX package's accounting
              (``core.placement.store_bytes_per_rank``; the port's store
              keeps its home rows in the model's weights, see
              ``runtime.store``);
  KV        — its paged KV block pool, ``kv_blocks x kv_block_bytes``.

The ledger distinguishes **provisioned** bytes (what the engines
allocate: full ``dup_slots`` store + full physical pool) from **active**
bytes (what the current *quotas* let the model actually use). Allocations
never change at runtime, so the fleet arbiter moves capacity between
models purely as quota: a model's ``dup_slot_quota`` caps how many
replica slots its planner fills, its ``kv_block_quota`` caps how many
pool blocks its allocator hands out. ``clamp()`` is the fleet
generalization of ``core.placement.clamp_dup_slots``: instead of each
model clamping against a private budget in isolation, the JOINT
provisioned footprint is shrunk (largest store first, then KV quotas)
until the fleet fits.

A quota transfer is instantaneous in the ledger; the physical handback
is deferred (a shrunk KV quota refuses growth until blocks drain back,
a shrunk dup-slot quota strands replica slots at the next re-plan with
zero transfer — see ``runtime.diff.vacated_slots``). The transient where
the shrinking model still occupies bytes the growing model was just
granted is bounded by the shrinking model's drain rate, exactly like
memory ballooning between co-resident VMs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from repro_torch.core.placement import store_bytes_per_rank


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def params_bytes(params) -> int:
    """Total bytes of a ``Transformer``'s parameters (an ``nn.Module``), or
    of a tree (dicts, lists, tuples) of tensors or arrays."""
    leaves = (params.parameters() if isinstance(params, torch.nn.Module)
              else _leaves(params))
    total = 0
    for a in leaves:
        if isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
        else:
            a = np.asarray(a)
            total += a.size * a.dtype.itemsize
    return int(total)


def kv_block_bytes(num_layers: int, block_size: int, num_kv_heads: int,
                   head_dim: int, dtype_bytes: int = 2) -> int:
    """Bytes one pool block pins across the layer stack (K and V)."""
    return int(num_layers) * int(block_size) * int(num_kv_heads) \
        * int(head_dim) * int(dtype_bytes) * 2


@dataclass
class ModelShare:
    """One resident model's row in the ledger (per EP rank)."""
    name: str
    weights_bytes: int
    entry_bytes: int            # one expert slot entry, per layer
    num_layers: int
    num_experts: int
    ep_ranks: int
    dup_slots: int              # compiled replica slots (physical ceiling)
    kv_blocks: int              # physical pool blocks (excl. null block)
    kv_block_bytes: int
    dup_slot_quota: int = -1    # -1 -> full dup_slots
    kv_block_quota: int = -1    # -1 -> full kv_blocks

    def __post_init__(self):
        if self.dup_slot_quota < 0:
            self.dup_slot_quota = self.dup_slots
        if self.kv_block_quota < 0:
            self.kv_block_quota = self.kv_blocks
        self.dup_slot_quota = min(self.dup_slot_quota, self.dup_slots)
        self.kv_block_quota = min(self.kv_block_quota, self.kv_blocks)

    def store_bytes(self, dup: int) -> int:
        if self.entry_bytes <= 0 or self.num_experts <= 0:
            return 0
        return store_bytes_per_rank(
            self.num_experts, self.ep_ranks, dup,
            entry_bytes=self.entry_bytes, num_layers=self.num_layers)

    @property
    def provisioned_bytes(self) -> int:
        return (self.weights_bytes + self.store_bytes(self.dup_slots)
                + self.kv_blocks * self.kv_block_bytes)

    @property
    def active_bytes(self) -> int:
        return (self.weights_bytes + self.store_bytes(self.dup_slot_quota)
                + self.kv_block_quota * self.kv_block_bytes)

    @property
    def dup_slot_entry_bytes(self) -> int:
        """Bytes one replica-slot quota unit moves: a slot per layer."""
        return self.num_layers * self.entry_bytes


class FleetBudget:
    """Per-rank HBM ledger over every registered model share."""

    def __init__(self, total_bytes: float = 0.0):
        self.total_bytes = float(total_bytes)   # 0 = unlimited
        self.shares: Dict[str, ModelShare] = {}

    def register(self, share: ModelShare) -> ModelShare:
        if share.name in self.shares:
            raise ValueError(f"model {share.name!r} already registered")
        self.shares[share.name] = share
        return share

    def provisioned_bytes(self) -> int:
        return sum(s.provisioned_bytes for s in self.shares.values())

    def active_bytes(self) -> int:
        return sum(s.active_bytes for s in self.shares.values())

    # ------------------------------------------------------------- build time
    def clamp(self) -> Dict[str, int]:
        """Shrink the fleet until its PROVISIONED footprint fits the
        budget: first replica slots (largest store loses a slot per
        round — the fleet form of ``clamp_dup_slots``), then KV quotas
        (proportionally, leaving the physical pools compiled as-is but
        capping what each model may use). Returns the final dup_slots
        per model. Raises if weights + homes + one-block pools alone
        exceed the budget — no quota can fix over-subscribed residency.
        """
        if self.total_bytes <= 0:
            return {n: s.dup_slots for n, s in self.shares.items()}
        while self.provisioned_bytes() > self.total_bytes:
            candidates = [s for s in self.shares.values() if s.dup_slots > 0]
            if not candidates:
                break
            victim = max(candidates, key=lambda s: s.store_bytes(s.dup_slots))
            victim.dup_slots -= 1
            victim.dup_slot_quota = min(victim.dup_slot_quota,
                                        victim.dup_slots)
        over = self.provisioned_bytes() - self.total_bytes
        if over > 0:
            kv_total = sum(s.kv_blocks * s.kv_block_bytes
                           for s in self.shares.values())
            if kv_total <= 0 or over >= kv_total:
                raise ValueError(
                    f"fleet cannot fit: {self.provisioned_bytes() / 1e9:.2f} "
                    f"GB provisioned vs {self.total_bytes / 1e9:.2f} GB "
                    "budget even with zero replica slots")
            keep = 1.0 - over / kv_total
            for s in self.shares.values():
                s.kv_block_quota = max(1, int(s.kv_blocks * keep))
        return {n: s.dup_slots for n, s in self.shares.items()}

    # --------------------------------------------------------------- runtime
    def can_transfer(self, src: str, dst: str, *, dup_slots: int = 0,
                     kv_blocks: int = 0) -> bool:
        s, d = self.shares[src], self.shares[dst]
        if dup_slots > 0 and (s.dup_slot_quota < dup_slots
                              or d.dup_slot_quota + dup_slots > d.dup_slots):
            return False
        if kv_blocks > 0 and (s.kv_block_quota < kv_blocks
                              or d.kv_block_quota + kv_blocks > d.kv_blocks):
            return False
        if self.total_bytes > 0:
            delta = 0
            if dup_slots:
                delta += (d.store_bytes(d.dup_slot_quota + dup_slots)
                          - d.store_bytes(d.dup_slot_quota))
                delta -= (s.store_bytes(s.dup_slot_quota)
                          - s.store_bytes(s.dup_slot_quota - dup_slots))
            if kv_blocks:
                delta += kv_blocks * (d.kv_block_bytes - s.kv_block_bytes)
            if self.active_bytes() + delta > self.total_bytes:
                return False
        return True

    def transfer(self, src: str, dst: str, *, dup_slots: int = 0,
                 kv_blocks: int = 0) -> None:
        if not self.can_transfer(src, dst, dup_slots=dup_slots,
                                 kv_blocks=kv_blocks):
            raise ValueError(
                f"transfer {src}->{dst} (dup={dup_slots}, kv={kv_blocks}) "
                "violates quota bounds or the fleet budget")
        s, d = self.shares[src], self.shares[dst]
        s.dup_slot_quota -= dup_slots
        d.dup_slot_quota += dup_slots
        s.kv_block_quota -= kv_blocks
        d.kv_block_quota += kv_blocks

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "budget_total_bytes": self.total_bytes,
            "budget_provisioned_bytes": float(self.provisioned_bytes()),
            "budget_active_bytes": float(self.active_bytes()),
        }
        for name, s in self.shares.items():
            out[f"{name}_weights_bytes"] = float(s.weights_bytes)
            out[f"{name}_store_bytes"] = float(s.store_bytes(s.dup_slot_quota))
            out[f"{name}_kv_bytes"] = float(s.kv_block_quota
                                            * s.kv_block_bytes)
            out[f"{name}_dup_slot_quota"] = float(s.dup_slot_quota)
            out[f"{name}_kv_block_quota"] = float(s.kv_block_quota)
        return out
