"""Persistent replica rows for the EP dispatch on one device.

The JAX package's store is a second copy of every rank's slot layout,
``(L, S, ...)`` with ``S = ep_ranks * n_slots``, filled functionally into a
whole back copy during a migration. At Mixtral's widths that is two more
copies of the experts than one 80 GB card holds. The port keeps the JAX
store's host state and semantics (``slot_experts``, per-layer ``version``,
``entry_bytes``, ``hbm_bytes_per_rank``) with another device layout:

* one tensor per MoE layer and weight name, of ``E + 2 * R * D`` rows.
  Rows ``[0, E)`` are the home experts: the model's own ``w_gate``,
  ``w_up`` and ``w_down`` become views of them (``from_model``), so no
  home expert is held twice;
* replica slot ``i`` of rank ``r`` (global slot ``r * n_slots + E_loc +
  i``) owns rows ``E + 2 * (r * D + i) + {0, 1}``: a *live* row, which the
  dispatch reads, and a *back* row, which a migration fills. A per-slot
  bit says which of the two is live; a commit flips the bit of every slot
  it filled.

What dispatch reads (``slot_rows``): a home slot its expert's home row, a
replica slot its live row. Every row index goes to ``moe_gemm`` as the
slot's weight index, so a replica slot reads its own copy, as each rank of
a multi-card deployment does. Unused replica rows (no live replica points
at them) are never read, as in JAX: building the store under the identity
plan copies nothing.

One EP rank a process (``comm``: the mesh's ``ProcessGroupRanks``): the
store is this rank's shard of the JAX store's ``P(None, "model", ...)``
layout, ``E_loc + 2 * D`` rows a layer: its home experts in ``[0,
E_loc)``, then replica slot ``i``'s live and back rows at ``E_loc + 2 * i
+ {0, 1}``. Every rank keeps the whole host state (slot map, live bits,
versions), so ``slot_rows`` gives every global slot its row in its own
rank's shard. A fill of a back row sends the expert's home row from its
home rank over the model group (``ProcessGroupRanks.transfer``): the same
rows the JAX package's masked psum gives, point to point.

Under a layout that splits the experts over "data" (``sharding``: "fsdp",
expert TP) each row takes its home experts' layout: the model's experts
are this rank's blocks, so every row holds the same block of its expert
and a process holds ``1 / data_shards`` of the store, as it holds that
share of its experts. A fill runs over the model group of this rank's
data coordinate, so each data rank moves its own block of the expert
from the rank of its data coordinate that holds it; the forward gathers
the rows over "data" at use (``models.transformer._moe_apply``). The cost
model's ``entry_bytes`` stays one whole expert's, as the JAX store's
global arrays give it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.placement import PlacementPlan, plan_dims
from repro_torch.runtime import cost as _cost
from repro_torch.runtime.diff import stacked_slot_experts
from repro_torch.sharding import data_shards

EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")


class ReplicaStore:
    """Per-layer replica row tensors + host bookkeeping (slot map, live
    bits, versions)."""

    def __init__(self, weights: Dict[str, Sequence[torch.Tensor]],
                 slot_experts: np.ndarray, *, num_experts: int,
                 ep_ranks: int, dup_slots: int, comm=None,
                 data_shards: int = 1):
        self.weights = weights                  # {name: [(E + 2RD, ...)] * L}
        self.data_shards = data_shards          # data ranks a row splits over
        self.slot_experts = np.asarray(slot_experts)     # (L, S) host view
        self.num_experts = num_experts
        self.ep_ranks = ep_ranks
        self.dup_slots = dup_slots
        self.comm = comm                        # one rank a process, or None
        self.e_loc, self.n_slots = plan_dims(num_experts, ep_ranks, dup_slots)
        L = self.slot_experts.shape[0]
        self.version = np.zeros((L,), np.int64)   # bumped per layer on commit
        # which of replica slot (r, i)'s two rows is live, (L, R * D)
        self.live_bit = np.zeros((L, ep_ranks * dup_slots), np.int64)

    # ------------------------------------------------------------------ init
    @classmethod
    def from_params(cls, experts, plan_stack: PlacementPlan, *,
                    num_experts: int, ep_ranks: int,
                    dup_slots: int, comm=None) -> "ReplicaStore":
        """Build the store for a stacked plan from the expert weights
        {name: (L, E, ...)} (a stacked tensor or a sequence of per-layer
        tensors; with ``comm`` this rank's (L, E_loc, ...)), which are
        copied into the home rows. Each live replica slot's live row gets
        a copy of its expert; the other replica rows are zeros."""
        store = cls._empty(tuple(experts), plan_stack,
                           num_experts=num_experts, ep_ranks=ep_ranks,
                           dup_slots=dup_slots, comm=comm)
        L = store.slot_experts.shape[0]
        for l in range(L):
            for k, w in experts.items():
                store.weights[k].append(store._layer_rows(w[l]))
            store._fill_live_replicas(l)
        return store

    @classmethod
    def from_model(cls, model, plan_stack: PlacementPlan, *,
                   num_experts: int, ep_ranks: int,
                   dup_slots: int, comm=None) -> "ReplicaStore":
        """Build the store from a ``Transformer``'s MoE layers (with
        ``comm``, a model holding this rank's home experts) and re-point
        each layer's ``w_gate`` / ``w_up`` / ``w_down`` to the store's home
        rows, one layer at a time, so the old tensors are freed as the
        store grows and no home expert is held twice."""
        store = cls._empty(EXPERT_WEIGHTS, plan_stack,
                           num_experts=num_experts, ep_ranks=ep_ranks,
                           dup_slots=dup_slots, comm=comm,
                           data_shards=data_shards(model.layers[0].w_up))
        for l, layer in enumerate(model.layers):
            for k in EXPERT_WEIGHTS:
                old = getattr(layer, k)
                rows = store._layer_rows(old.data)
                store.weights[k].append(rows)
                new = nn.Parameter(rows[:store.home_rows],
                                   requires_grad=False)
                if hasattr(old, "placement"):        # a layout's record
                    new.placement = old.placement
                setattr(layer, k, new)
            store._fill_live_replicas(l)
        return store

    @classmethod
    def _empty(cls, names, plan_stack, **dims) -> "ReplicaStore":
        se = stacked_slot_experts(plan_stack, dims["ep_ranks"],
                                  dims["dup_slots"])
        return cls({k: [] for k in names}, se, **dims)

    @property
    def home_rows(self) -> int:
        """Home expert rows at the head of each layer's tensor: E, or this
        rank's E_loc with one rank a process."""
        return self.num_experts if self.comm is None else self.e_loc

    def _layer_rows(self, home: torch.Tensor) -> torch.Tensor:
        """(E, ...) home experts (E_loc with ``comm``) -> a new row tensor
        of E + 2RD rows (E_loc + 2D) holding them at its head and zeros in
        the replica rows."""
        n = self.home_rows
        if home.shape[0] != n:
            raise ValueError(f"{home.shape[0]} home experts, the store's "
                             f"layout holds {n}")
        replicas = self.dup_slots * (1 if self.comm is not None
                                     else self.ep_ranks)
        rows = torch.empty((n + 2 * replicas,) + tuple(home.shape[1:]),
                           dtype=home.dtype, device=home.device)
        rows[:n].copy_(home)
        rows[n:].zero_()
        return rows

    def _fill_live_replicas(self, l: int) -> None:
        live = [s for s in self.replica_slots()
                if int(self.slot_experts[l, s]) >= 0]
        self.copy_experts([l] * len(live), live,
                          [int(self.slot_experts[l, s]) for s in live],
                          self.slot_rows()[l][live].tolist())

    def copy_experts(self, layer, dst_slot, src_expert, dst_row) -> None:
        """Copy each entry's expert (home row) into row ``dst_row`` of its
        slot's rank: in place on one device, or with ``comm`` from the
        expert's home rank to the slot's over the model group (every rank
        calls it with the same entries)."""
        if self.comm is None:
            for l, e, row in zip(layer, src_expert, dst_row):
                for w in self.weights.values():
                    w[l][row].copy_(w[l][e])
            return
        me = self.comm.rank
        moves = []
        for l, s, e, row in zip(layer, dst_slot, src_expert, dst_row):
            src, dst = e // self.e_loc, s // self.n_slots
            for w in self.weights.values():
                moves.append((src, w[l][e % self.e_loc] if src == me else None,
                              dst, w[l][row] if dst == me else None))
        self.comm.transfer(moves)

    # ------------------------------------------------------------- row maps
    def replica_slots(self) -> np.ndarray:
        """Global ids of the replica slots, in (rank, i) order."""
        r = np.arange(self.ep_ranks)[:, None]
        i = np.arange(self.dup_slots)[None, :]
        return (r * self.n_slots + self.e_loc + i).reshape(-1)

    def _replica_index(self, slot) -> np.ndarray:
        """Replica ``slot``'s (rank, i) index r * D + i (array or int)."""
        slot = np.asarray(slot)
        return (slot // self.n_slots) * self.dup_slots \
            + slot % self.n_slots - self.e_loc

    def _pair_base(self, slot) -> np.ndarray:
        """First of the two rows replica ``slot`` owns (array or int), in
        its rank's rows with ``comm``."""
        if self.comm is not None:
            return self.e_loc + 2 * (np.asarray(slot) % self.n_slots
                                     - self.e_loc)
        return self.num_experts + 2 * self._replica_index(slot)

    def slot_rows(self, live_bit=None) -> np.ndarray:
        """(L, S) int32 row each slot reads: home slots their expert's home
        row, replica slots their live row (under ``live_bit``, default the
        store's); with ``comm`` each in its own rank's rows."""
        bits = self.live_bit if live_bit is None else live_bit
        L, S = self.slot_experts.shape
        home = np.arange(S)
        rank, j = home // self.n_slots, home % self.n_slots
        first = 0 if self.comm is not None else rank * self.e_loc
        rows = np.broadcast_to(first + j, (L, S)).copy()
        rep = self.replica_slots()
        rows[:, rep] = self._pair_base(rep)[None, :] + bits
        return rows.astype(np.int32)

    def back_row(self, layer: int, slot: int) -> int:
        """The row a migration fills for replica ``slot`` of ``layer``."""
        i = int(self._replica_index(slot))
        return int(self._pair_base(slot)) + 1 - int(self.live_bit[layer, i])

    def _flipped(self, layer, dst_slot) -> np.ndarray:
        bits = self.live_bit.copy()
        i = self._replica_index(np.asarray(dst_slot, np.int64))
        bits[np.asarray(layer, np.int64), i] ^= 1
        return bits

    def target_rows(self, layer, dst_slot) -> np.ndarray:
        """(L, S) rows each slot reads once the given (layer, slot) entries
        are filled and committed: their back rows, every other slot's
        current row."""
        return self.slot_rows(self._flipped(layer, dst_slot))

    # ---------------------------------------------------------------- commit
    def adopt(self, slot_experts: np.ndarray, filled=None) -> None:
        """Commit a migration: the slots of ``filled`` ((layer, dst_slot)
        arrays) swap their live and back rows, and the slot map becomes
        ``slot_experts``; every layer whose map changed bumps its
        version."""
        changed = np.any(np.asarray(slot_experts) != self.slot_experts, axis=1)
        self.version += changed.astype(np.int64)
        if filled is not None and len(filled[0]):
            self.live_bit = self._flipped(*filled)
        self.slot_experts = np.asarray(slot_experts)

    # ------------------------------------------------------------------ info
    @property
    def entry_bytes(self) -> int:
        """One whole expert's bytes (a row's times ``data_shards``)."""
        return _cost.entry_bytes(self.weights) * self.data_shards

    @property
    def hbm_bytes_per_rank(self) -> int:
        """The JAX package's figure for one EP rank's store shard: L layers
        x n_slots local slot entries (home second copy + replica slots), the
        figure the ``store_hbm_budget_gb`` clamp accounts for."""
        L = int(self.slot_experts.shape[0])
        return L * self.n_slots * self.entry_bytes

    @property
    def device_bytes(self) -> int:
        """Bytes the row tensors hold on the device, the home rows (the
        model's own expert weights) included: this rank's blocks."""
        return sum(t.numel() * t.element_size()
                   for w in self.weights.values() for t in w)
