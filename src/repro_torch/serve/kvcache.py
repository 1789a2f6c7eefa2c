"""Paged (block-pool) KV cache for continuous batching.

The device side is ONE fixed-shape pool per layer stack —
``{"k","v"}: (L, num_blocks, block_size, K, hd)`` bf16 — so requests join,
leave, grow and get preempted without any tensor changing shape. The host
side is a free-list allocator plus per-slot block tables
(``(max_slots, max_blocks_per_slot)`` int32) that map each slot's logical
positions onto physical blocks.

Block 0 is reserved as the **null block**: table entries past a slot's
allocation point at it and reads from it are always masked by the
per-slot length. The port never writes into it (prefill skips its table
entries, decode suppresses idle slots' writes), so it stays zero.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device

NULL_BLOCK = 0


def init_block_pool(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype=torch.bfloat16, device="cuda") -> Dict[str, torch.Tensor]:
    """Device-side pool for a uniform-stack GQA architecture."""
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    shape = (L, num_blocks, block_size, K, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def write_prefill_blocks(pool: Dict[str, torch.Tensor],
                         temp: Dict[str, torch.Tensor],
                         table: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Scatter a prefilled (L, 1, S_pad, K, hd) linear cache into the pool,
    in place. ``table``: host array of (S_pad // block_size,) physical-block
    ids; entries that are NULL_BLOCK (past the request's allocation) are
    skipped."""
    tbl = np.asarray(table, np.int64)
    keep = np.flatnonzero(tbl != NULL_BLOCK)
    for name in ("k", "v"):
        p, t = pool[name], temp[name]
        L, _, S, K, hd = t.shape
        bs = p.shape[2]
        src = torch.from_numpy(keep).to(p.device)
        dst = torch.from_numpy(tbl[keep]).to(p.device)
        p[:, dst] = t.reshape(L, S // bs, bs, K, hd)[:, src].to(p.dtype)
    return pool


class BlockAllocator:
    """Host-side free-list over the physical blocks (block 0 reserved).

    ``quota`` caps *in-use* blocks below the physical pool size, so a
    fleet arbiter can carve one physical pool into per-model shares and
    move capacity between them without reshaping any device array.
    Shrinking the quota below current usage is legal: nothing is
    reclaimed eagerly, the allocator just refuses growth until enough
    blocks drain back through ``free`` (deferred handback).
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one block beyond the null block")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: deque = deque(range(1, num_blocks))
        self._quota = num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def quota(self) -> int:
        return self._quota

    def set_quota(self, n: int) -> None:
        """Cap in-use blocks at ``n`` (clamped to the physical pool)."""
        self._quota = max(0, min(int(n), self.num_blocks - 1))

    def blocks_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.block_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical blocks, or None (all-or-nothing) if the pool is dry
        or the grant would exceed the quota."""
        if n > len(self._free) or self.in_use + n > self._quota:
            return None
        return [self._free.popleft() for _ in range(n)]

    def free(self, blocks: List[int]):
        for b in blocks:
            if b == NULL_BLOCK:
                raise ValueError("freeing the null block")
            self._free.append(b)


class SlotTables:
    """Per-slot logical->physical block maps + lengths, as one pinned numpy
    pair that is shipped to the device every iteration (small: ints)."""

    def __init__(self, max_slots: int, max_blocks_per_slot: int):
        self.max_slots = max_slots
        self.max_blocks_per_slot = max_blocks_per_slot
        self.tables = np.full((max_slots, max_blocks_per_slot), NULL_BLOCK,
                              np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.owned: List[List[int]] = [[] for _ in range(max_slots)]

    def assign(self, slot: int, blocks: List[int], length: int):
        self.tables[slot] = NULL_BLOCK
        self.tables[slot, :len(blocks)] = blocks
        self.lengths[slot] = length
        self.owned[slot] = list(blocks)

    def grow(self, slot: int, block: int):
        n = len(self.owned[slot])
        if n >= self.max_blocks_per_slot:
            raise ValueError(f"slot {slot} exceeds max_blocks_per_slot")
        self.tables[slot, n] = block
        self.owned[slot].append(block)

    def release(self, slot: int) -> List[int]:
        blocks, self.owned[slot] = self.owned[slot], []
        self.tables[slot] = NULL_BLOCK
        self.lengths[slot] = 0
        return blocks

    def capacity_tokens(self, slot: int, block_size: int) -> int:
        """Positions this slot can hold before needing another block."""
        return len(self.owned[slot]) * block_size
