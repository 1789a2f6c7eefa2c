"""Request schedulers (the port's copies of the JAX package's).

* ``BatchScheduler`` — the pad-to-one-batch FIFO that feeds
  ``ServeEngine`` (``launch/serve.py``).
* ``ContinuousScheduler`` — continuous batching. Requests arrive at arbitrary times, are admitted into fixed *slots* as
capacity (slots + KV blocks) allows, decode every iteration at their own
position, and leave the instant they finish. KV memory is managed
per-slot through a ``BlockAllocator`` (paged pool); when the pool runs dry
the youngest running request is preempted (blocks freed, request requeued
for full recompute — greedy decoding makes the retry deterministic).

The scheduler is pure host-side bookkeeping: it never touches device
tensors, it only decides *what* the engine's steps run on next.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serve.kvcache import BlockAllocator, SlotTables


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class Request:
    """A request of the synchronous ``BatchScheduler``."""
    rid: int
    tokens: np.ndarray            # (S,) prompt tokens
    max_new_tokens: int = 8
    generated: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class ServeRequest:
    """A request flowing through the continuous engine."""
    rid: int
    tokens: np.ndarray            # (S,) prompt tokens
    max_new_tokens: int = 8
    arrival: float = 0.0
    tenant: str = ""
    generated: List[int] = field(default_factory=list)
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    n_preemptions: int = 0
    # timestamps stamped by the engine (virtual/wall clock of the driver)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


# ---------------------------------------------------------------------------
# pad-to-one-batch FIFO
# ---------------------------------------------------------------------------

def pad_fifo_batch(batch_reqs, batch_size: int, seq_len: int, pad_id: int = 0
                   ) -> Dict:
    """Pad a FIFO group to (batch_size, seq_len): prompts right-padded with
    ``pad_id`` (truncated above ``seq_len``), missing rows all zeros, and a
    (batch_size, seq_len) float mask of the real tokens."""
    toks = np.full((len(batch_reqs), seq_len), pad_id, np.int32)
    mask = np.zeros((len(batch_reqs), seq_len), np.float32)
    for i, r in enumerate(batch_reqs):
        s = min(len(r.tokens), seq_len)
        toks[i, :s] = r.tokens[:s]
        mask[i, :s] = 1.0
    if len(batch_reqs) < batch_size:
        pad = batch_size - len(batch_reqs)
        toks = np.concatenate([toks, np.zeros((pad, seq_len), np.int32)])
        mask = np.concatenate([mask, np.zeros((pad, seq_len), np.float32)])
    return {"tokens": toks, "mask": mask, "requests": list(batch_reqs)}


class BatchScheduler:
    """FIFO scheduler: pads prompts to a common length, yields full batches."""

    def __init__(self, batch_size: int, seq_len: int, pad_id: int = 0):
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def has_work(self) -> bool:
        return len(self.queue) > 0

    def next_batch(self) -> Optional[Dict]:
        if not self.queue:
            return None
        batch_reqs = self.queue[:self.batch_size]
        self.queue = self.queue[self.batch_size:]
        return pad_fifo_batch(batch_reqs, self.batch_size, self.seq_len,
                              self.pad_id)

    def finish(self, reqs: List[Request], generated: np.ndarray):
        for i, r in enumerate(reqs):
            r.generated.extend(int(t) for t in generated[i])
            self.completed.append(r)


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

@dataclass
class IterationPlan:
    """What the engine should run this iteration."""
    prefills: List[ServeRequest] = field(default_factory=list)
    decode_slots: List[int] = field(default_factory=list)
    preempted: List[ServeRequest] = field(default_factory=list)


class ContinuousScheduler:
    """Continuous-batching admission + slot + KV-block management.

    ``max_slots``      — concurrent requests (the decode batch dimension).
    ``prefill_len``    — prompt bucket: prompts are right-padded to this
                         (and truncated above it); one jit compile total.
    ``max_len``        — per-request position budget (prompt + generation).
    ``allocator``      — shared ``BlockAllocator`` over the physical pool.
    ``max_prefills_per_step`` — admission rate limit per iteration (bounds
                         prefill head-of-line blocking of running decodes).
    """

    def __init__(self, max_slots: int, prefill_len: int, max_len: int,
                 allocator: BlockAllocator, max_prefills_per_step: int = 2):
        if max_len < prefill_len:
            raise ValueError("max_len must cover the prefill bucket")
        self.max_slots = max_slots
        self.prefill_len = prefill_len
        self.max_len = max_len
        self.alloc = allocator
        self.max_prefills_per_step = max_prefills_per_step
        bs = allocator.block_size
        self.tables = SlotTables(max_slots, -(-max_len // bs))
        self.waiting: List[ServeRequest] = []
        self.slots: List[Optional[ServeRequest]] = [None] * max_slots
        self.completed: List[ServeRequest] = []

    # ------------------------------------------------------------ submission
    def submit(self, req: ServeRequest):
        if req.prompt_len == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.prompt_len > self.prefill_len:
            req.tokens = np.asarray(req.tokens[:self.prefill_len])
        # prefill always emits the first token, so the budget floor is 1
        req.max_new_tokens = max(1, min(req.max_new_tokens,
                                        self.max_len - req.prompt_len))
        # positions ever written: the prompt plus each generated token fed
        # BACK as decode input — the final token comes out of logits and
        # never writes KV, hence the -1
        need = self.alloc.blocks_for(req.prompt_len + req.max_new_tokens - 1)
        if need > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request {req.rid} needs {need} blocks but the pool only "
                f"has {self.alloc.num_blocks - 1}: it would preempt itself "
                "forever")
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.slots)

    def queue_depth(self, now: Optional[float] = None) -> int:
        """Waiting requests eligible to run (arrived by ``now``; all of
        them when ``now`` is None). The fleet arbiter reads this as the
        admission-backpressure signal: a persistently deep queue means
        the model's slot/KV share is starving it."""
        if now is None:
            return len(self.waiting)
        return sum(1 for r in self.waiting if r.arrival <= now)

    @property
    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def request_in(self, slot: int) -> ServeRequest:
        r = self.slots[slot]
        assert r is not None, f"slot {slot} idle"
        return r

    # ------------------------------------------------------------- admission
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def _admit(self, req: ServeRequest, now: float) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        n = self.alloc.blocks_for(req.prompt_len)
        blocks = self.alloc.alloc(n)
        if blocks is None:
            return False
        req.slot = slot
        req.state = RequestState.RUNNING
        req.t_admitted = now
        req.generated = []
        self.slots[slot] = req
        self.tables.assign(slot, blocks, req.prompt_len)
        return True

    def schedule(self, now: float) -> IterationPlan:
        """Admit what fits, then decode everything running."""
        plan = IterationPlan()
        admitted = 0
        while (self.waiting and admitted < self.max_prefills_per_step
               and self.waiting[0].arrival <= now):
            if not self._admit(self.waiting[0], now):
                break                          # no slot / no blocks: backpressure
            plan.prefills.append(self.waiting.pop(0))
            admitted += 1
        plan.decode_slots = self.active_slots
        return plan

    # ------------------------------------------------------ growth / evict
    def ensure_decode_capacity(self, plan: IterationPlan):
        """Before a decode step, every active slot must own the block its
        next position lands in. Grows tables; preempts the youngest
        request (LIFO) when the pool is dry — freeing ITS blocks for the
        others. A preempted request goes back to the head of the waiting
        queue for full recompute."""
        bs = self.alloc.block_size
        for slot in list(plan.decode_slots):
            req = self.slots[slot]
            if req is None:
                continue
            while (self.tables.lengths[slot] >= self.tables.capacity_tokens(
                    slot, bs)):
                blocks = self.alloc.alloc(1)
                if blocks is not None:
                    self.tables.grow(slot, blocks[0])
                    continue
                victim = self._youngest_running(exclude_finished=True)
                if victim is None or victim.slot == slot:
                    # nothing else to evict: preempt this request itself
                    self._preempt(req, plan)
                    break
                self._preempt(victim, plan)
        plan.decode_slots = self.active_slots

    def _youngest_running(self, exclude_finished=True) -> Optional[ServeRequest]:
        running = [r for r in self.slots if r is not None]
        if not running:
            return None
        return max(running, key=lambda r: (r.t_admitted or 0.0, r.rid))

    def _preempt(self, req: ServeRequest, plan: IterationPlan):
        slot = req.slot
        self.alloc.free(self.tables.release(slot))
        self.slots[slot] = None
        req.state = RequestState.WAITING
        req.slot = None
        req.generated = []
        req.n_preemptions += 1
        self.waiting.insert(0, req)
        plan.preempted.append(req)
        if slot in plan.decode_slots:
            plan.decode_slots.remove(slot)

    # --------------------------------------------------------------- finish
    def finish_slot(self, slot: int, now: float) -> ServeRequest:
        req = self.slots[slot]
        assert req is not None
        self.alloc.free(self.tables.release(slot))
        self.slots[slot] = None
        req.state = RequestState.FINISHED
        req.t_finished = now
        req.slot = None
        self.completed.append(req)
        return req
