"""Chunked replica-weight migration into the replica store's back rows.

``make_migrate_step`` is the counterpart of the JAX package's fixed-shape
migration step: it returns a function that enqueues one chunk of diff
entries. An entry ``(layer, dst_slot, src_expert)`` is one row copy per
weight name, from home row ``src_expert`` into the back row of
``dst_slot`` (``runtime.store``). On a CUDA device the copies go to a side
stream the executor owns, so they run under the forward compute of the
main stream; each copy indexes persistent tensors with Python ints, so a
tick allocates no device memory. On the CPU the copies run at once. With
one EP rank a process the row goes from the expert's home rank to the
slot's (``ReplicaStore.copy_experts``); every rank runs the same diff.

``MigrationExecutor`` runs a diff under a per-engine-step chunk budget;
the engine keeps serving on the old plan and the live rows until ``tick``
reports the commit, when the filled slots swap their live and back rows
(``ReplicaStore.adopt``). ``LayerStagedExecutor`` fills in layer order
and reports a per-layer ready mask, with one CUDA event per layer
recorded after that layer's last copy: a forward reads a ready layer's
filled rows under the target plan once the main stream has waited on that
layer's event.

Stream order. ``begin`` records an event on the main stream and makes the
side stream wait on it, so a fill never overwrites a back row that a
forward queued before it still reads (the row live before the last
commit, or rows a cancelled migration's ready layers were read from). The
commit makes the main stream wait on the fill's last copy. The host never
waits on the side stream. Bookkeeping (bytes per tick, the commit tick,
the ready masks) is the JAX executors'.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.placement import PlacementPlan
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime.diff import PlanDiff
from repro_torch.runtime.store import ReplicaStore


def make_migrate_step(store: ReplicaStore,
                      stream: Optional["torch.cuda.Stream"] = None):
    """Returns ``step(layer, dst_slot, src_expert)`` issuing the row copies
    of the given entries (host int arrays of one length) into ``store``'s
    back rows, on ``stream`` when one is given (CUDA), else at once."""
    def step(layer, dst_slot, src_expert) -> None:
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        layer = np.asarray(layer).tolist()
        dst_slot = np.asarray(dst_slot).tolist()
        with ctx:
            store.copy_experts(layer, dst_slot,
                               np.asarray(src_expert).tolist(),
                               [store.back_row(l, s)
                                for l, s in zip(layer, dst_slot)])
    return step


class MigrationExecutor:
    """serve -> diff -> chunked fill -> swap state machine."""

    def __init__(self, step_fn, store: ReplicaStore, *, chunk: int = 8,
                 chunks_per_tick: int = 0, tracer=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        """``step_fn``: ``make_migrate_step(store, stream)``.
        ``chunks_per_tick``: chunks per engine iteration (the per-step
        budget); 0 = drain the whole diff in one tick. ``stream``: the side
        stream ``step_fn`` enqueues on (None on the CPU). ``tracer``:
        optional ``repro_torch.obs.SpanTracer`` — begin/cancel/commit
        instants plus one ``migration.tick`` span per active tick land on a
        dedicated "migration" track."""
        self.step_fn = step_fn
        self.store = store
        self.entry_bytes = int(store.entry_bytes)
        self.chunk = max(int(chunk), 1)
        self.chunks_per_tick = int(chunks_per_tick)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.stream = stream
        self._diff: Optional[PlanDiff] = None
        self._target_plan: Optional[PlacementPlan] = None
        self._target_se: Optional[np.ndarray] = None
        self._cursor = 0

    @property
    def active(self) -> bool:
        return self._diff is not None

    def _record(self, stream) -> Optional["torch.cuda.Event"]:
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def begin(self, diff: PlanDiff, target_plan: PlacementPlan) -> None:
        """Stage a migration toward ``target_plan``. Restarting while active
        abandons the partial fill (it wrote back rows only, which nothing
        reads once the ready mask is gone)."""
        if self.stream is not None:
            self.stream.wait_event(self._record(
                torch.cuda.current_stream(self.stream.device)))
        self._diff = diff
        self._target_plan = target_plan
        self._target_se = np.asarray(diff.target_slot_experts)
        self._cursor = 0
        self.tracer.instant(
            "migration.begin", cat="migration", track="migration",
            args={"entries": int(diff.num_entries),
                  "bytes": int(diff.num_entries) * self.entry_bytes})

    def cancel(self) -> None:
        """Abandon an in-flight migration (the target plan was superseded).
        The live rows were never written, so there is nothing to undo."""
        if self._diff is not None:
            self.tracer.instant(
                "migration.cancel", cat="migration", track="migration",
                args={"filled_entries": int(self._cursor)})
        self._clear()

    def _clear(self) -> None:
        self._diff = self._target_plan = self._target_se = None
        self._cursor = 0

    def _enqueue(self, start: int, stop: int) -> None:
        d = self._diff
        self.step_fn(d.layer[start:stop], d.dst_slot[start:stop],
                     d.src_expert[start:stop])

    def _run_chunk(self) -> int:
        c = self._cursor
        n = min(self.chunk, self._diff.num_entries - c)
        self._enqueue(c, c + n)
        self._cursor += n
        return n

    def tick(self, budget: Optional[int] = None) -> Tuple[Optional[tuple], int]:
        """Enqueue up to the per-step chunk budget (``budget`` overrides the
        constructor's ``chunks_per_tick``). Returns ``(commit,
        bytes_moved)`` — ``commit`` is ``((layer, dst_slot), target_plan,
        target_slot_experts)`` once the fill is enqueued in full (the engine
        swaps plan and store rows at once), else None."""
        if not self.active:
            return None, 0
        cap = self.chunks_per_tick if budget is None else int(budget)
        with self.tracer.span("migration.tick", cat="migration",
                              track="migration") as sp:
            moved = 0
            chunks = 0
            while self._cursor < self._diff.num_entries:
                moved += self._run_chunk()
                chunks += 1
                if cap and chunks >= cap:
                    break
            done = self._cursor >= self._diff.num_entries
            sp.set_args(chunks=chunks, moved_bytes=moved * self.entry_bytes,
                        remaining=int(self._diff.num_entries - self._cursor))
        if not done:
            return None, moved * self.entry_bytes
        if self.stream is not None:
            # the committed rows are read by the next forward
            torch.cuda.current_stream(self.stream.device).wait_event(
                self._record(self.stream))
        d = self._diff
        commit = ((d.layer, d.dst_slot), self._target_plan, self._target_se)
        self.tracer.instant(
            "migration.commit", cat="migration", track="migration",
            args={"entries": int(d.num_entries),
                  "bytes": int(d.num_entries) * self.entry_bytes})
        self._clear()
        return commit, moved * self.entry_bytes


class LayerStagedExecutor(MigrationExecutor):
    """Layer-ordered chunked fill with a per-layer ready mask.

    Entries are filled in forward-scan order, so at any point the back rows
    hold the complete target contents for a prefix of layers.
    ``ready_mask()`` reports which layers those are; the engine threads it
    (with ``target_plan``, ``target_rows`` and ``fill_events``) into
    ``forward``, whose per-layer select adopts each layer the moment its
    fill lands. Layers whose diff is empty are ready immediately: every
    live slot already holds the target expert.
    """

    def __init__(self, step_fn, store: ReplicaStore, *, num_layers: int,
                 chunk: int = 8, chunks_per_tick: int = 0, tracer=None,
                 stream: Optional["torch.cuda.Stream"] = None):
        super().__init__(step_fn, store, chunk=chunk,
                         chunks_per_tick=chunks_per_tick, tracer=tracer,
                         stream=stream)
        self.num_layers = int(num_layers)
        self._layer_end: Optional[np.ndarray] = None   # (L,) cum entry count
        self._target_rows: Optional[np.ndarray] = None
        self._events: List[Optional["torch.cuda.Event"]] = \
            [None] * self.num_layers

    def begin(self, diff: PlanDiff, target_plan: PlacementPlan) -> None:
        order = np.argsort(np.asarray(diff.layer), kind="stable")
        staged = PlanDiff(layer=np.asarray(diff.layer)[order],
                          dst_slot=np.asarray(diff.dst_slot)[order],
                          src_expert=np.asarray(diff.src_expert)[order],
                          target_slot_experts=diff.target_slot_experts)
        super().begin(staged, target_plan)
        counts = np.bincount(staged.layer, minlength=self.num_layers)
        self._layer_end = np.cumsum(counts)
        self._target_rows = self.store.target_rows(staged.layer,
                                                   staged.dst_slot)
        self._events = [None] * self.num_layers

    def _clear(self) -> None:
        super()._clear()
        self._layer_end = None
        self._target_rows = None

    def _run_chunk(self) -> int:
        """One chunk, enqueued a layer at a time, with each layer's event
        recorded after its last entry."""
        c = self._cursor
        stop = min(c + self.chunk, self._diff.num_entries)
        while c < stop:
            l = int(self._diff.layer[c])
            end = min(stop, int(self._layer_end[l]))
            self._enqueue(c, end)
            if end == self._layer_end[l]:
                self._events[l] = self._record(self.stream)
            c = end
        n = stop - self._cursor
        self._cursor = stop
        return n

    def ready_mask(self) -> np.ndarray:
        """(L,) bool: layers whose fill is enqueued in full (a forward may
        read them from their filled rows under the target plan after
        waiting on ``fill_events()[l]``). All-False when idle — the
        forward then reads the live rows."""
        if not self.active or self._layer_end is None:
            return np.zeros((self.num_layers,), bool)
        return self._layer_end <= self._cursor

    def fill_events(self) -> List[Optional["torch.cuda.Event"]]:
        """Per layer, the event recorded after the layer's last copy (None
        on the CPU and for layers with nothing to copy)."""
        return list(self._events)

    @property
    def back_weights(self):
        """The store's row tensors, which the in-flight fill writes (None
        when idle)."""
        return self.store.weights if self.active else None

    @property
    def target_plan(self) -> Optional[PlacementPlan]:
        return self._target_plan

    @property
    def target_rows(self) -> Optional[np.ndarray]:
        """(L, S) rows each slot reads once the fill commits: a filled
        slot's back row, every other slot's live row (None when idle)."""
        return self._target_rows

    @property
    def remaining_entries(self) -> int:
        if not self.active:
            return 0
        return self._diff.num_entries - self._cursor


def migrate_all(step_fn, store: ReplicaStore, diff: PlanDiff, *,
                chunk: int = 8, stream: Optional["torch.cuda.Stream"] = None):
    """Synchronous helper: fill a whole diff and commit it to ``store``
    (the slot map becomes the diff's target). ``stream``: the one
    ``step_fn`` enqueues on. Returns the store's row tensors."""
    ex = MigrationExecutor(step_fn, store, chunk=chunk, stream=stream)
    ex.begin(diff, None)
    (filled, _, se), _ = ex.tick()
    store.adopt(se, filled)
    return store.weights
