"""FleetEngine: N ContinuousEngine-backed models on one device (the port of
the JAX package's ``fleet/engine.py``).

One fleet = one HBM budget, carved by a ``FleetBudget`` ledger into
per-model shares of (weights + replica-store dup slots + paged KV blocks),
with a ``FleetArbiter`` moving dup-slot and KV-block quota between models
as per-tenant SLO attainment, queue depth and window skew shift. Every
model instance keeps its own ``OnlineGPSController``, ``ServeMetrics``
(labelled series in a SHARED ``MetricsRegistry``), ``SpanTracer`` (merged
by ``obs.trace.merge_traces``, one process row per model) and
``GPSAuditLog``: the paper's per-model GPS loop runs unchanged inside a
fleet that reallocates capacity above it.

Every arbiter move is a quota change inside what the engines allocated at
build time (``ContinuousEngine.set_dup_slot_quota``,
``BlockAllocator.set_quota``): nothing is re-allocated while serving. The
engines time-share the card: one fleet ``step()`` steps every runnable
engine once on a common virtual clock.

Two specs may share one ``Transformer`` (an A/B of one model). Under
``ep`` each engine then builds its own replica store from the shared
weights and re-points them to the store's home rows; every engine reads
its own store.

The JAX fleet's ``compile_counts`` / ``assert_no_recompiles`` have no
counterpart: eager PyTorch does not recompile.
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.fleet.admission import FleetAdmission
from repro_torch.fleet.arbiter import (ArbiterConfig, ArbiterMove,
                                       FleetArbiter, ModelSignals)
from repro_torch.fleet.budget import (FleetBudget, ModelShare, kv_block_bytes,
                                      params_bytes)
from repro_torch.models.transformer import Transformer
from repro_torch.obs.audit import GPSAuditLog
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import SpanTracer, merge_traces
from repro_torch.runtime.cost import entry_bytes
from repro_torch.runtime.store import EXPERT_WEIGHTS
from repro_torch.serve.engine import (ContinuousConfig, ContinuousEngine,
                                      StepEvents)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import ServeRequest


@dataclass
class FleetModelSpec:
    """One resident model: config + weights + its serving configuration.

    ``dup_slot_quota`` / ``kv_block_quota`` set the model's INITIAL active
    quota below its allocated ceiling (-1 = full): how a static split
    carves the fleet, and the starting point the arbiter moves capacity
    from.
    """
    name: str
    cfg: ModelConfig
    model: Transformer
    ccfg: ContinuousConfig
    predictor: Any = None
    controller: Any = None       # OnlineGPSController (audit log attached)
    dup_slot_quota: int = -1
    kv_block_quota: int = -1


class FleetEngine:
    """Host N model instances against one budget, arbitrate between them.

    ``ep`` / ``ep_ranks``: every engine's expert parallelism (the ranks as
    a leading tensor dimension on the one device). ``hbm_budget_bytes``:
    the per-rank budget the ledger clamps and arbitrates within (0 =
    unlimited: the ledger still tracks, never constrains).
    ``enable_arbiter=False`` freezes the post-clamp static split (the A/B
    baseline leg). ``device``: where the specs' weights live (default
    "cuda"; pass "cpu" to run the plain path)."""

    def __init__(self, specs: List[FleetModelSpec], *, ep: bool = False,
                 ep_ranks: int = 1, hbm_budget_bytes: float = 0.0,
                 admission: Optional[FleetAdmission] = None,
                 arbiter_cfg: Optional[ArbiterConfig] = None,
                 enable_arbiter: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 trace: bool = False, device="cuda"):
        if not specs:
            raise ValueError("a fleet needs at least one model")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate model names: {names}")
        self.device = resolve_device(device)
        for s in specs:
            if s.model.device.type != self.device.type:
                raise ValueError(f"model {s.name!r} lives on "
                                 f"{s.model.device}, the fleet on "
                                 f"{self.device}")
        self.ep_ranks = ep_ranks
        self.registry = registry if registry is not None else MetricsRegistry()
        self.admission = admission if admission is not None else \
            FleetAdmission(routes={}, default_model=specs[0].name)
        self.budget = FleetBudget(hbm_budget_bytes)

        # ----- ledger rows BEFORE engine construction: the global clamp
        # decides the dup_slots each engine allocates
        for s in specs:
            cfg, ccfg = s.cfg, s.ccfg
            entry = 0
            if cfg.is_moe:
                entry = entry_bytes({k: [getattr(layer, k)
                                         for layer in s.model.layers]
                                     for k in EXPERT_WEIGHTS})
            self.budget.register(ModelShare(
                name=s.name,
                weights_bytes=params_bytes(s.model) // max(ep_ranks, 1),
                entry_bytes=entry,
                num_layers=cfg.num_layers,
                num_experts=cfg.moe.num_experts if cfg.is_moe else 0,
                ep_ranks=ep_ranks,
                dup_slots=ccfg.dup_slots if cfg.is_moe else 0,
                kv_blocks=ccfg.num_blocks - 1,
                kv_block_bytes=kv_block_bytes(
                    cfg.num_layers, ccfg.block_size, cfg.num_kv_heads,
                    cfg.head_dim),
                dup_slot_quota=s.dup_slot_quota if cfg.is_moe else 0,
                kv_block_quota=s.kv_block_quota))
        clamped = self.budget.clamp()

        self.engines: Dict[str, ContinuousEngine] = {}
        self.tracers: Dict[str, SpanTracer] = {}
        for i, s in enumerate(specs):
            share = self.budget.shares[s.name]
            ccfg = s.ccfg
            if s.cfg.is_moe and clamped[s.name] != ccfg.dup_slots:
                ccfg = dataclasses.replace(ccfg, dup_slots=clamped[s.name])
            slo = self.admission.strictest_slo(s.name)
            metrics = ServeMetrics(
                window_iters=ccfg.metrics_window, slo_ttft=slo.slo_ttft,
                slo_tpot=slo.slo_tpot, registry=self.registry, model=s.name)
            tracer = SpanTracer(process_name=s.name, pid=i + 1,
                                enabled=trace)
            eng = ContinuousEngine(
                s.cfg, s.model, ccfg, ep_ranks=ep_ranks, ep=ep,
                predictor=s.predictor, controller=s.controller,
                tracer=tracer, metrics=metrics, name=s.name)
            # the engine may have clamped its own dup_slots further (store
            # budget): keep the ledger honest about the ceiling
            if eng.moe_cfg is not None:
                share.dup_slots = eng.moe_cfg.duplication_slots
                share.dup_slot_quota = min(share.dup_slot_quota,
                                           share.dup_slots)
            eng.set_dup_slot_quota(share.dup_slot_quota)
            eng.allocator.set_quota(share.kv_block_quota)
            self.engines[s.name] = eng
            self.tracers[s.name] = tracer

        self.arbiter = FleetArbiter(arbiter_cfg, self.budget) \
            if enable_arbiter else None
        self._acfg = arbiter_cfg if arbiter_cfg is not None \
            else ArbiterConfig()
        self.iterations = 0
        self._step_walls: List[float] = []
        # per-engine WALL step-time EMA: the engines' own _recent_step_s
        # tracks the virtual clock (zero under a frozen clock), but the
        # arbiter's cost gate weighs migration stall against real seconds
        self._eng_step_s: Dict[str, float] = {n: 0.0 for n in self.engines}

    # ---------------------------------------------------------------- warmup
    def warmup(self):
        """Warm every engine (their first prefill and decode)."""
        for eng in self.engines.values():
            eng.warmup()

    # ------------------------------------------------------------ submission
    def submit(self, req: ServeRequest) -> str:
        model = self.admission.route(req.tenant)
        self.engines[model].submit(req)
        return model

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines.values())

    def _runnable(self, eng: ContinuousEngine, now: float) -> bool:
        return bool(eng.scheduler.active_slots) or any(
            r.arrival <= now for r in eng.scheduler.waiting)

    def next_arrival(self) -> Optional[float]:
        arrivals = [r.arrival for e in self.engines.values()
                    for r in e.scheduler.waiting]
        return min(arrivals) if arrivals else None

    # ------------------------------------------------------------------ step
    def step(self, now: float, clock=None) -> Dict[str, StepEvents]:
        """One fleet iteration: step every runnable engine once, then (at
        window boundaries) evaluate the arbiter and apply its moves."""
        t0 = _time.perf_counter()
        events: Dict[str, StepEvents] = {}
        for name, eng in self.engines.items():
            if self._runnable(eng, now):
                t1 = _time.perf_counter()
                events[name] = eng.step(now, clock=clock)
                d = _time.perf_counter() - t1
                prev = self._eng_step_s[name]
                self._eng_step_s[name] = d if prev <= 0 \
                    else 0.9 * prev + 0.1 * d
        self.iterations += 1
        self._step_walls.append(_time.perf_counter() - t0)
        if self.arbiter is not None \
                and self.iterations % self._acfg.window_iters == 0:
            self._arbitrate(now)
        return events

    def _signals(self, now: float) -> Dict[str, ModelSignals]:
        out = {}
        for name, eng in self.engines.items():
            share = self.budget.shares[name]
            skew = eng.metrics.windows[-1].skew if eng.metrics.windows \
                else 0.0
            out[name] = ModelSignals(
                slo_attainment=self.admission.model_attainment(
                    eng.metrics, name),
                queue_depth=eng.scheduler.queue_depth(now),
                window_skew=skew,
                step_s=self._eng_step_s[name] or eng._recent_step_s,
                dup_entry_bytes=share.dup_slot_entry_bytes)
        return out

    def _arbitrate(self, now: float) -> List[ArbiterMove]:
        moves = self.arbiter.observe(now, self._signals(now))
        for mv in moves:
            if mv.dup_slots:
                src, dst = self.engines[mv.src], self.engines[mv.dst]
                src.set_dup_slot_quota(
                    self.budget.shares[mv.src].dup_slot_quota)
                dst.set_dup_slot_quota(
                    self.budget.shares[mv.dst].dup_slot_quota)
            if mv.kv_blocks:
                self.engines[mv.src].allocator.set_quota(
                    self.budget.shares[mv.src].kv_block_quota)
                self.engines[mv.dst].allocator.set_quota(
                    self.budget.shares[mv.dst].kv_block_quota)
            self.tracers[mv.dst].instant(
                "fleet.arbiter_move", cat="fleet",
                args={"src": mv.src, "dst": mv.dst,
                      "dup_slots": mv.dup_slots, "kv_blocks": mv.kv_blocks})
        for name, p in (self.arbiter.last_pressure or {}).items():
            self.registry.gauge("fleet_pressure",
                                "Arbiter pressure score per model",
                                model=name).set(p)
        if moves:
            self.registry.counter(
                "fleet_arbiter_moves_total",
                "Committed cross-model quota moves").inc(len(moves))
        return moves

    # ------------------------------------------------------------ trace run
    def run_trace(self, requests: List[ServeRequest], *, max_iters: int = 0,
                  time_scale: float = 1.0) -> float:
        """Replay one trace across the fleet on a shared virtual clock
        (``ContinuousEngine.run_trace`` semantics: iterations cost measured
        wall x ``time_scale``, fleet-wide idle gaps fast-forward)."""
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        now = 0.0
        iters = 0
        while self.has_work():
            if not any(self._runnable(e, now)
                       for e in self.engines.values()):
                nxt = self.next_arrival()
                if nxt is None:
                    break
                now = max(now, nxt)
            t0 = _time.perf_counter()
            start = now
            self.step(start, clock=lambda: start + (
                _time.perf_counter() - t0) * time_scale)
            now = start + (_time.perf_counter() - t0) * time_scale
            iters += 1
            if max_iters and iters >= max_iters:
                break
        for eng in self.engines.values():
            eng.metrics.flush(
                eng._plan_stack, eng.ep_ranks,
                eng.moe_cfg.duplication_slots if eng.moe_cfg else 0)
        return now

    # --------------------------------------------------------------- summary
    def summary(self) -> Dict[str, float]:
        """Fleet-level columns + per-model ledger rows. Per-tenant SLO
        attainment is judged against each tenant's class and weighted by
        completions, so one starved hot tenant shows up even when a cold
        model's easy traffic all meets its SLO."""
        good = total = 0
        worst = 1.0
        for name, eng in self.engines.items():
            for tenant in (self.admission.tenants_for(name) or [""]):
                slo = self.admission.slo_for(tenant)
                ts = [t for t in eng.metrics.timings
                      if not tenant or t.tenant == tenant]
                ok = sum(1 for t in ts if t.ttft <= slo.slo_ttft
                         and t.tpot <= slo.slo_tpot)
                good += ok
                total += len(ts)
                if ts:
                    worst = min(worst, ok / len(ts))
        attainment = good / total if total else 1.0
        walls = np.asarray(self._step_walls or [0.0], np.float64)
        out = {
            "fleet_models": float(len(self.engines)),
            "fleet_iterations": float(self.iterations),
            "fleet_completed": float(total),
            "fleet_slo_attainment": attainment,
            "fleet_slo_attainment_worst": worst,
            "fleet_arbiter_moves": float(len(self.arbiter.moves)
                                         if self.arbiter else 0),
            "fleet_step_p50_ms": float(np.percentile(walls, 50) * 1e3),
            "fleet_step_p99_ms": float(np.percentile(walls, 99) * 1e3),
            **self.budget.summary(),
        }
        for k, v in out.items():
            if isinstance(v, float):
                self.registry.gauge(f"fleet_{k}" if not k.startswith("fleet_")
                                    else k,
                                    f"Fleet summary column {k}").set(v)
        return out

    def merged_trace(self) -> Dict[str, Any]:
        """One Chrome trace document, one process row per model, plus each
        model's GPS audit log in ``otherData``."""
        docs, names = [], []
        for name, tracer in self.tracers.items():
            doc = tracer.to_chrome()
            ctrl = self.engines[name].controller
            audit = getattr(ctrl, "audit", None) if ctrl else None
            if isinstance(audit, GPSAuditLog):
                doc["otherData"]["gps_audit"] = audit.to_obj()
            docs.append(doc)
            names.append(name)
        return merge_traces(docs, names)
