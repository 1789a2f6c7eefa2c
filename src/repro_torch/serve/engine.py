"""Serving engines with the paper's Distribution-Only predict -> plan loop.

``ServeEngine`` (the port of the JAX package's ``ServeEngine`` as it runs
without a mesh) serves one padded batch at a time: a batched prefill, then
greedy decode at one position for the whole batch over the prefill's
cache. It serves every family the port has, and is the only engine for
hybrid (Griffin) models. MoE models take the single-device dense path;
the estimator, the accuracy window and Algorithm 1 re-plan on the
interval, and a new plan replaces the old one at once. With a tracer on,
its ``prefill`` and ``decode`` spans end after the device has finished
the step (one ``torch.cuda.synchronize`` each), so they read as step
times; with the null tracer nothing synchronises.

``ContinuousEngine`` is the port of the JAX package's
``ContinuousEngine`` as it runs without a mesh.

Each ``step()`` is one mixed iteration: admit + prefill up to
``max_prefills_per_step`` waiting requests into free slots, then run ONE
decode step for every running slot at its own position over the paged KV
pool. Every step feeds the per-layer expert histograms (padding and idle
slots weighted 0) to the ``DistributionEstimator``; every
``predict_interval`` steps ``replan()`` runs Algorithm 1 for each layer and
the new placement plan replaces the old one at once (the JAX engine's
``replica_impl="gather"`` behaviour).

``ep=True`` is the port's counterpart of giving the JAX engine a mesh: the
MoE layers run the expert-parallel dispatch with ``ep_ranks`` ranks as a
leading tensor dimension on one device, and the live plan decides which
slot each (token, k) pair goes to, which pairs are dropped at capacity and
which expert's weights each replica slot computes with. The plan moves to
the device once per re-plan. Dropped pairs are counted per iteration into
``ServeMetrics`` (``dropped_tokens``). Without ``ep`` (the default) the
layers run the exact dense path and ``ep_ranks`` only sizes the plan and
the modelled per-rank imbalance.

Not ported yet (see ROADMAP.md): the replica store and migration
executors with their plan-diff churn accounting, the online GPS
controller, the Token-to-Expert predictors, the reschedule lever,
``profile_phases`` and ``assert_no_recompiles``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.duplication import duplicate_experts_host
from repro_torch.core.placement import (PlacementPlan, identity_plan,
                                        stack_plans, to_device)
from repro_torch.core.predictors import DistributionEstimator
from repro_torch.models.transformer import Runtime, Transformer, init_cache
from repro_torch.obs.accuracy import PredictorAccuracyTracker
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.kvcache import (BlockAllocator, init_block_pool,
                                       write_prefill_blocks)
from repro_torch.serve.metrics import RequestTiming, ServeMetrics, imbalance
from repro_torch.serve.scheduler import (ContinuousScheduler, IterationPlan,
                                         ServeRequest)
from repro_torch.train.steps import (make_decode_step, make_paged_decode_step,
                                     make_prefill_step, make_slot_prefill_step)

STRATEGIES = ("none", "dist_only")


# ===========================================================================
# batched engine
# ===========================================================================

@dataclass
class ServeConfig:
    """Knobs of ``ServeEngine``: the fields of the JAX package's
    ``ServeConfig`` that its mesh-less path reads. ``token_to_expert``, a
    mesh, the replica store, overlapped migration, in-graph re-planning and
    the reschedule lever are not ported (ROADMAP.md)."""
    strategy: str = "dist_only"       # none | dist_only
    predict_interval: int = 1         # batches between re-plans (paper Sec 3.1)
    dup_slots: int = 1                # replica slots per EP rank
    max_copies: int = 4               # Algorithm 1 C_max
    ema: float = 0.9                  # moving-average for the MLE estimator
    max_len: int = 2048               # cache length for generation

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy {self.strategy!r}: the port serves "
                             f"{STRATEGIES} so far")


class ServeEngine:
    """Batched prefill + greedy decode with dynamic expert duplication, on
    the device the model's parameters live on."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 serve: ServeConfig, *, ep_ranks: int = 1, tracer=None):
        self.serve = serve
        self.ep_ranks = ep_ranks
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.batches_seen = 0
        self._plan_stack: Optional[PlacementPlan] = None
        self.history: List[dict] = []         # per-batch balance telemetry
        if cfg.is_moe:
            dup_slots = serve.dup_slots if serve.strategy != "none" else 0
            self.moe_cfg = dataclasses.replace(
                cfg.moe, duplication_slots=dup_slots,
                max_copies=serve.max_copies)
            cfg = dataclasses.replace(cfg, moe=self.moe_cfg)
            self.estimator = DistributionEstimator(
                cfg.num_layers, cfg.moe.num_experts, ema=serve.ema)
            self.accuracy = PredictorAccuracyTracker(
                cfg.num_layers, cfg.moe.num_experts)
        else:
            self.moe_cfg = self.estimator = self.accuracy = None
        self.cfg = cfg
        self.model = model
        self.device = model.device
        # no mesh: the MoE layers take the exact dense path, which reads no
        # placement plan, so the steps are not handed one
        self.rt = Runtime()
        self._prefill = make_prefill_step(cfg, self.rt)
        self._decode = make_decode_step(cfg, self.rt)

    # ------------------------------------------------------------------ plan
    def _identity_stack(self) -> Optional[PlacementPlan]:
        if not self.cfg.is_moe:
            return None
        m = self.moe_cfg
        return stack_plans([
            identity_plan(m.num_experts, self.ep_ranks, m.duplication_slots,
                          m.max_copies) for _ in range(self.cfg.num_layers)])

    def replan(self) -> Optional[PlacementPlan]:
        """Algorithm 1 per layer from the current distribution estimate
        (the identity plan for dense models or strategy "none")."""
        if not self.cfg.is_moe or self.serve.strategy == "none":
            return self._identity_stack()
        m = self.moe_cfg
        dist = self.estimator.predict()                  # (L, E)
        # without a mesh there are no replica weights to move: the new
        # plan is adopted at once
        self._plan_stack = stack_plans([
            duplicate_experts_host(dist[l], self.ep_ranks,
                                   m.duplication_slots, m.max_copies).plan
            for l in range(self.cfg.num_layers)])
        self.tracer.instant("plan.switch", cat="plan", track="plan",
                            args={"batch": self.batches_seen})
        return self._plan_stack

    # ----------------------------------------------------------------- steps
    def _sync(self):
        if self.tracer.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, batch, cache=None):
        """Prefill ``batch["tokens"]`` (B, S) (host array or tensor) into
        ``cache`` (a fresh one of ``max_len`` when None). Returns (logits
        (B, 1, V), cache, stats)."""
        t0 = time.perf_counter()
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        if cache is None:
            cache = init_cache(self.cfg, self.rt, B, self.serve.max_len,
                               device=self.device)
        logits, cache, stats = self._prefill(self.model, tokens, cache)
        self._observe(stats)
        self._sync()
        dt = time.perf_counter() - t0
        self.tracer.add_span("prefill", dt,
                             ts_ns=self.tracer.now_ns() - int(dt * 1e9),
                             args={"batch": B, "tokens": B * S})
        return logits, cache, stats

    def decode(self, tokens, cache, cache_len: int):
        """One greedy decode step for the batch at position ``cache_len``.
        Returns (next tokens (B, 1) int32, logits, cache, stats)."""
        with self.tracer.span("decode", args={"cache_len": cache_len}):
            out = self._decode(self.model, tokens, cache, cache_len)
            self._sync()
        return out

    def generate(self, batch, max_new_tokens: int = 8):
        """Prefill + greedy decode; returns (generated (B, T) int32 tensor,
        the last batch's telemetry)."""
        S = batch["tokens"].shape[1]
        logits, cache, _ = self.prefill(batch, cache=None)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [next_tok]
        for t in range(max_new_tokens - 1):
            next_tok, _, cache, _ = self.decode(next_tok, cache, S + t)
            out.append(next_tok)
        return torch.cat(out, dim=1), self.history[-1] if self.history else {}

    # -------------------------------------------------------------- observe
    def _observe(self, stats):
        """Feed router histograms to the estimator; replan on the interval."""
        self.batches_seen += 1
        if not self.cfg.is_moe or stats.get("expert_counts") is None:
            return
        counts = stats["expert_counts"].to("cpu", torch.float64).numpy()
        self.estimator.update(counts)
        self.accuracy.observe(counts)
        tele = {"batch": self.batches_seen,
                "skew": float(counts.sum(0).max()
                              / max(counts.sum(0).mean(), 1e-9))}
        self.history.append(tele)
        if (self.serve.strategy != "none"
                and self.batches_seen % self.serve.predict_interval == 0):
            wa = self.accuracy.close_window()
            if wa is not None:
                self.tracer.counter("pred_hit_rate", wa.hit_rate,
                                    track="predictor")
                tele["pred_hit_rate"] = wa.hit_rate
                tele["pred_kl"] = wa.kl
            self.replan()
            # score the distribution this re-plan just planned from
            # against the next window's realized routing
            self.accuracy.begin_window(self.estimator.predict(),
                                       self.serve.strategy)

    # ------------------------------------------------------------- telemetry
    def rank_loads(self, slot_counts: np.ndarray) -> np.ndarray:
        """(L, S) slot counts -> (L, R) per-rank token loads."""
        m = self.moe_cfg
        n_slots = m.num_experts // self.ep_ranks + m.duplication_slots
        sc = np.asarray(slot_counts, np.float64)
        return sc.reshape(sc.shape[0], self.ep_ranks, n_slots).sum(-1)


# ===========================================================================
# continuous batching
# ===========================================================================


@dataclass
class ContinuousConfig:
    """Knobs for the continuous-batching engine.

    The decode batch is always ``max_slots``, prompts pad to
    ``prefill_len``, and the KV pool holds ``num_blocks`` blocks of
    ``block_size`` positions.
    """
    max_slots: int = 8                # concurrent requests / decode batch
    prefill_len: int = 64             # prompt bucket (multiple of block_size)
    block_size: int = 16              # KV positions per block
    num_blocks: int = 0               # 0 = fully provision every slot
    max_len: int = 128                # per-request prompt+generation budget
    max_prefills_per_step: int = 2    # admission rate limit per iteration
    strategy: str = "dist_only"       # none | dist_only
    predict_interval: int = 4         # iterations between re-plans
    dup_slots: int = 1                # replica slots per EP rank
    max_copies: int = 4               # Algorithm 1 C_max
    ema: float = 0.9                  # estimator moving average
    eos_id: int = -1                  # -1: generate exactly max_new_tokens
    metrics_window: int = 16          # iterations per metrics window

    def __post_init__(self):
        if self.prefill_len % self.block_size:
            raise ValueError("prefill_len must be a block_size multiple")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy {self.strategy!r}: the port serves "
                             f"{STRATEGIES} so far")
        if self.num_blocks == 0:
            per_slot = -(-self.max_len // self.block_size)
            self.num_blocks = 1 + self.max_slots * per_slot   # +1: null block


@dataclass
class StepEvents:
    """What one engine iteration did (host-side bookkeeping for drivers)."""
    now: float
    prefilled: List[ServeRequest] = dataclasses.field(default_factory=list)
    completed: List[ServeRequest] = dataclasses.field(default_factory=list)
    preempted: List[ServeRequest] = dataclasses.field(default_factory=list)
    decoded_slots: int = 0


class ContinuousEngine:
    """Continuous-batching serving engine over a paged KV block pool, on
    the device the model's parameters live on."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 ccfg: ContinuousConfig, *, ep_ranks: int = 1,
                 ep: bool = False, tracer=None,
                 metrics: Optional[ServeMetrics] = None, name: str = ""):
        if not cfg.is_moe or cfg.attention != "gqa":
            raise ValueError("the port's engine serves GQA MoE models so far")
        if cfg.sliding_window and ccfg.prefill_len > cfg.sliding_window:
            # decode applies the window as a mask over the linear pool, but
            # prefill runs full-causal within the bucket — exact only while
            # the bucket fits inside the window
            raise ValueError(
                f"prefill_len {ccfg.prefill_len} exceeds the model's "
                f"sliding window {cfg.sliding_window}")
        if ep and ccfg.prefill_len % ep_ranks:
            raise ValueError(f"prefill_len {ccfg.prefill_len} does not split "
                             f"over {ep_ranks} EP ranks")
        self.ccfg = ccfg
        self.ep_ranks = ep_ranks
        self.ep = ep
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.name = name
        self.strategy = ccfg.strategy
        self.predict_interval = ccfg.predict_interval
        self.iterations = 0
        self.decode_steps = 0
        self._plan_stack: Optional[PlacementPlan] = None
        self._plan_dev = None            # the live plan on the device (EP)
        self._step_dropped = 0.0
        # (L, R * n_slots) pairs each global slot computed since the engine
        # was built (EP only): the measured per-slot, so per-rank, load
        self.slot_counts: Optional[np.ndarray] = None

        self.moe_cfg = dataclasses.replace(
            cfg.moe, duplication_slots=ccfg.dup_slots,
            max_copies=ccfg.max_copies)
        cfg = dataclasses.replace(cfg, moe=self.moe_cfg)
        self.estimator = DistributionEstimator(
            cfg.num_layers, cfg.moe.num_experts, ema=ccfg.ema)
        self.accuracy = PredictorAccuracyTracker(
            cfg.num_layers, cfg.moe.num_experts)
        self.cfg = cfg
        self.model = model
        self.device = model.device

        # window_override = max_len: the paged pool is linear in logical
        # positions (decode still masks to the architectural window)
        self.rt = Runtime(window_override=ccfg.max_len, ep=ep,
                          ep_ranks=ep_ranks)
        self.pool = init_block_pool(cfg, ccfg.num_blocks, ccfg.block_size,
                                    device=self.device)
        self.allocator = BlockAllocator(ccfg.num_blocks, ccfg.block_size)
        self.scheduler = ContinuousScheduler(
            ccfg.max_slots, ccfg.prefill_len, ccfg.max_len, self.allocator,
            max_prefills_per_step=ccfg.max_prefills_per_step)
        self.metrics = metrics if metrics is not None else \
            ServeMetrics(window_iters=ccfg.metrics_window)
        self._last_tokens = np.zeros((ccfg.max_slots,), np.int32)

        self._prefill_fn = make_slot_prefill_step(cfg, self.rt)
        self._decode_fn = make_paged_decode_step(cfg, self.rt)
        self._temp_cache = init_cache(cfg, self.rt, 1, ccfg.prefill_len,
                                      device=self.device)
        self._warm = False

    def _dev(self, a) -> torch.Tensor:
        """Host array -> a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------ plan
    def _identity_stack(self) -> PlacementPlan:
        m = self.moe_cfg
        return stack_plans([
            identity_plan(m.num_experts, self.ep_ranks, m.duplication_slots,
                          m.max_copies) for _ in range(self.cfg.num_layers)])

    def _current_plan(self) -> PlacementPlan:
        if self._plan_stack is None:
            self._set_plan(self._identity_stack())
        return self._plan_stack

    def _set_plan(self, plan: PlacementPlan) -> None:
        self._plan_stack = plan
        if self.ep:
            m = self.moe_cfg
            self._plan_dev = to_device(plan, m.num_experts, self.ep_ranks,
                                       m.duplication_slots, self.device)

    def replan(self) -> PlacementPlan:
        """Algorithm 1 per layer from the estimator's current prediction
        (the identity plan under strategy "none"); the new plan stack
        replaces the old one at once."""
        m = self.moe_cfg
        if self.strategy == "none":
            plan = self._identity_stack()
        else:
            dist = self.estimator.predict()
            plan = stack_plans([duplicate_experts_host(
                dist[l], self.ep_ranks, m.duplication_slots,
                m.max_copies).plan for l in range(self.cfg.num_layers)])
        extra = int((np.asarray(plan.n_replicas) - 1).sum())
        self.metrics.record_replan(extra)
        self.tracer.instant(
            "plan.switch", cat="plan", track="plan",
            args={"iteration": self.iterations, "strategy": self.strategy,
                  "extra_copies": extra})
        self._set_plan(plan)
        return plan

    # ---------------------------------------------------------------- warmup
    def warmup(self):
        """Build the decode kernel (at its first launch) and run one prefill
        and one decode. Must run before any request is admitted. Every
        warmup slot is idle, so nothing is written into the pool."""
        if self.scheduler.active_slots:
            raise RuntimeError("warmup() before serving")
        ccfg = self.ccfg
        self._current_plan()
        self._prefill_fn(
            self.model, self._dev(np.zeros((1, ccfg.prefill_len), np.int32)),
            self._temp_cache, self._dev(np.zeros((1,), np.int32)),
            self._dev(np.zeros((1, ccfg.prefill_len), np.float32)),
            self._plan_dev)
        tables = np.zeros(
            (ccfg.max_slots, self.scheduler.tables.max_blocks_per_slot),
            np.int32)
        next_tok, _, _, _ = self._decode_fn(
            self.model, self._dev(np.zeros((ccfg.max_slots, 1), np.int32)),
            self.pool, self._dev(tables),
            self._dev(np.zeros((ccfg.max_slots,), np.int32)),
            self._dev(np.zeros((ccfg.max_slots, 1), np.float32)),
            self._plan_dev)
        next_tok.cpu()
        self._warm = True

    # ------------------------------------------------------------------ step
    def submit(self, req: ServeRequest):
        self.scheduler.submit(req)

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    def step(self, now: float, clock=None) -> StepEvents:
        """One mixed prefill+decode iteration starting at (virtual) time
        ``now``. ``clock``: optional zero-arg callable returning the
        CURRENT virtual time, so first-token / completion timestamps
        include the cost of the iteration that produced them; default:
        frozen at ``now``. Every result reaches the host before it returns.
        """
        t_wall0 = time.perf_counter()
        clock = clock or (lambda: now)
        ccfg = self.ccfg
        sched = self.scheduler
        events = StepEvents(now=now)
        iter_counts = None
        prefill_tokens = 0
        step_args = {"iteration": self.iterations}
        if self.name:
            step_args["model"] = self.name
        step_span = self.tracer.span("step", args=step_args)
        step_span.__enter__()
        self._step_dropped = 0.0
        self._current_plan()

        with self.tracer.span("admission") as adm:
            splan: IterationPlan = sched.schedule(now)
            adm.set_args(prefills=len(splan.prefills),
                         decode_slots=len(splan.decode_slots),
                         preempted=len(splan.preempted))

        # ---------------------------------------------------------- prefill
        for req in splan.prefills:
            with self.tracer.span("prefill", args={
                    "rid": req.rid, "prompt_len": req.prompt_len}):
                slot = req.slot
                S = ccfg.prefill_len
                toks = np.zeros((1, S), np.int32)
                toks[0, :req.prompt_len] = req.tokens[:S]
                tw = np.zeros((1, S), np.float32)
                tw[0, :req.prompt_len] = 1.0
                next_tok, _, temp, stats = self._prefill_fn(
                    self.model, self._dev(toks), self._temp_cache,
                    self._dev([req.prompt_len - 1]), self._dev(tw),
                    self._plan_dev)
                write_prefill_blocks(
                    self.pool, temp,
                    sched.tables.tables[slot, :S // ccfg.block_size])
                tok0 = int(next_tok[0, 0])
                req.generated.append(tok0)
                req.t_first_token = clock()
                self._last_tokens[slot] = tok0
                prefill_tokens += req.prompt_len
                iter_counts = self._accumulate(iter_counts, stats)
                events.prefilled.append(req)

        # ----------------------------------------------------------- finish
        # (requests whose whole budget was one token, or whose first token
        # already hit EOS, never reach decode)
        for slot in list(sched.active_slots):
            self._maybe_finish(slot, clock(), events)

        # ----------------------------------------------------------- decode
        sched.ensure_decode_capacity(splan)
        events.preempted = splan.preempted
        decode_slots = [s for s in splan.decode_slots
                        if sched.slots[s] is not None]
        attn_live = attn_alloc = 0.0
        if decode_slots:
            # attention work of this decode iteration, from the
            # PRE-increment lengths the kernel sees: a gather over the
            # tables covers every allocated column (max_slots x tbl_m
            # blocks); the fused kernel reads only live blocks
            bs = ccfg.block_size
            tbl_m = sched.tables.tables.shape[1]
            cl = sched.tables.lengths.astype(np.int64) + 1
            starts = np.arange(tbl_m, dtype=np.int64)[None, :] * bs
            live = starts < cl[:, None]
            if self.cfg.sliding_window > 0:
                live &= starts + bs > cl[:, None] - self.cfg.sliding_window
            attn_live = float(live.sum())
            attn_alloc = float(ccfg.max_slots * tbl_m)
            active = np.zeros((ccfg.max_slots, 1), np.float32)
            active[decode_slots] = 1.0
            with self.tracer.span("decode",
                                  args={"slots": len(decode_slots)}):
                next_tok, _, self.pool, stats = self._decode_fn(
                    self.model, self._dev(self._last_tokens[:, None]),
                    self.pool, self._dev(sched.tables.tables),
                    self._dev(sched.tables.lengths), self._dev(active),
                    self._plan_dev)
                nt = next_tok.cpu().numpy()
            self.decode_steps += 1
            for slot in decode_slots:
                req = sched.slots[slot]
                tok = int(nt[slot, 0])
                req.generated.append(tok)
                sched.tables.lengths[slot] += 1
                self._last_tokens[slot] = tok
            iter_counts = self._accumulate(iter_counts, stats)
            events.decoded_slots = len(decode_slots)
            for slot in decode_slots:
                self._maybe_finish(slot, clock(), events)

        # ---------------------------------------------------------- observe
        with self.tracer.span("observe"):
            self.iterations += 1
            if iter_counts is not None:
                self.estimator.update(iter_counts)
                self.accuracy.observe(iter_counts)
                boundary = self.iterations % self.predict_interval == 0
                if boundary:
                    # score the prediction the LAST re-plan boundary
                    # committed to against the window's realized routing
                    wa = self.accuracy.close_window()
                    if wa is not None:
                        self.metrics.record_accuracy(wa.hit_rate, wa.kl)
                        self.tracer.counter("pred_hit_rate", wa.hit_rate,
                                            track="predictor")
                        self.tracer.counter("pred_kl", wa.kl,
                                            track="predictor")
                    if self.strategy != "none":
                        self.replan()
                    self.accuracy.begin_window(
                        self.estimator.predict() if self.strategy != "none"
                        else None, self.strategy)

        if self._step_dropped:
            self.metrics.record_dropped(self._step_dropped)

        dt = clock() - now
        wall = time.perf_counter() - t_wall0
        self.metrics.record_iteration(
            now, dt, prefill_tokens=prefill_tokens,
            decode_tokens=len(decode_slots),
            counts=iter_counts, plan=self._plan_stack,
            ep_ranks=self.ep_ranks,
            dup_slots=self.moe_cfg.duplication_slots,
            strategy=self.strategy, wall_s=wall,
            attn_live_blocks=attn_live, attn_alloc_blocks=attn_alloc)
        step_span.set_args(prefills=len(splan.prefills),
                           decoded=len(decode_slots))
        step_span.__exit__()
        return events

    # ----------------------------------------------------------- internals
    def _accumulate(self, acc, stats):
        if self.ep:
            self._step_dropped += float(stats["dropped"].sum())
            sc = stats["slot_counts"].to("cpu", torch.float64).numpy()
            self.slot_counts = (sc if self.slot_counts is None
                                else self.slot_counts + sc)
        c = stats["expert_counts"].to("cpu", torch.float64).numpy()
        return c if acc is None else acc + c

    def measured_imbalance(self) -> float:
        """max / mean of the pairs each EP rank computed (from
        ``slot_counts``), averaged over layers; 1.0 before any EP step."""
        if self.slot_counts is None:
            return 1.0
        L = self.slot_counts.shape[0]
        return imbalance(self.slot_counts.reshape(L, self.ep_ranks, -1)
                         .sum(-1))

    def _maybe_finish(self, slot: int, now: float, events: StepEvents):
        req = self.scheduler.slots[slot]
        if req is None:
            return
        hit_eos = (self.ccfg.eos_id >= 0 and req.generated
                   and req.generated[-1] == self.ccfg.eos_id)
        if req.done or hit_eos:
            self.scheduler.finish_slot(slot, now)
            self.metrics.record_completion(RequestTiming(
                rid=req.rid, arrival=req.arrival,
                t_first_token=req.t_first_token, t_finished=now,
                prompt_len=req.prompt_len, new_tokens=len(req.generated),
                n_preemptions=req.n_preemptions, tenant=req.tenant))
            events.completed.append(req)

    # ------------------------------------------------------------ trace run
    def run_trace(self, requests: List[ServeRequest], *, max_iters: int = 0,
                  time_scale: float = 1.0) -> float:
        """Replay a trace on a virtual clock: each iteration costs its
        measured wall time x ``time_scale``; idle gaps fast-forward to the
        next arrival. Returns the virtual completion time."""
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        now = 0.0
        iters = 0
        while self.has_work():
            if (not self.scheduler.active_slots and self.scheduler.waiting
                    and self.scheduler.waiting[0].arrival > now):
                now = self.scheduler.waiting[0].arrival
            t0 = time.perf_counter()
            start = now
            self.step(start, clock=lambda: start + (
                time.perf_counter() - t0) * time_scale)
            now = start + (time.perf_counter() - t0) * time_scale
            iters += 1
            if max_iters and iters >= max_iters:
                break
        self.metrics.flush(self._plan_stack, self.ep_ranks,
                           self.moe_cfg.duplication_slots)
        return now
