"""Serving engines with the paper's predict -> plan -> dispatch loop.

``ServeEngine`` (the port of the JAX package's ``ServeEngine``) serves one
padded batch at a time: a batched prefill, then greedy decode at one
position for the whole batch over the prefill's cache. It serves every
family the port has (MoE, dense, hybrid, ssm, audio, vlm; a VLM's batch
may carry patch embeddings, ``prefix_embeds``, placed before its
prompts), and is the only engine for
hybrid (Griffin) and RWKV models and for MLA (deepseek-v2-lite-16b: its
latent cache is linear, and the paged pool is GQA's, as in the JAX
package). A model without MoE (the dense family: qwen1.5-0.5b, olmo-1b,
stablelm-3b, minicpm-2b; Griffin; RWKV) has nothing to estimate, plan or
move: both engines skip the estimator, re-plans, the replica store, the
lever's quotas and the controller for it, where the JAX engines skip
them, and ``ep=True`` or a controller raises on it.
Without ``ep``, MoE models take the single-device dense path (the JAX
engine without a mesh): the estimator, the accuracy window and Algorithm
1 re-plan on the interval, a new plan replaces the old one at once, and
Token-to-Expert predictions reach a prefill that ignores them. With
``ep=True`` (the JAX engine on a mesh) the MoE layers run the EP dispatch
under the plan in force, and the engine runs the JAX engine's meshed half:
the replica store (``MoEConfig.replica_impl="store"``), whose diff is
filled on a side CUDA stream either layer-staged under the following steps
(``MoEConfig.overlap_migration``; the chunk budget fits the modelled
A100-PCIe wire time to the recent migration-free prefill wall) or at
once; the lever (``ServeConfig.lever``: "reschedule" freezes the first
adopted plan and only refreshes the quotas, "both" re-plans and refreshes,
each prefill and decode dispatching through the quotas); Token-to-Expert
predictions, which the EP prefill dispatches on with a correction round;
and in-graph re-planning (``in_graph_replan`` under ``dist_only``): the
prefill step runs Algorithm 1 on the device on its own expert counts
(``train.steps.make_prefill_replan_step``), and that plan stays on the
device as the next batch's plan; it reads the home experts (no store). A
batch's ``history`` entry records its skew, dropped and overflowed pairs,
the lever's predicted absorption and residual, and each re-plan's
migration entries and bytes. With a tracer on, its ``prefill`` and
``decode`` spans end after the device has finished the step (one
``torch.cuda.synchronize`` each), so they read as step times; with the
null tracer nothing synchronises.

``ContinuousEngine`` is the port of the JAX package's
``ContinuousEngine`` as it runs without a mesh, for the uniform-stack GQA
models: the MoE models, the dense family and the VLM backbone, which it
serves text only (its requests carry tokens alone, as the JAX engine's
do).

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
leading tensor dimension on one device (or, given ``mesh=``, a
``launch.mesh.Mesh``, as one rank a process: each process builds the
engine on its rank's model and runs the same host logic on the same
global numbers, wall-clock readings agreed through ``agree``, so every
rank plans, admits and migrates alike; both engines), and the live plan
decides which
slot each (token, k) pair goes to, which pairs are dropped at capacity and
which weights each replica slot computes with. The plan moves to the
device once per plan swap. Dropped pairs are counted per iteration into
``ServeMetrics`` (``dropped_tokens``). Without ``ep`` (the default) the
layers run the exact dense path and ``ep_ranks`` only sizes the plan and
the modelled per-rank imbalance.

Replica weights (``repro_torch.runtime``), as the JAX engine runs them on a
mesh: under ``ep`` with ``MoEConfig.replica_impl="store"`` (the default)
and replica slots, the engine keeps a ``ReplicaStore`` whose rows the
replica slots read, and a re-plan moves weights only for the slots whose
expert changes: serve -> diff -> chunked fill of back rows on a side CUDA
stream -> swap. With overlapped migration (the default) fills are staged
per layer under a compute-time-aware chunk budget, each layer adopts the
target plan once its fill has landed, and the engine pre-begins a
migration toward the predicted plan ``prefetch_lead`` iterations before
the re-plan boundary (cancelled on misprediction). ``migration_gate``
rejects re-plans whose exposed modelled stall exceeds the predicted
imbalance gain. Without a store (``ep=False``, or
``replica_impl="gather"``) a new plan replaces the old one at once, and its
diff is still costed (``migration_*`` metrics), as the JAX engine does
without a mesh. The stall is modelled on the attached controller's
``ControllerConfig.hardware``, else on ``core.simulator.A100_PCIE``'s link
(the paper's deployment, the JAX engine's fallback); it is not measured.

An attached ``OnlineGPSController`` (``controller=``) reads every
iteration's expert histogram, the replica bytes the iteration moved and
the share of them hidden under forward compute, and the pairs dropped at
capacity. When a window closes it re-runs MoE-GPS on the window's skew;
the engine then adopts the verdict's strategy through ``replan()`` (a
switch to "none" adopts the identity plan and cancels an in-flight fill)
and its ``predict_interval``.

Token-to-Expert (``strategy="token_to_expert"`` with a ``predictor``, one
of ``core.predictors``' ladder): every admitted prompt is predicted (the
top-1 expert broadcast over k) before its prefill, which under ``ep``
dispatches on the predictions and corrects the mispredicted pairs in a
second round (``moe.dispatch.ep_moe_ffn``). The predicted histograms, an
EMA at ``ccfg.ema``, are the predicted next-window distribution the
prefetcher plans toward and the accuracy window scores; the boundary
re-plan still plans from the estimator, as the JAX engine does. Without a
predictor the strategy runs as ``dist_only`` does. A controller with
``predictor_available=True`` may switch the engine in and out of it.

Token rescheduling (``ContinuousConfig.lever``, the second balancing
lever; ``repro_torch.schedule``): under "reschedule" or "both" every
re-plan also turns the estimator's distribution into per-copy quotas
(``resched_impl`` "greedy" or "lp") against the plan in force, and every
forward picks replicas through them; under ``ep`` the pairs that overflow
their slot get a rescue dispatch round to an alternate copy.
"reschedule" adopts one plan and then freezes it (later boundaries only
refresh the quotas); "both" re-plans and refreshes every time. The
overflow, the rescue round's drops and its modelled a2a bytes go to
``ServeMetrics`` (``overflow_tokens``, ``overflow_absorbed_frac``,
``resched_*``) and to the controller, whose verdicts may switch the lever
when its ``levers`` offer more than "duplicate".

Phase profiling (``profile_phases``): the paged decode ``attn`` kernel at
this deployment's pool and table shapes, the dispatch phases (route /
pack / a2a / ffn / combine, ``moe.profile``) at its prefill bucket or a
given token count, and the ``migrate`` / ``prefetch`` cost of one fill
chunk when duplication is on. The breakdown lands in ``ServeMetrics``'
``phase_*_us`` columns and as retrospective spans on the tracer's
"dispatch-profile" track; its ``total`` is the overlap window's last
fallback before any step was measured.

``assert_no_recompiles`` has no counterpart: eager PyTorch does not
recompile.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.duplication import duplicate_experts_host
from repro_torch.core.placement import (PlacementPlan, clamp_dup_slots,
                                        identity_plan, quota_limited_plan,
                                        stack_plans, to_device)
from repro_torch.core.predictors import DistributionEstimator
from repro_torch.core.simulator import A100_PCIE
from repro_torch.models.transformer import (Runtime, StoreView, Transformer,
                                            init_cache, local_config)
from repro_torch.moe.dispatch import capacity
from repro_torch.obs.accuracy import PredictorAccuracyTracker
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.runtime import cost as mig_cost
from repro_torch.runtime import (LayerStagedExecutor, MigrationExecutor,
                                 ReplicaStore, make_migrate_step, migrate_all,
                                 plan_diff, plans_equal)
from repro_torch.runtime.store import EXPERT_WEIGHTS
from repro_torch.schedule import make_scheduler
from repro_torch.sharding import data_shards
from repro_torch.serve.kvcache import (BlockAllocator, init_block_pool,
                                       write_prefill_blocks)
from repro_torch.serve.metrics import (RequestTiming, ServeMetrics, imbalance,
                                       plan_rank_loads)
from repro_torch.serve.scheduler import (ContinuousScheduler, IterationPlan,
                                         ServeRequest)
from repro_torch.train.steps import (make_decode_step, make_paged_decode_step,
                                     make_prefill_replan_step,
                                     make_prefill_step, make_slot_prefill_step)

STRATEGIES = ("none", "dist_only", "token_to_expert")
LEVERS = ("duplicate", "reschedule", "both")


def _top1_over_k(pred, top_k: int, device) -> torch.Tensor:
    """(L, B, S) predicted expert labels -> (L, B, S, K) int32 on
    ``device``: the top-1 prediction broadcast over k (the paper's
    Token-to-Expert predictors predict the top-1 expert)."""
    return torch.tensor(np.asarray(pred), device=device)[..., None] \
        .repeat_interleave(top_k, dim=-1)


def _model_experts(model: Transformer) -> dict:
    """{name: [(E, ...)] * L}: the MoE layers' expert weights."""
    return {k: [getattr(layer, k) for layer in model.layers]
            for k in EXPERT_WEIGHTS}


def _entry_bytes(model: Transformer) -> int:
    """Bytes of one expert's weights, whole: where a layout splits the
    experts over "data", this rank's block's bytes times the data ranks
    (the JAX package's cost model reads its global arrays' shapes)."""
    return mig_cost.entry_bytes(_model_experts(model)) \
        * data_shards(model.layers[0].w_up)


def _clamp_store_dup_slots(cfg: ModelConfig, model: Transformer,
                           ep_ranks: int, dup_slots: int) -> int:
    """Store-aware memory clamp: shrink the requested replica slots until
    the store, in the JAX package's accounting (a second copy of the home
    experts plus the replica slots), fits the per-rank HBM budget
    (``MoEConfig.store_hbm_budget_gb``; 0 = unlimited). Callers gate on
    EP: engines without it never build a store."""
    if not (dup_slots > 0 and cfg.moe.replica_impl == "store"
            and cfg.moe.store_hbm_budget_gb > 0):
        return dup_slots
    return clamp_dup_slots(
        cfg.moe.num_experts, ep_ranks, dup_slots,
        entry_bytes=_entry_bytes(model),
        num_layers=cfg.num_layers,
        hbm_budget_bytes=cfg.moe.store_hbm_budget_gb * 1e9)


def _chunk_stall_split(moved_bytes: float, window_s: float, hw,
                       overlap: bool):
    """(hidden_s, exposed_s) of one tick's modelled wire time: overlapped
    fills hide up to one window of transfer under forward compute,
    synchronous fills expose everything."""
    stall = mig_cost.migration_stall_s(moved_bytes, hw)
    if not overlap:
        return 0.0, stall
    return mig_cost.split_hidden_exposed(stall, window_s)


class _StoreMixin:
    """Replica-store plumbing shared by ``ServeEngine`` and
    ``ContinuousEngine`` (the JAX package's ``_OverlapStoreMixin``): the
    plan in force and its device copy with the store's live rows, the view
    of the store a forward reads, beginning, cancelling and committing a
    fill, and the lever's quota stack against the plan in force. Expects
    ``cfg``, ``moe_cfg``, ``ep``, ``ep_ranks``, ``device``, ``tracer``,
    ``_overlap``, ``_plan_stack``, ``_plan_dev``, ``_store``,
    ``_executor``, ``_target_dev`` and ``_resched_sched`` on the engine."""

    def _init_store(self, model: Transformer, *, chunk: int,
                    chunks_per_tick: Optional[int] = None) -> None:
        """Build the replica store from the identity stack (the model's
        expert weights become views of its home rows) and its migrate step,
        on a side CUDA stream on the card. The executor: layer-staged with
        overlap on, else a ``MigrationExecutor`` under ``chunks_per_tick``
        (None: no executor, the engine drains each diff through
        ``migrate_all``)."""
        m = self.moe_cfg
        self._store = ReplicaStore.from_model(
            model, self._identity_stack(), num_experts=m.num_experts,
            ep_ranks=self.ep_ranks, dup_slots=m.duplication_slots,
            comm=None if self.mesh is None else self.mesh.comm)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._migrate_fn = make_migrate_step(self._store, self._stream)
        if self._overlap:
            self._executor = LayerStagedExecutor(
                self._migrate_fn, self._store, num_layers=self.cfg.num_layers,
                chunk=chunk, tracer=self.tracer, stream=self._stream)
        elif chunks_per_tick is not None:
            self._executor = MigrationExecutor(
                self._migrate_fn, self._store, chunk=chunk,
                chunks_per_tick=chunks_per_tick, tracer=self.tracer,
                stream=self._stream)

    def _check_mesh(self, mesh, model: Transformer, ep: bool,
                    ep_ranks: int) -> None:
        """A process mesh serves this process's rank of a deployment: a
        MoE model EP over the mesh's model ranks, holding its home experts
        (and, under the "specs" layout, its tensor-parallel blocks; under
        "fsdp" its data shard of each weight and of the store's rows as
        well, gathered at use); a model without MoE under its layout
        (whole but for the batch under "none"), on the mesh's device. The
        caches are the same under "fsdp" as under "specs" (this rank's
        KV heads or channels, ``models.transformer.local_config``), as the
        reference's cache specs do not depend on FSDP."""
        self.mesh = mesh
        if mesh is None:
            return
        if model.cfg.is_moe and (not ep or ep_ranks != mesh.model):
            raise ValueError(f"a {mesh.key} mesh serves EP over its "
                             f"{mesh.model} model ranks (ep=True, ep_ranks="
                             f"{mesh.model}; got ep={ep}, "
                             f"ep_ranks={ep_ranks})")
        if model.device != mesh.device:
            raise ValueError(f"the model lies on {model.device}, the mesh "
                             f"rank computes on {mesh.device}")

    def agree(self, *values: float):
        """Wall-clock readings every rank of a process mesh acts on: the
        largest over the ranks (the values themselves without a mesh), so
        admission, the overlap budget and the migration gate take the same
        branch in every process."""
        if self.mesh is None:
            return values[0] if len(values) == 1 else values
        return self.mesh.agree_max(*values)

    def _identity_stack(self) -> Optional[PlacementPlan]:
        if not self.cfg.is_moe:
            return None
        m = self.moe_cfg
        return stack_plans([
            identity_plan(m.num_experts, self.ep_ranks, m.duplication_slots,
                          m.max_copies) for _ in range(self.cfg.num_layers)])

    def _current_plan(self) -> Optional[PlacementPlan]:
        if self._plan_stack is None:
            self._set_plan(self._identity_stack())
        return self._plan_stack

    def _to_device(self, plan: PlacementPlan, rows=None):
        m = self.moe_cfg
        return to_device(plan, m.num_experts, self.ep_ranks,
                         m.duplication_slots, self.device, rows=rows)

    def _set_plan(self, plan: PlacementPlan) -> None:
        """Put ``plan`` in force (with the store's live rows under EP). A
        plan of device tensors (an in-graph plan) stays where it is."""
        self._plan_stack = plan
        if self.ep and plan is not None:
            self._plan_dev = self._to_device(
                plan, None if self._store is None else self._store.slot_rows())

    def _store_view(self) -> Optional[StoreView]:
        """What this step's forwards read of the store: its rows, and while
        a staged fill is in flight its ready mask, target plan and fill
        events (the JAX engines' ``_overlap_args``)."""
        if self._store is None:
            return None
        ex = self._executor
        if self._overlap and ex.active:
            return StoreView(self._store.weights, ex.ready_mask(),
                             self._target_dev, ex.fill_events())
        return StoreView(self._store.weights)

    def _begin_migration(self, diff, target: PlacementPlan) -> None:
        """Start (or restart, abandoning the fill in flight) a fill toward
        ``target``."""
        self._executor.begin(diff, target)
        if self._overlap:
            self._target_dev = self._to_device(target,
                                               self._executor.target_rows)

    def _cancel_migration(self) -> None:
        self._executor.cancel()
        self._target_dev = None

    def _quota_stack(self, counts: np.ndarray, tokens: int, impl: str):
        """The lever's (L, E, C_max) quota stack against the plan in force,
        for ``counts`` (L, E) expected (token, k) pairs of a forward of
        ``tokens`` tokens, the capacity a rank's share of them summed over
        the EP ranks. Returns (quota on the device, the per-layer
        ``ScheduleResult``s)."""
        m = self.moe_cfg
        plan = self._current_plan()
        if self._resched_sched is None:
            self._resched_sched = make_scheduler(impl)
        t_local = max(tokens // self.ep_ranks, 1)
        n_slots_g = (m.num_experts // self.ep_ranks
                     + m.duplication_slots) * self.ep_ranks
        cap = capacity(t_local, m.top_k, n_slots_g,
                       m.capacity_factor) * self.ep_ranks
        layer_plans = [PlacementPlan(*(np.asarray(a)[l] for a in plan))
                       for l in range(self.cfg.num_layers)]
        quota, results = self._resched_sched.plan_stack(
            counts, layer_plans, ep_ranks=self.ep_ranks,
            dup_slots=m.duplication_slots, cap=float(cap))
        return torch.tensor(np.asarray(quota), device=self.device), results

    def _commit_migration(self, commit) -> None:
        """A fill's commit: its slots swap live and back rows, and its
        target plan comes into force with the new rows."""
        filled, plan, se = commit
        self._store.adopt(se, filled)
        self._target_dev = None
        self._set_plan(plan)


# ===========================================================================
# batched engine
# ===========================================================================

@dataclass
class ServeConfig:
    """Knobs of ``ServeEngine`` (the JAX package's ``ServeConfig``). Under
    ``ep`` the replica store follows ``MoEConfig.replica_impl`` and its
    fills ``MoEConfig.overlap_migration``, as the meshed JAX engine's do;
    ``migrate_chunk`` sizes a fill's chunks. ``in_graph_replan`` plans the
    next batch on the device inside the prefill step (``dist_only`` only;
    it reads the home experts, no store). The lever's quotas reach the
    forward always; only the EP dispatch acts on them."""
    strategy: str = "dist_only"       # none | dist_only | token_to_expert
    predict_interval: int = 1         # batches between re-plans (paper Sec 3.1)
    dup_slots: int = 1                # replica slots per EP rank
    max_copies: int = 4               # Algorithm 1 C_max
    ema: float = 0.9                  # moving-average for the MLE estimator
    max_len: int = 2048               # cache length for generation
    in_graph_replan: bool = False     # fuse Algorithm 1 into the prefill
                                      # step (no host round-trip per batch)
    migrate_chunk: int = 8            # slot entries per fill chunk (store)
    # Balancing lever (repro_torch.schedule): "duplicate" re-plans and
    # migrates every interval; "reschedule" freezes the plan after its
    # first adoption and balances by moving TOKENS across the frozen
    # copies (quota dispatch + rescue round); "both" does the two.
    lever: str = "duplicate"          # duplicate | reschedule | both
    resched_impl: str = "greedy"      # greedy | lp

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy {self.strategy!r}: one of "
                             f"{STRATEGIES}")
        if self.lever not in LEVERS:
            raise ValueError(f"lever {self.lever!r}: one of {LEVERS}")


class ServeEngine(_StoreMixin):
    """Batched prefill + greedy decode with dynamic expert duplication, on
    the device the model's parameters live on; ``ep=True`` runs the MoE
    layers' expert-parallel dispatch over ``ep_ranks`` ranks."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 serve: ServeConfig, *, ep_ranks: int = 1, ep: bool = False,
                 predictor=None, tracer=None, mesh=None):
        if ep and not (cfg.is_moe and cfg.attention in ("gqa", "mla")):
            raise ValueError("ep=True serves GQA and MLA MoE models")
        self._check_mesh(mesh, model, ep, ep_ranks)
        self.serve = serve
        self.ep_ranks = ep_ranks
        self.ep = ep
        self.predictor = predictor            # Token-to-Expert model (optional)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.batches_seen = 0
        self._plan_stack: Optional[PlacementPlan] = None
        self._plan_dev = None                 # the plan in force (EP), device
        self.history: List[dict] = []         # per-batch balance telemetry
        # token rescheduling: the (L, E, C_max) quota stack on the device;
        # None while the duplicate lever runs alone
        self._resched_stack = None
        self._resched_sched = None
        self._resched_frozen = False
        self._last_prefill_tokens = 0
        self._store: Optional[ReplicaStore] = None
        self._executor = None                 # LayerStagedExecutor (overlap)
        self._target_dev = None               # an in-flight fill's target
        self._recent_step_s = 0.0             # EMA, feeds the overlap budget
        self._step_moved = False              # this call issued fill chunks
        self._window_seeded = False           # first sample skipped
        self._adopt_ticks = 0
        self._last_migration: Dict = {}
        if cfg.is_moe:
            dup_slots = serve.dup_slots if serve.strategy != "none" else 0
            if ep:
                dup_slots = _clamp_store_dup_slots(cfg, model, ep_ranks,
                                                   dup_slots)
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
        self._overlap = self._store_mode and self.moe_cfg.overlap_migration
        # without ``ep`` the MoE layers take the exact dense path, which
        # reads no placement plan, so the steps are not handed one
        self.rt = Runtime(ep=ep, ep_ranks=ep_ranks, mesh=mesh)
        self._in_graph = (serve.in_graph_replan and cfg.is_moe
                          and serve.strategy == "dist_only")
        self._prefill = (make_prefill_replan_step if self._in_graph
                         else make_prefill_step)(cfg, self.rt)
        self._decode = make_decode_step(cfg, self.rt)
        if self._store_mode:
            self._init_store(model, chunk=serve.migrate_chunk)
            self._entry_bytes = self._store.entry_bytes

    # ------------------------------------------------------------------ plan
    def replan(self) -> Optional[PlacementPlan]:
        """Algorithm 1 per layer from the current distribution estimate
        (the identity plan for dense models or strategy "none"). Returns the
        plan in force afterwards: the new one, or under overlapped
        migration the old one until the fill toward the new one commits.

        Lever "reschedule" adopts ONE plan and freezes it (later re-plans
        only refresh the token-scheduler quotas: no migration traffic);
        "both" re-plans every interval AND refreshes the quotas."""
        if not self.cfg.is_moe or self.serve.strategy == "none":
            return self._identity_stack()
        m = self.moe_cfg
        if (self.serve.lever == "reschedule" and self._resched_frozen
                and self._plan_stack is not None):
            self._replan_resched()
            return self._plan_stack
        dist = self.estimator.predict()                  # (L, E)
        self._adopt_plan(stack_plans([
            duplicate_experts_host(dist[l], self.ep_ranks,
                                   m.duplication_slots, m.max_copies).plan
            for l in range(self.cfg.num_layers)]))
        if self.serve.lever == "reschedule":
            self._resched_frozen = True
        self._replan_resched()
        return self._plan_stack

    def _replan_resched(self) -> None:
        """Refresh the (L, E, C_max) quota stack against the plan in force
        (a staged fill's target adopts later; the rescue round covers the
        transient). Counts are the last prefill's ``B * S`` tokens (1024
        before the first), the capacity a rank's share of them."""
        if (self.serve.lever == "duplicate" or not self.cfg.is_moe
                or self.serve.strategy == "none"):
            self._resched_stack = None
            return
        dist = np.asarray(self.estimator.predict(), np.float64)
        tokens = float(self._last_prefill_tokens or 1024)
        self._resched_stack, results = self._quota_stack(
            dist * tokens * self.moe_cfg.top_k, int(tokens),
            self.serve.resched_impl)
        if self.history:
            self.history[-1]["resched_absorbed_pred"] = float(np.mean(
                [r.overflow_absorbed_frac for r in results]))
            self.history[-1]["resched_residual"] = float(np.mean(
                [r.imbalance_sched for r in results])) - 1.0

    # --------------------------------------------------------- replica store
    @property
    def _store_mode(self) -> bool:
        """Replica slots read the store's rows. In-graph re-planning reads
        the home experts instead: its plan never leaves the device, and a
        migration is a host decision."""
        return (self.cfg.is_moe and self.ep
                and self.moe_cfg.duplication_slots > 0
                and self.moe_cfg.replica_impl == "store"
                and not self.serve.in_graph_replan)

    def _tick_migration(self) -> None:
        """Enqueue this step's overlapped chunk budget (on the side stream,
        under the forward that follows); swap plan and store rows on
        commit. The budget is the chunks whose modelled wire time (the
        reference's A100-PCIe link) fits the recent prefill wall."""
        ex = self._executor
        if ex is None or not ex.active:
            return
        window = self._recent_step_s
        budget = mig_cost.overlap_chunk_budget(
            window, chunk_entries=ex.chunk, entry_bytes=self._entry_bytes,
            hw=A100_PCIE)
        commit, moved = ex.tick(budget)
        self._adopt_ticks += 1
        if moved:
            self._step_moved = True
            hidden, exposed = _chunk_stall_split(moved, window, A100_PCIE,
                                                 overlap=True)
            m = self._last_migration
            m["moved_bytes"] = m.get("moved_bytes", 0.0) + moved
            m["hidden_s"] = m.get("hidden_s", 0.0) + hidden
            m["exposed_s"] = m.get("exposed_s", 0.0) + exposed
        if commit is not None:
            self._commit_migration(commit)
            self._last_migration["steps_to_adopt"] = self._adopt_ticks

    def _adopt_plan(self, target: PlacementPlan) -> None:
        """Pay weight movement once per re-plan: migrate exactly the slots
        the plan switch changes. With overlap off the diff is filled and
        committed at once; with it on a layer-staged fill begins, and
        serving reads the old plan per layer until each layer's fill is
        ready. Without a store the plan swaps at once."""
        if self._store is None:
            self.tracer.instant("plan.switch", cat="plan", track="plan",
                                args={"batch": self.batches_seen})
            self._set_plan(target)
            return
        if (self._overlap and self._executor.active
                and plans_equal(self._executor.target_plan, target)):
            # the re-plan reproduced the in-flight target: keep filling
            # (restarting would zero the cursor every batch, and a diff
            # larger than one interval's budget would never commit)
            return
        m = self.moe_cfg
        diff = plan_diff(self._current_plan(), target, self.ep_ranks,
                         m.duplication_slots)
        moved = diff.num_entries * self._entry_bytes
        self._last_migration = {"entries": diff.num_entries, "bytes": moved}
        self.tracer.instant("plan.switch", cat="plan", track="plan",
                            args={"batch": self.batches_seen,
                                  "entries": int(diff.num_entries),
                                  "bytes": float(moved)})
        if diff.num_entries == 0:
            if self._executor is not None:
                self._cancel_migration()
            self._set_plan(target)
            return
        if self._overlap:
            self._begin_migration(diff, target)
            self._adopt_ticks = 0
            return
        migrate_all(self._migrate_fn, self._store, diff,
                    chunk=self.serve.migrate_chunk, stream=self._stream)
        self._set_plan(target)

    def _step_inputs(self):
        """(plan, store view) a forward reads: under EP the plan in force
        on the device and the store's view, read after the step's tick (a
        commit swaps plan and rows together, and a new plan over
        pre-commit rows would serve replica slots holding the wrong
        expert); the dense path reads neither."""
        if not self.ep:
            return None, None
        self._current_plan()
        return self._plan_dev, self._store_view()

    # --------------------------------------------------------------- predict
    def _predict_tokens(self, tokens) -> Optional[torch.Tensor]:
        """Token-to-Expert pre-routing: (B, S) tokens -> (L, B, S, K) int32
        predicted experts on the engine's device (the top-1 prediction
        broadcast over k), or None unless that strategy runs with a
        predictor on a MoE model."""
        if (self.serve.strategy != "token_to_expert" or self.predictor is None
                or not self.cfg.is_moe):
            return None
        if torch.is_tensor(tokens):
            tokens = tokens.cpu().numpy()
        return _top1_over_k(self.predictor.predict(np.asarray(tokens)),
                            self.moe_cfg.top_k, self.device)

    # ----------------------------------------------------------------- steps
    def _sync(self):
        if self.tracer.enabled and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, batch, cache=None):
        """Prefill ``batch["tokens"]`` (B, S) (host array or tensor) into
        ``cache`` (a fresh one of ``max_len`` when None); an
        encoder-decoder's encoder runs over ``batch["frames"]`` (B, T_src,
        d_enc), whose cross K and V the cache keeps for decode; a VLM's
        ``batch["prefix_embeds"]`` (B, P, d) go before the prompts, and
        the prefill fills P + S cache positions (``max_len`` must hold them
        and the new tokens). Returns (logits (B, 1, V), cache, stats)."""
        t0 = time.perf_counter()
        pred = self._predict_tokens(batch["tokens"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        frames, prefix = (None if batch.get(k) is None else
                          torch.as_tensor(batch[k], device=self.device)
                          for k in ("frames", "prefix_embeds"))
        B, S = tokens.shape
        if cache is None:
            src = None if frames is None else frames.shape[1]
            cache = init_cache(local_config(self.model, self.cfg), self.rt,
                               B, self.serve.max_len, device=self.device,
                               source_len=src)
        self._step_moved = False
        self._tick_migration()       # overlapped fills ride this step
        plan, store = self._step_inputs()
        self._last_prefill_tokens = B * S
        if self._in_graph:
            logits, cache, stats, next_plan = self._prefill(
                self.model, tokens, cache, plan=plan, predicted_idx=pred)
            self._set_plan(next_plan)        # stays on the device
        else:
            logits, cache, stats = self._prefill(
                self.model, tokens, cache, plan=plan, predicted_idx=pred,
                store=store, resched=self._resched_stack, frames=frames,
                prefix_embeds=prefix)
        self._observe(stats, skip_replan=self._in_graph)
        self._sync()
        dt = self.agree(time.perf_counter() - t0)
        self.tracer.add_span("prefill", dt,
                             ts_ns=self.tracer.now_ns() - int(dt * 1e9),
                             args={"batch": B, "tokens": B * S})
        self._note_step_time(dt)
        return logits, cache, stats

    def decode(self, tokens, cache, cache_len: int):
        """One greedy decode step for the batch at position ``cache_len``.
        Returns (next tokens (B, 1) int32, logits, cache, stats)."""
        self._step_moved = False
        self._tick_migration()
        plan, store = self._step_inputs()
        with self.tracer.span("decode", args={"cache_len": cache_len}):
            out = self._decode(self.model, tokens, cache, cache_len,
                               plan=plan, store=store,
                               resched=self._resched_stack)
            self._sync()
        return out

    def _note_step_time(self, dt: float) -> None:
        """EMA of the MIGRATION-FREE prefill wall time: the overlap window
        the chunk budget is sized against. Steps that issued fill chunks
        are left out (their wall includes the fills), and so is the very
        first sample (it builds the kernels)."""
        if self._step_moved:
            return
        if not self._window_seeded:
            self._window_seeded = True
            return
        self._recent_step_s = (dt if self._recent_step_s <= 0
                               else 0.9 * self._recent_step_s + 0.1 * dt)

    def generate(self, batch, max_new_tokens: int = 8):
        """Prefill + greedy decode; returns (generated (B, T) int32 tensor,
        the last batch's telemetry). Decode step t runs at position S + t,
        S the prompt's length, as the JAX engine's does: with a VLM's P
        prefix embeddings the prefill filled P + S positions, so the first
        steps overwrite prefix positions (whenever S < P) and attend over
        S + t + 1 of them. ``decode`` at P + S + t is the true position."""
        S = batch["tokens"].shape[1]
        logits, cache, _ = self.prefill(batch, cache=None)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [next_tok]
        for t in range(max_new_tokens - 1):
            next_tok, _, cache, _ = self.decode(next_tok, cache, S + t)
            out.append(next_tok)
        return torch.cat(out, dim=1), self.history[-1] if self.history else {}

    # -------------------------------------------------------------- observe
    def _observe(self, stats, skip_replan: bool = False):
        """Feed router histograms to the estimator; replan on the interval
        (not after an in-graph plan: the prefill made the next one)."""
        self.batches_seen += 1
        if not self.cfg.is_moe or stats.get("expert_counts") is None:
            return
        counts = stats["expert_counts"]
        keys = [k for k in ("dropped", "overflow") if k in stats]   # EP
        # one transfer: the counts and the per-layer drop counters
        host = torch.cat([counts] + [stats[k].to(counts)[:, None]
                                     for k in keys], dim=1) \
            .to("cpu", torch.float64).numpy()
        E = counts.shape[1]
        counts = host[:, :E]
        self.estimator.update(counts)
        self.accuracy.observe(counts)
        tele = {"batch": self.batches_seen,
                "skew": float(counts.sum(0).max()
                              / max(counts.sum(0).mean(), 1e-9))}
        for i, k in enumerate(keys):
            tele[k] = float(host[:, E + i].sum())
        self.history.append(tele)
        if (not skip_replan and self.serve.strategy != "none"
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
            if self._last_migration:
                tele["migration_entries"] = self._last_migration["entries"]
                tele["migration_bytes"] = self._last_migration["bytes"]

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
    strategy: str = "dist_only"       # initial; the controller may switch it
    predict_interval: int = 4         # iterations between re-plans
    dup_slots: int = 1                # replica slots per EP rank
    max_copies: int = 4               # Algorithm 1 C_max
    ema: float = 0.9                  # estimator moving average
    eos_id: int = -1                  # -1: generate exactly max_new_tokens
    metrics_window: int = 16          # iterations per metrics window
    # Replica-weight migration (repro_torch.runtime; active when the engine
    # runs EP with dup_slots > 0 and moe.replica_impl == "store")
    migrate_chunk: int = 8            # slot entries per chunk
    migrate_chunks_per_step: int = 0  # chunks per engine iteration when
                                      # overlap is OFF (0 = drain the diff
                                      # at replan time)
    migration_gate: bool = True       # reject re-plans whose EXPOSED stall
                                      # exceeds the predicted imbalance gain
    # Overlapped migration: None inherits MoEConfig.overlap_migration. When
    # on, the chunk budget is sized to the measured non-migration step time
    # (runtime.cost), fills are layer-staged so each layer adopts the
    # moment its fill lands, and the engine PRE-BEGINS migration toward
    # the predicted next-window plan ``prefetch_lead`` iterations before
    # the re-plan boundary (cancel-on-misprediction).
    overlap_migration: Optional[bool] = None
    prefetch_lead: int = 2            # iterations before the boundary to
                                      # pre-begin (0 = no predictive start)
    # Balancing lever (repro_torch.schedule): initial; the controller may
    # switch it when ControllerConfig.levers offers more than "duplicate".
    # "reschedule" freezes the plan after its first adoption and balances
    # by moving TOKENS across the frozen copies (quota dispatch + rescue
    # round); "both" migrates on the interval AND token-schedules.
    lever: str = "duplicate"          # duplicate | reschedule | both
    resched_impl: str = "greedy"      # greedy | lp

    def __post_init__(self):
        if self.prefill_len % self.block_size:
            raise ValueError("prefill_len must be a block_size multiple")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy {self.strategy!r}: one of "
                             f"{STRATEGIES}")
        if self.lever not in LEVERS:
            raise ValueError(f"lever {self.lever!r}: one of {LEVERS}")
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
    decision: Optional[object] = None          # controller Decision, if any


class ContinuousEngine(_StoreMixin):
    """Continuous-batching serving engine over a paged KV block pool, on
    the device the model's parameters live on."""

    def __init__(self, cfg: ModelConfig, model: Transformer,
                 ccfg: ContinuousConfig, *, ep_ranks: int = 1,
                 ep: bool = False, predictor=None, controller=None,
                 tracer=None, metrics: Optional[ServeMetrics] = None,
                 name: str = "", mesh=None):
        if cfg.family in ("ssm", "hybrid") or cfg.is_encdec:
            raise ValueError(f"{cfg.family}: continuous batching serves "
                             "uniform-stack decoder-only GQA models "
                             "(ServeEngine serves the hybrid, ssm and "
                             "encoder-decoder families)")
        if cfg.attention != "gqa":
            # the JAX engine's refusal: MLA is served by ServeEngine
            raise ValueError("paged KV cache is implemented for GQA")
        if not cfg.is_moe and (ep or controller is not None):
            raise ValueError(f"{cfg.name}: ep=True and a GPS controller "
                             "need a MoE model")
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
        self._check_mesh(mesh, model, ep, ep_ranks)
        self.ccfg = ccfg
        self.ep_ranks = ep_ranks
        self.ep = ep
        self.controller = controller
        self.predictor = predictor       # Token-to-Expert model (optional)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.name = name
        self.strategy = ccfg.strategy
        self.lever = ccfg.lever
        self.predict_interval = ccfg.predict_interval
        self.iterations = 0
        self.decode_steps = 0
        self._plan_stack: Optional[PlacementPlan] = None
        self._plan_dev = None            # the live plan on the device (EP)
        # token rescheduling: the quota stack moves to the device once per
        # quota plan, as the plan does
        self._resched_enabled = (
            ccfg.lever in ("reschedule", "both")
            or (controller is not None
                and any(l != "duplicate" for l in controller.cfg.levers)))
        self._resched_stack = None       # (L, E, C_max) int32 on the device
        self._resched_sched = None       # TokenScheduler, built lazily
        self._resched_frozen = False     # "reschedule" adopted its plan
        self._resched_residual = None    # last plan's leftover imbalance
        self._resched_absorbed_pred = None  # its predicted absorption
        self._step_overflow = 0.0
        self._step_dropped = 0.0
        # (L, R * n_slots) pairs each global slot computed since the engine
        # was built (EP only): the measured per-slot, so per-rank, load
        self.slot_counts: Optional[np.ndarray] = None

        if cfg.is_moe:
            dup_slots = ccfg.dup_slots
            if ep:
                dup_slots = _clamp_store_dup_slots(cfg, model, ep_ranks,
                                                   dup_slots)
            self._overlap = (ccfg.overlap_migration
                             if ccfg.overlap_migration is not None
                             else cfg.moe.overlap_migration)
            self.moe_cfg = dataclasses.replace(
                cfg.moe, duplication_slots=dup_slots,
                max_copies=ccfg.max_copies, overlap_migration=self._overlap)
            # logical duplication quota <= the built dup_slots (see
            # set_dup_slot_quota)
            self.dup_slot_quota = dup_slots
            cfg = dataclasses.replace(cfg, moe=self.moe_cfg)
            self.estimator = DistributionEstimator(
                cfg.num_layers, cfg.moe.num_experts, ema=ccfg.ema)
            self.accuracy = PredictorAccuracyTracker(
                cfg.num_layers, cfg.moe.num_experts)
        else:
            # the dense family: no expert histogram, plan or store
            self.moe_cfg = self.estimator = self.accuracy = None
            self._overlap = False
            self.dup_slot_quota = 0
        self.cfg = cfg
        self.model = model
        self.device = model.device

        # window_override = max_len: the paged pool is linear in logical
        # positions (decode still masks to the architectural window)
        self.rt = Runtime(window_override=ccfg.max_len, ep=ep,
                          ep_ranks=ep_ranks, mesh=mesh)
        # this rank's KV heads under a tensor-parallel layout
        self.pool = init_block_pool(local_config(model, cfg),
                                    ccfg.num_blocks, ccfg.block_size,
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
        self._temp_cache = init_cache(local_config(model, cfg), self.rt, 1,
                                      ccfg.prefill_len, device=self.device)
        self._warm = False

        # ----------------------------------------------- replica-weight store
        self._store: Optional[ReplicaStore] = None
        self._executor = None
        self._target_dev = None          # an in-flight fill's target (device)
        self._recent_step_s = 0.0        # EMA over ALL steps
        # overlap window: EMA over migration-free steps, split by iteration
        # kind (runtime.cost.KindWindowEMA)
        self._serve_ema = mig_cost.KindWindowEMA()
        self._step_kind = "decode"
        self._step_migration_bytes = 0.0
        self._step_migration_hidden_bytes = 0.0
        self._prebegun_plan = None       # predictive pre-migration target
        self._pred_counts = None         # t2e predicted expert histogram EMA
        self._entry_bytes = _entry_bytes(model) if cfg.is_moe else 0
        m = self.moe_cfg
        if ep and m.duplication_slots > 0 and m.replica_impl == "store":
            self._init_store(model, chunk=ccfg.migrate_chunk,
                             chunks_per_tick=ccfg.migrate_chunks_per_step)

    def _dev(self, a) -> torch.Tensor:
        """Host array -> a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------ plan
    def replan(self) -> PlacementPlan:
        """Algorithm 1 per layer from the estimator's current prediction
        (the identity plan under strategy "none"), at most
        ``dup_slot_quota`` replica slots per rank. Returns the plan in
        force afterwards: the new one, or with a store the old one until
        the migration toward the new one commits.

        Lever: "duplicate" and "both" adopt a fresh plan every time;
        "reschedule" adopts one and then freezes it, and later calls only
        recompute the quotas. Quotas are refreshed under either
        rescheduling lever (``_replan_resched``). A model without MoE has
        no plan: None."""
        if not self.cfg.is_moe:
            return None
        m = self.moe_cfg
        if (self.strategy != "none" and self.lever == "reschedule"
                and self._resched_frozen and self._plan_stack is not None):
            self._replan_resched()
            return self._plan_stack
        if self.strategy == "none":
            plan = self._identity_stack()
        else:
            dist = self.estimator.predict()
            q = max(0, min(self.dup_slot_quota, m.duplication_slots))
            if q == m.duplication_slots:
                plans = [duplicate_experts_host(
                    dist[l], self.ep_ranks, m.duplication_slots,
                    m.max_copies).plan for l in range(self.cfg.num_layers)]
            else:
                # quota-limited: plan with only q replica slots, then rebuild
                # at the full slot geometry
                plans = [quota_limited_plan(
                    duplicate_experts_host(dist[l], self.ep_ranks, q,
                                           m.max_copies).assignments,
                    m.num_experts, self.ep_ranks, m.duplication_slots,
                    m.max_copies, quota=q)
                    for l in range(self.cfg.num_layers)]
            plan = stack_plans(plans)
        self.metrics.record_replan(int((np.asarray(plan.n_replicas) - 1).sum()))
        out = self._adopt_plan(plan)
        if self.strategy != "none" and self.lever == "reschedule":
            self._resched_frozen = True
        self._replan_resched()
        return out

    def set_dup_slot_quota(self, quota: int) -> None:
        """Cap the replica slots the planner may USE (per rank) below the
        built ``dup_slots``. Takes effect at the next re-plan: shrinking
        strands now-unused slots (zero transfer, see
        ``runtime.diff.vacated_slots``), growth migrates weights in through
        the plan diff. A model without MoE keeps its quota of 0."""
        if self.cfg.is_moe:
            self.dup_slot_quota = max(
                0, min(int(quota), self.moe_cfg.duplication_slots))

    def _replan_resched(self) -> None:
        """Recompute the (L, E, C_max) quota stack from the estimator's
        distribution against the plan currently IN FORCE (a staged
        migration's target adopts later; the rescue round covers the
        transient). Counts are the prefill bucket's (token, k) pairs, the
        capacity a prefill slot's over the EP ranks."""
        if (not self._resched_enabled or self.lever == "duplicate"
                or self.strategy == "none" or not self.cfg.is_moe):
            self._resched_stack = None
            return
        dist = np.asarray(self.estimator.predict(), np.float64)   # (L, E)
        self._resched_stack, results = self._quota_stack(
            dist * float(self.ccfg.prefill_len * self.moe_cfg.top_k),
            self.ccfg.prefill_len, self.ccfg.resched_impl)
        self._resched_residual = float(np.mean(
            [r.imbalance_sched for r in results])) - 1.0
        self._resched_absorbed_pred = float(np.mean(
            [r.overflow_absorbed_frac for r in results]))
        self.metrics.record_resched(
            planned=True, absorbed_pred=self._resched_absorbed_pred,
            residual=self._resched_residual)
        self.tracer.instant(
            "resched.plan", cat="plan", track="plan",
            args={"iteration": self.iterations,
                  "impl": self.ccfg.resched_impl,
                  "residual": self._resched_residual,
                  "absorbed_pred": self._resched_absorbed_pred})

    # ------------------------------------------------------ replica migration
    def _hw(self):
        """The hardware the migration stall is modelled on: the
        controller's deployment, else the JAX engine's fallback."""
        return self.controller.cfg.hardware if self.controller else A100_PCIE

    def _overlap_window_s(self) -> float:
        """The overlap window one engine step offers a staged fill: the
        measured NON-migration step time for the CURRENT iteration kind,
        falling back to the whole-step EMA and then to the profiled
        per-layer dispatch phase total (``profile_phases``) times the
        layers."""
        w = self._serve_ema.window(self._step_kind)
        if w > 0:
            return w
        if self._recent_step_s > 0:
            return self._recent_step_s
        per_layer = self.metrics.phase_times.get("total", 0.0)
        return per_layer * self.cfg.num_layers

    def _overlap_budget(self) -> int:
        return mig_cost.overlap_chunk_budget(
            self._overlap_window_s(), chunk_entries=self.ccfg.migrate_chunk,
            entry_bytes=max(self._entry_bytes, 1), hw=self._hw())

    def _hidden_estimate(self, stall_s: float, entries: int) -> float:
        """Predicted hidden share of a migration's stall under the overlap
        schedule: the fill drains over ``ceil(entries / (chunk * budget))``
        steps, each hiding up to one overlap window of wire time."""
        if not self._overlap or entries <= 0:
            return 0.0
        window = self._overlap_window_s()
        per_tick = max(self.ccfg.migrate_chunk * self._overlap_budget(), 1)
        drain_steps = -(-entries // per_tick)
        return min(stall_s, drain_steps * window)

    def _adopt_plan(self, target: PlacementPlan) -> PlacementPlan:
        """serve -> diff -> staged fill -> per-layer swap. Without a store
        the plan swaps at once (and the diff is still costed, so the
        store-less engines surface the plan-churn bytes an EP deployment
        would pay); with one, only changed slots are filled and each layer
        keeps serving the OLD plan until its fill is ready. A pre-begun
        migration toward this exact plan just keeps filling; toward a
        different plan it is cancelled (misprediction) and the fill
        restarts."""
        if (self._plan_stack is None or not self.cfg.is_moe
                or self.moe_cfg.duplication_slots == 0):
            self._set_plan(target)
            return target
        m = self.moe_cfg
        if (self._executor is not None and self._executor.active
                and self._prebegun_plan is not None):
            if plans_equal(target, self._prebegun_plan):
                # prediction confirmed: the transfer started early
                self._prebegun_plan = None
                self.metrics.record_migration(replanned=True)
                return self._plan_stack
            self._cancel_migration()
            self._prebegun_plan = None
            self.metrics.record_migration(cancelled=True)
        diff = plan_diff(self._plan_stack, target, self.ep_ranks,
                         m.duplication_slots)
        planned = diff.num_entries * self._entry_bytes
        stall = mig_cost.migration_stall_s(planned, self._hw())
        self.metrics.record_migration(replanned=True, planned_bytes=planned,
                                      stall_s=stall)
        self.tracer.instant(
            "plan.switch", cat="plan", track="plan",
            args={"iteration": self.iterations, "strategy": self.strategy,
                  "entries": int(diff.num_entries), "bytes": float(planned),
                  "stall_us": stall * 1e6})
        if self._store is None or diff.num_entries == 0:
            # no store to fill, or the switch moves no weights; an in-flight
            # migration toward an older target is superseded
            if self._executor is not None:
                self._cancel_migration()
            if self._store is None and planned > 0:
                # the overlap economics a store's prefetcher would produce,
                # so the controller sees the same hidden/exposed split
                hidden = self._hidden_estimate(stall, diff.num_entries)
                self.metrics.record_migration(hidden_s=hidden,
                                              exposed_s=stall - hidden)
                self._step_migration_bytes += planned
                if stall > 0:
                    self._step_migration_hidden_bytes += \
                        planned * (hidden / stall)
            self._set_plan(target)
            return target
        if not self._migration_accept(stall, target, diff.num_entries):
            # an accepted in-flight fill (if any) keeps draining toward its
            # own target
            self.metrics.record_migration(rejected=True)
            self.tracer.instant(
                "plan.reject", cat="plan", track="plan",
                args={"iteration": self.iterations,
                      "stall_us": stall * 1e6, "bytes": float(planned)})
            return self._plan_stack
        self._begin_migration(diff, target)
        if not self._overlap and self.ccfg.migrate_chunks_per_step == 0:
            self._tick_migration()              # drain + commit right away
        return self._plan_stack

    def _migration_accept(self, stall_s: float, target,
                          entries: int = 0) -> bool:
        """Hysteresis: a re-plan must repay its EXPOSED weight movement
        (total stall minus the share the overlap schedule hides under
        forward compute) with predicted imbalance gain before the next
        re-plan."""
        if not self.ccfg.migration_gate or self._recent_step_s <= 0:
            return True
        m = self.moe_cfg
        counts = self.estimator.predict()
        old = imbalance(plan_rank_loads(counts, self._plan_stack,
                                        self.ep_ranks, m.duplication_slots))
        new = imbalance(plan_rank_loads(counts, target, self.ep_ranks,
                                        m.duplication_slots))
        gain_frac = max(old - new, 0.0) / max(old, 1e-9)
        gain_s = gain_frac * max(self.predict_interval, 1) * self._recent_step_s
        return mig_cost.should_migrate(
            stall_s, gain_s, hidden_s=self._hidden_estimate(stall_s, entries))

    def _tick_migration(self) -> None:
        """Enqueue this step's migration budget (compute-time-aware when
        overlapped, the fixed chunks_per_step knob otherwise); swap plan and
        store rows on commit. The copies go to the side stream without the
        host waiting, so they run under the forward that follows."""
        if self._executor is None or not self._executor.active:
            return
        budget = self._overlap_budget() if self._overlap else None
        commit, moved = self._executor.tick(budget)
        if moved:
            self._step_migration_bytes += moved
            hidden, exposed = _chunk_stall_split(
                moved, self._overlap_window_s(), self._hw(),
                overlap=self._overlap)
            stall = hidden + exposed
            if stall > 0:
                self._step_migration_hidden_bytes += moved * (hidden / stall)
            self.metrics.record_migration(bytes_moved=moved, hidden_s=hidden,
                                          exposed_s=exposed)
        if commit is not None:
            self._commit_migration(commit)
            self._prebegun_plan = None
            self.metrics.record_migration(committed=True)

    # --------------------------------------------------------------- predict
    def _shape_predictions(self, tokens: np.ndarray):
        """(1, S) prompt -> ((L, 1, S) predicted labels, (L, 1, S, K)
        predicted experts on the device)."""
        pred = self.predictor.predict(np.asarray(tokens))
        return pred, _top1_over_k(pred, self.moe_cfg.top_k, self.device)

    def _predict_tokens(self, tokens: np.ndarray) -> Optional[torch.Tensor]:
        """The prompt's predicted experts under Token-to-Expert (noted in
        the predicted histogram), else None (always without MoE)."""
        if (self.strategy != "token_to_expert" or self.predictor is None
                or not self.cfg.is_moe):
            return None
        pred, out = self._shape_predictions(tokens)
        self._note_predicted(pred)
        return out

    def _note_predicted(self, pred: np.ndarray) -> None:
        """Publish the Token-to-Expert predictor's output as a predicted
        next-window expert histogram (an EMA at ``ccfg.ema``), available
        before dispatch."""
        E = self.moe_cfg.num_experts
        L = self.cfg.num_layers
        ids = np.clip(np.asarray(pred).reshape(L, -1), 0, E - 1)
        hist = np.stack([np.bincount(ids[l], minlength=E)
                         for l in range(L)]).astype(np.float64)
        if self._pred_counts is None:
            self._pred_counts = hist
        else:
            e = self.ccfg.ema
            self._pred_counts = e * self._pred_counts + (1 - e) * hist

    def _predicted_dist(self) -> np.ndarray:
        """(L, E) next-window hot-expert distribution, published early: the
        Token-to-Expert predictor's aggregated output when that strategy
        runs, else the Distribution-Only estimator (whose EMA state is what
        the boundary re-plan will consume). None without MoE."""
        if not self.cfg.is_moe:
            return None
        if self.strategy == "token_to_expert" and self._pred_counts is not None:
            tot = np.maximum(self._pred_counts.sum(axis=1, keepdims=True),
                             1e-9)
            return self._pred_counts / tot
        return self.estimator.predict()

    def _prebegin_migration(self) -> None:
        """Start filling replica rows toward the PREDICTED next-window plan
        while the current window is still serving; a boundary plan that
        differs cancels the stale fill."""
        if self._store is None or self._executor is None:
            return
        m = self.moe_cfg
        dist = self._predicted_dist()
        target = stack_plans([
            duplicate_experts_host(dist[l], self.ep_ranks,
                                   m.duplication_slots, m.max_copies).plan
            for l in range(self.cfg.num_layers)])
        diff = plan_diff(self._plan_stack, target, self.ep_ranks,
                         m.duplication_slots)
        if diff.num_entries == 0:
            return
        planned = diff.num_entries * self._entry_bytes
        stall = mig_cost.migration_stall_s(planned, self._hw())
        if not self._migration_accept(stall, target, diff.num_entries):
            return
        self._begin_migration(diff, target)
        self._prebegun_plan = target
        # the diff cost is accounted HERE (the boundary re-plan that
        # confirms the prediction records only the replan event)
        self.metrics.record_migration(prebegun=True, planned_bytes=planned,
                                      stall_s=stall)
        self.tracer.instant(
            "migration.prebegin", cat="migration", track="migration",
            args={"iteration": self.iterations,
                  "entries": int(diff.num_entries), "bytes": float(planned)})

    # ---------------------------------------------------------------- warmup
    def warmup(self):
        """Build the kernels (at their first launch) and run one prefill
        (and one on Token-to-Expert predictions when a predictor is
        attached) and one decode; under ``ep`` then one re-plan from the
        empty estimator, as the JAX engine's meshed warmup does. Must run
        before any request is admitted. Every warmup slot is idle, so
        nothing is written into the pool."""
        if self.scheduler.active_slots:
            raise RuntimeError("warmup() before serving")
        ccfg = self.ccfg
        self._current_plan()
        store = self._store_view()
        toks = np.zeros((1, ccfg.prefill_len), np.int32)
        preds = [None]
        if self.predictor is not None and self.cfg.is_moe:
            preds.append(self._shape_predictions(toks)[1])
        for pred in preds:
            self._prefill_fn(
                self.model, self._dev(toks), self._temp_cache,
                self._dev(np.zeros((1,), np.int32)),
                self._dev(np.zeros((1, ccfg.prefill_len), np.float32)),
                self._plan_dev, store, predicted_idx=pred)
        tables = np.zeros(
            (ccfg.max_slots, self.scheduler.tables.max_blocks_per_slot),
            np.int32)
        next_tok, _, _, _ = self._decode_fn(
            self.model, self._dev(np.zeros((ccfg.max_slots, 1), np.int32)),
            self.pool, self._dev(tables),
            self._dev(np.zeros((ccfg.max_slots,), np.int32)),
            self._dev(np.zeros((ccfg.max_slots, 1), np.float32)),
            self._plan_dev, store)
        next_tok.cpu()
        if self.ep and self.strategy != "none":
            # as the JAX engine does at the end of a meshed warmup: one
            # re-plan from the empty estimator (the identity plan), which
            # under "reschedule" is the plan that lever adopts and freezes,
            # with its quotas; none of it counts as serving activity
            self.replan()
            while self._executor is not None and self._executor.active:
                self._tick_migration()
            m = self.metrics
            m.migration = dict.fromkeys(m.migration, 0.0)
            m.resched = dict.fromkeys(m.resched, 0.0)
            m.replan_count = m.replicated_replans = 0.0
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
        self._step_overflow = 0.0
        self._step_migration_bytes = 0.0
        self._step_migration_hidden_bytes = 0.0
        self._tick_migration()       # commit BEFORE this iteration's plan read
        self._current_plan()
        store = self._store_view()
        resched = (self._resched_stack
                   if self.lever in ("reschedule", "both") else None)

        with self.tracer.span("admission") as adm:
            splan: IterationPlan = sched.schedule(now)
            adm.set_args(prefills=len(splan.prefills),
                         decode_slots=len(splan.decode_slots),
                         preempted=len(splan.preempted))
        self._step_kind = "prefill" if splan.prefills else "decode"

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
                pred = self._predict_tokens(toks)
                next_tok, _, temp, stats = self._prefill_fn(
                    self.model, self._dev(toks), self._temp_cache,
                    self._dev([req.prompt_len - 1]), self._dev(tw),
                    self._plan_dev, store, predicted_idx=pred,
                    resched=resched)
                write_prefill_blocks(
                    self.pool, temp,
                    sched.tables.tables[slot, :S // ccfg.block_size])
                tok0 = int(next_tok[0, 0])
                req.generated.append(tok0)
                req.t_first_token = clock()
                self._last_tokens[slot] = tok0
                prefill_tokens += req.prompt_len
                iter_counts = self._accumulate(iter_counts, stats,
                                               resched is not None)
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
                    self._plan_dev, store, resched=resched)
                nt = next_tok.cpu().numpy()
            self.decode_steps += 1
            for slot in decode_slots:
                req = sched.slots[slot]
                tok = int(nt[slot, 0])
                req.generated.append(tok)
                sched.tables.lengths[slot] += 1
                self._last_tokens[slot] = tok
            iter_counts = self._accumulate(iter_counts, stats,
                                           resched is not None)
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
                if self.strategy != "none" and boundary:
                    self.replan()
                elif (self._overlap and self.strategy != "none"
                      and self.ccfg.prefetch_lead > 0
                      and self._executor is not None
                      and not self._executor.active
                      and self.predict_interval > self.ccfg.prefetch_lead
                      and (self.iterations + self.ccfg.prefetch_lead)
                      % self.predict_interval == 0):
                    # the predictors publish next-window hot experts early:
                    # start moving weights toward the predicted plan now,
                    # under this window's forward compute
                    self._prebegin_migration()
                if boundary:
                    self.accuracy.begin_window(
                        self._predicted_dist() if self.strategy != "none"
                        else None, self.strategy)
            if self._step_overflow or self._step_dropped:
                # rescue-round a2a surcharge: each overflowed (token, k)
                # pair is re-sent once, its bf16 activation there and back
                self.metrics.record_resched(
                    overflow_tokens=self._step_overflow,
                    dropped_tokens=self._step_dropped,
                    extra_a2a_bytes=self._step_overflow * self.cfg.d_model
                    * 2 * 2)
            if self.controller is not None:
                events.decision = self._observe_controller(iter_counts, now)

        dt, wall = self.agree(clock() - now, time.perf_counter() - t_wall0)
        self._recent_step_s = (dt if self._recent_step_s <= 0
                               else 0.9 * self._recent_step_s + 0.1 * dt)
        if self._step_migration_bytes == 0:
            # migration-free steps calibrate the overlap window, on the
            # wall clock and per iteration kind
            self._serve_ema.update(self._step_kind, wall)
        self.metrics.record_iteration(
            now, dt, prefill_tokens=prefill_tokens,
            decode_tokens=len(decode_slots),
            counts=iter_counts, plan=self._plan_stack,
            ep_ranks=self.ep_ranks, dup_slots=self._dup_slots(),
            strategy=self.strategy, wall_s=wall,
            attn_live_blocks=attn_live, attn_alloc_blocks=attn_alloc)
        step_span.set_args(prefills=len(splan.prefills),
                           decoded=len(decode_slots))
        step_span.__exit__()
        return events

    # ----------------------------------------------------------- internals
    def _observe_controller(self, iter_counts, now: float):
        """Feed the iteration to the controller; adopt a closed window's
        verdict. Returns the Decision (None while the window is open)."""
        decision = self.controller.observe(
            iter_counts, now,
            migration_bytes=self._step_migration_bytes,
            migration_hidden_bytes=self._step_migration_hidden_bytes,
            overflow_tokens=self._step_overflow,
            dropped_tokens=self._step_dropped,
            resched_residual=self._resched_residual,
            resched_absorbed_pred=self._resched_absorbed_pred)
        if decision is None:
            return None
        self.tracer.instant(
            "gps.decision", cat="gps", track="gps",
            args={"recommended": decision.recommended,
                  "strategy": decision.strategy, "skew": decision.skew,
                  "volatility": decision.volatility,
                  "switched": decision.switched,
                  "predict_interval": decision.predict_interval})
        self.tracer.counter("skew", decision.skew, track="gps")
        if decision.switched:
            self.tracer.instant("gps.switch", cat="gps", track="gps",
                                args={"to": decision.strategy})
        self._apply_decision(decision)
        return decision

    def _apply_decision(self, decision) -> None:
        lever = decision.lever
        lever_changed = (self._resched_enabled and lever != self.lever
                         and decision.strategy != "none" and lever in LEVERS)
        if decision.strategy != self.strategy or lever_changed:
            self.strategy = decision.strategy
            if lever_changed:
                self.lever = lever
                # a fresh reschedule tenure freezes the NEXT adopted plan
                self._resched_frozen = False
            # replan() handles "none" too: the identity stack goes through
            # _adopt_plan, which cancels any in-flight fill (a direct
            # _plan_stack write would let a stale commit reinstate the
            # abandoned duplicated plan)
            self.replan()
        self.predict_interval = decision.predict_interval

    def _accumulate(self, acc, stats, resched: bool = False):
        """Add a forward's statistics to the step's: under EP its slot
        counts, drops and (with a quota) overflows in one transfer. A
        model without MoE has none: ``acc`` stays as it is."""
        if not self.cfg.is_moe:
            return acc
        if self.ep:
            sc = stats["slot_counts"]
            cols = [sc, stats["dropped"].to(sc.dtype)[:, None]]
            if resched:
                cols.append(stats["overflow"].to(sc.dtype)[:, None])
            host = torch.cat(cols, dim=1).to("cpu", torch.float64).numpy()
            S = sc.shape[1]
            self._step_dropped += float(host[:, S].sum())
            if resched:
                self._step_overflow += float(host[:, S + 1].sum())
            sc = host[:, :S]
            self.slot_counts = (sc if self.slot_counts is None
                                else self.slot_counts + sc)
        c = stats["expert_counts"].to("cpu", torch.float64).numpy()
        return c if acc is None else acc + c

    def _dup_slots(self) -> int:
        return self.moe_cfg.duplication_slots if self.moe_cfg else 0

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
    def profile_phases(self, iters: int = 3, impl: Optional[str] = None,
                       tokens: Optional[int] = None,
                       draws: Optional[dict] = None) -> Dict[str, float]:
        """Measure the per-step phase breakdown on the engine's device: the
        paged decode ``attn`` kernel at this deployment's pool and table
        shapes, the dispatch phases (route / pack / a2a / ffn / combine) at
        ``ranks = ep_ranks`` under EP (else 1), and the ``migrate`` /
        ``prefetch`` chunk-fill cost when duplication is on. ``tokens``
        picks the dispatch shape (default: the prefill bucket; pass
        ``max_slots`` for a decode-shaped profile); ``impl`` the packer
        ("sort", the path's, or the "onehot" what-if). The breakdown is
        recorded into ``metrics`` only when it profiles the path's packer
        and the phase columns are empty (a second shape must
        ``metrics.reset_phases()`` first); every profile also lands as
        retrospective spans on the tracer's "dispatch-profile" track.
        Returns seconds per phase; ``migrate`` is not part of ``total``
        (it is paid per plan switch, not per step). A model without MoE has
        the ``attn`` phase only.

        The dispatch and migration inputs are drawn before anything is
        timed (``draw_profile_inputs``). ``draws``, a dict the caller keeps
        between calls on this engine, holds them: the migration inputs do
        not depend on ``tokens``, so a second shape draws only its
        dispatch inputs, and a caller may draw every shape at once
        first."""
        if self.mesh is not None:
            raise NotImplementedError("profile_phases times one device's "
                                      "dispatch phases: a process mesh has "
                                      "no profile")
        from repro_torch.moe.profile import (ATTN_PHASE, attn_phase_times,
                                             dispatch_phase_times,
                                             migrate_phase_time)
        cfg, m, ccfg = self.cfg, self.moe_cfg, self.ccfg
        tokens = tokens or ccfg.prefill_len
        ranks = self.ep_ranks if self.ep else 1
        draws = self.draw_profile_inputs((tokens,), {} if draws is None
                                         else draws)
        phases: Dict[str, float] = {}
        if cfg.attention in ("gqa", "mixed") and cfg.num_kv_heads > 0:
            phases.update(attn_phase_times(
                batch=ccfg.max_slots, num_kv=cfg.num_kv_heads,
                gqa=max(cfg.num_heads // cfg.num_kv_heads, 1),
                head_dim=cfg.head_dim, block_size=ccfg.block_size,
                max_blocks=max(ccfg.max_len // ccfg.block_size, 1),
                window=cfg.sliding_window, impl=cfg.paged_attn_impl,
                iters=iters, device=self.device))
        if m is not None:
            phases.update(dispatch_phase_times(
                d_model=cfg.d_model, d_ff=m.d_ff_expert,
                num_experts=m.num_experts, top_k=m.top_k, tokens=tokens,
                ranks=ranks, capacity_factor=m.capacity_factor,
                impl=impl or "sort", activation=cfg.activation, iters=iters,
                device=self.device, inputs=draws[("dispatch", tokens)]))
        if m is not None and m.duplication_slots > 0:
            phases.update(migrate_phase_time(
                d_model=cfg.d_model, d_ff=m.d_ff_expert,
                num_experts=m.num_experts, ranks=ranks,
                dup_slots=m.duplication_slots, layers=cfg.num_layers,
                chunk=ccfg.migrate_chunk, iters=iters, device=self.device,
                inputs=draws["migrate"]))
        ts = None
        for k in (ATTN_PHASE, "route", "pack", "a2a", "ffn", "combine",
                  "migrate"):
            if k in phases:
                ts = self.tracer.add_span(
                    k, phases[k], ts_ns=ts, cat="dispatch",
                    track="dispatch-profile",
                    args={"impl": impl or "sort", "tokens": tokens})
        if impl in (None, "sort") and not self.metrics.phase_times:
            self.metrics.record_phases(phases)
        return phases

    def draw_profile_inputs(self, tokens, draws: dict) -> dict:
        """Draw into ``draws`` what ``profile_phases`` times and ``draws``
        lacks: the dispatch inputs at each of ``tokens`` (key ("dispatch",
        T)) and, with duplication on, the migration inputs (key
        "migrate"). Each comes from its own generator at
        ``moe.profile``'s seed 0, so the values are those of
        ``dispatch_inputs`` / ``migrate_inputs``; they are drawn at once,
        one thread each, since at full width their numpy draws are most
        of a profile's time. Returns ``draws``."""
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.moe.profile import dispatch_inputs, migrate_inputs
        cfg, m, ccfg = self.cfg, self.moe_cfg, self.ccfg
        if m is None:
            return draws
        shape = dict(d_model=cfg.d_model, d_ff=m.d_ff_expert,
                     num_experts=m.num_experts, seed=0, device=self.device)
        jobs = {("dispatch", t): (dispatch_inputs, dict(tokens=t))
                for t in tokens}
        if m.duplication_slots > 0:
            jobs["migrate"] = (migrate_inputs, dict(
                ranks=self.ep_ranks if self.ep else 1,
                dup_slots=m.duplication_slots, layers=cfg.num_layers,
                chunk=ccfg.migrate_chunk))
        jobs = {k: v for k, v in jobs.items() if k not in draws}
        if jobs:
            with ThreadPoolExecutor(len(jobs)) as pool:
                futures = {k: pool.submit(fn, **shape, **kw)
                           for k, (fn, kw) in jobs.items()}
                draws.update((k, f.result()) for k, f in futures.items())
        return draws

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
            now = start + self.agree(time.perf_counter() - t0) * time_scale
            iters += 1
            if max_iters and iters >= max_iters:
                break
        self.metrics.flush(self._plan_stack, self.ep_ranks,
                           self._dup_slots())
        return now
