"""Step functions: the train step, and the serving steps.

``make_train_step`` is the port of the JAX package's: the LM loss (plus
the MoE aux and z losses) through the train-mode forward, on the
single-device MoE path or, under ``Runtime(ep=True)``, through the EP
dispatch under a placement plan stack (the JAX step's ``plan``), gradients
by autograd (through the router's, the scan's and the grouped FFN's
backward kernels on the card), optional per-layer recompute (``remat``)
and sequential microbatches, then AdamW applied in place to the model's
fp32 parameters. Under a process mesh (``Runtime(mesh=...)``, one process
a rank of a ``(data, model)`` mesh, the JAX step under a mesh) each rank
trains on its data rank's rows, the gradients are averaged over the data
axis (``make_grad_fn``), a MoE model's experts are split over the model
axis with the EP dispatch's collectives carrying their gradients, and the
clip norm sums the expert leaves over it (``sharded_norm_terms``). Under
a tensor-parallel layout (``sharding``: "specs") each rank also holds and
updates its block of the attention, recurrent and vocab leaves, whose
gradients the layers' collectives carry; under "fsdp" every weight's
shard over "data" too, gathered at use and its gradient reduce-scattered
(the data mean of a shard), so AdamW's moments are the shards'.

For the continuous engine: one-request slot prefill and the paged decode
step, each with greedy next tokens. For ``ServeEngine``: the batched
prefill, the fused prefill + in-graph re-plan, and the decode step over
the prefill's cache at one scalar position (greedy next tokens). All pass
the engine's live placement plan stack through to ``forward``, where the
EP path dispatches under it; all but the fused step also pass the
engine's replica store view (``models.transformer.StoreView``: the
store's per-layer rows and, while a staged migration is in flight, its
ready mask, target plan and fill events: the JAX package's
``slot_weights / slot_weights_back / slot_ready / target_plan``). The
prefill steps take the Token-to-Expert predictions (``predicted_idx``
(L, B, S, K)) the EP dispatch pre-routes on, and every step but the fused
one the reschedule quota stack (``resched`` (L, E, C_max) int32) the EP
dispatch picks replicas through. Under ``Runtime(decode_expert_tp=True)``
on a process mesh (the reference's way to expert TP: its engines build
their ``Runtime`` without it) the decode step runs expert TP on a model
laid out with ``bridge.sharder(..., expert_tp=True)``: each expert's F
columns stay split over "data" where they lie, while the prefill gathers
them (``models.transformer.expert_tp_decode``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.duplication import duplicate_experts_device
from repro_torch.models.transformer import (Runtime, Transformer,
                                            expert_param_names, forward)
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update_
from repro_torch.sharding import placement
from repro_torch.train.loss import lm_loss


def param_tree(model: Transformer):
    """The model's parameters as the optimizer sees them: {name (as
    ``model.named_parameters()`` gives it): parameter}."""
    return dict(model.named_parameters())


def weight_decay_mask(model: Transformer):
    """Which parameters AdamW decays, keyed like ``param_tree``: the JAX
    package decays the leaves of ndim >= 2 of its own tree, where a uniform
    stack's layer leaves carry a leading L, so there every layer parameter
    decays, the norm scales included (an encoder-decoder's encoder stack
    too); a hybrid model's layers are a list, and their vectors do not."""
    stacked = model.cfg.family != "hybrid"
    return {name: p.dim() + (stacked and name.startswith(
                ("layers.", "enc_layers."))) >= 2
            for name, p in model.named_parameters()}


def init_opt_state(model: Transformer) -> AdamWState:
    """Zero AdamW moments for ``model``'s parameters (fp32, on its device),
    keyed like ``param_tree``."""
    return adamw_init(param_tree(model))


def make_loss_fn(cfg: ModelConfig, rt: Runtime, remat: bool = False):
    """``loss_fn(model, batch, plan=None, denom=None) -> (loss, metrics)``:
    the train-mode forward over ``batch["tokens"]`` (an encoder-decoder's
    encoder over ``batch["frames"]``; a VLM's ``batch["prefix_embeds"]``
    (B, P, d) before the tokens, whose P positions carry no label and are
    sliced off the logits before the loss; under ``rt.ep`` dispatched
    under ``plan``, None the identity plan), ``lm_loss`` against
    ``batch["labels"]`` (and ``batch["loss_mask"]`` if given, divided by
    ``denom`` when one is given), plus the aux and z losses for MoE
    models, whose ``aux_loss`` and ``expert_counts`` join the metrics (the
    JAX ``make_train_step``'s inner ``loss_fn``); under ``rt.ep`` also
    ``dropped``, each layer's capacity drops."""

    def loss_fn(model: Transformer, batch, plan=None, denom=None):
        logits, _, stats = forward(model, cfg, batch["tokens"], rt,
                                   mode="train", plan=plan, remat=remat,
                                   frames=batch.get("frames"),
                                   prefix_embeds=batch.get("prefix_embeds"))
        if cfg.input_mode == "mixed" and "prefix_embeds" in batch:
            # the prefix carries no LM labels: score text positions only
            logits = logits[:, batch["prefix_embeds"].shape[1]:]
        loss, metrics = lm_loss(logits, batch["labels"],
                                batch.get("loss_mask"), denom)
        if cfg.is_moe:
            loss = loss + stats["aux_loss"] + stats["z_loss"]
            metrics["aux_loss"] = stats["aux_loss"]
            metrics["expert_counts"] = stats["expert_counts"]
        if rt.ep:
            metrics["dropped"] = stats["dropped"].float()
        return loss, metrics
    return loss_fn


# the metrics summed over the data axis; the others are averaged over it
SUMMED_METRICS = ("expert_counts", "dropped")


def make_grad_fn(cfg: ModelConfig, rt: Runtime, remat: bool = False,
                 microbatches: int = 1):
    """``grad_fn(model, batch, plan=None) -> (loss, metrics, grads)``: the
    train step's gradients, ``grads`` {name (``param_tree``'s): fp32
    gradient, zeros where none reached the parameter}, left in each
    parameter's ``.grad`` too; ``batch``, ``plan``, ``remat`` and
    ``microbatches`` as ``make_train_step`` takes them (each microbatch's
    fp32 gradients added to the running sum in order, the sum divided by
    the count; loss and metrics the microbatches' means).

    On a process mesh (``rt.mesh``) every rank is given the whole batch
    and trains on its data rank's rows (``Mesh.batch_rows``; a batch the
    data ranks do not divide whole on each), which the microbatches split.
    Every gradient is then averaged over the data axis, one collective a
    bucket (``ProcessGroupRanks.mean_``), and so are the losses, accuracy
    and aux loss, detached; the expert counts and drops are summed. Under
    a ``loss_mask`` each microbatch's loss divides by its share of the
    whole batch's mask sum over those rows, so the data ranks' mean is the
    loss of the whole microbatch, not a mean of per-rank means. The model
    axis needs nothing here: the forward's collectives carry the EP
    dispatch's gradients, every replicated parameter's gradient is whole on
    each rank, and each expert's whole on its owner."""
    loss_fn = make_loss_fn(cfg, rt, remat)
    mesh = rt.mesh

    def grad_fn(model: Transformer, batch, plan=None):
        params = param_tree(model)
        dev = model.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        B = batch["tokens"].shape[0]
        # ``rt.rows_split`` set by the caller: the batch is this rank's
        # rows already (the dry run's per-rank inputs)
        given = mesh is not None and rt.rows_split
        if given and "loss_mask" in batch:
            raise ValueError("a loss mask needs the whole batch's rows")
        rows = None if mesh is None or given else mesh.batch_rows(B)
        shards = mesh.data if given or rows is not None else 1
        mine = batch if rows is None else {k: v[rows]
                                           for k, v in batch.items()}
        b = B if given else B // shards
        if b % microbatches:
            raise ValueError(f"batch {B} over {shards} data ranks does not "
                             f"split into {microbatches} microbatches")
        n = b // microbatches
        parts = [{k: v[i * n:(i + 1) * n] for k, v in mine.items()}
                 for i in range(microbatches)] if microbatches > 1 else [mine]
        denoms = [None] * microbatches
        if shards > 1 and "loss_mask" in batch:
            # microbatch i: rows i of every data rank's rows of the batch
            m = batch["loss_mask"].float().reshape(
                shards, microbatches, -1).sum(dim=(0, 2))
            denoms = list(torch.clamp(m, min=1.0) / shards)
        for p in params.values():
            p.grad = None
        losses, mets = [], []
        for part, denom in zip(parts, denoms):
            loss, metrics = loss_fn(model, part, plan, denom)
            loss.backward()
            losses.append(loss.detach())
            mets.append({k: torch.as_tensor(v).detach()
                         for k, v in metrics.items()})
        if microbatches == 1:
            loss, metrics = losses[0], mets[0]
        else:
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mets]).mean(dim=0)
                       for k in mets[0]}
        grads = {}
        for name, p in params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = g.div_(microbatches) if microbatches > 1 else g
        if shards > 1:
            comm = mesh.data_comm
            # an FSDP shard's gradient is the data mean already
            comm.mean_([grads[k] for k in sorted(grads)
                        if not _split_over(params[k], "data")])
            means = [k for k in metrics if k not in SUMMED_METRICS]
            loss, *vals = comm.pmean_losses(
                loss.reshape(1), *(metrics[k].reshape(1) for k in means))
            metrics.update(zip(means, vals))
            sums = [k for k in SUMMED_METRICS if k in metrics]
            if sums:
                metrics.update(zip(sums, comm.psum_counts(
                    *(metrics[k][None] for k in sums))))
        return loss, metrics, grads

    return grad_fn


def _split_over(p, axis: str) -> bool:
    """Whether parameter ``p`` holds a block of a leaf split over mesh
    axis ``axis`` (its ``Placement``)."""
    rec = placement(p)
    if rec is None:
        return False
    return (rec.model_dim if axis == "model" else rec.data_dim) is not None


def sharded_norm_terms(model: Transformer, rt: Runtime):
    """``adamw_update_``'s ``reduce_sq`` for ``model`` under ``rt``: None
    in one process; on a mesh, the sum over an axis of the squared
    gradient sum of each leaf split over it (the EP rule's experts and a
    layout's blocks over "model", FSDP shards over "data"), added in rank
    order, one collective an axis, so the clip norm is the whole model's
    on every rank; a leaf whole over an axis counts once."""
    mesh = rt.mesh
    if mesh is None:
        return None
    params = param_tree(model)
    names = sorted(params)
    experts = set(expert_param_names(model)) if rt.ep else set()
    axes = []
    for axis, comm in (("model", mesh.comm), ("data", mesh.data_comm)):
        at = [i for i, n in enumerate(names)
              if _split_over(params[n], axis)
              or (axis == "model" and n in experts)]
        if comm.ranks > 1 and at:
            axes.append((comm, at))
    if not axes:
        return None

    def reduce_sq(sq):
        sq = list(sq)
        for comm, at in axes:
            whole = comm.psum_ordered(torch.stack([sq[i] for i in at]))
            for i, s in zip(at, whole.unbind()):
                sq[i] = s
        return sq
    return reduce_sq


def make_train_step(cfg: ModelConfig, rt: Runtime, lr_fn=None,
                    remat: bool = False, microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch, plan=None) ->
    (opt_state, metrics)``; the model's parameters (fp32,
    ``requires_grad``) are updated in place, and so are the state's
    moments. ``plan``: the (L, ...) placement plan stack the EP path
    dispatches under (a host ``PlacementPlan`` stack or a ``DevicePlan``;
    None: the identity plan), as the JAX step takes it; the single-device
    path ignores it.

    ``batch``: {"tokens", "labels"[, "loss_mask"]}, (B, S) tensors or numpy
    arrays, and for an encoder-decoder "frames" (B, T_src, d_enc), for a
    VLM "prefix_embeds" (B, P, d) (microbatches split it as the rest).
    ``lr_fn(step)``: the learning rate at the state's step
    (default 3e-4). ``remat``: each layer recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant; the values are the plain
    step's). ``microbatches``: the batch split into that many sequential
    microbatches (``make_grad_fn``). Metrics: loss, nll, accuracy,
    grad_norm, lr, and for MoE aux_loss and expert_counts (L, E). Weight
    decay falls where the JAX step's does (``weight_decay_mask``). Under
    ``rt.ep`` the metrics also hold ``dropped`` (L,) fp32, the pairs each
    layer dropped at capacity (the microbatches' mean, as every metric).

    On a process mesh (``rt.mesh``: one rank a process, ``launch.mesh``)
    each rank takes the whole batch and trains on its data rank's rows,
    with the gradients and metrics reduced over the data axis
    (``make_grad_fn``); a MoE model trains through the EP dispatch over the
    model axis, each rank holding its block of the experts and their
    moments, the clip norm the whole model's (``sharded_norm_terms``).
    Under a tensor-parallel layout ("specs", "fsdp") each rank computes
    and updates its blocks of every split leaf; without one a model
    without MoE trains data-parallel, its model ranks repeating their
    data rank's work. Every replicated parameter stays the same bits
    on every rank: the replicated computation and its backward run alike
    on each, and the gradients they are given are summed alike."""
    grad_fn = make_grad_fn(cfg, rt, remat, microbatches)
    lr_fn = lr_fn or (lambda s: 3e-4)

    def train_step(model: Transformer, opt_state: AdamWState, batch,
                   plan=None):
        params, decay = param_tree(model), weight_decay_mask(model)
        loss, metrics, grads = grad_fn(model, batch, plan)
        lr = lr_fn(opt_state.step)
        opt_state, gnorm = adamw_update_(
            params, grads, opt_state, lr, decay=decay,
            reduce_sq=sharded_norm_terms(model, rt))
        for p in params.values():
            p.grad = None
        return opt_state, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return train_step


def make_slot_prefill_step(cfg: ModelConfig, rt: Runtime):
    """Continuous-batching prefill: one request padded to a fixed bucket.
    Logits are taken at the request's REAL last prompt token (``last_pos``),
    and ``token_weight`` masks padding out of the MoE expert histograms."""
    @torch.inference_mode()
    def prefill_step(model: Transformer, tokens, cache=None, last_pos=None,
                     token_weight=None, plan=None, store=None,
                     predicted_idx=None, resched=None):
        logits, cache, stats = forward(model, cfg, tokens, rt, mode="prefill",
                                       cache=cache, last_pos=last_pos,
                                       token_weight=token_weight, plan=plan,
                                       store=store,
                                       predicted_idx=predicted_idx,
                                       resched=resched)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, cache, stats
    return prefill_step


def make_paged_decode_step(cfg: ModelConfig, rt: Runtime):
    """Continuous-batching decode over the paged KV block pool: every slot
    advances one token at its OWN position (``lengths``). Returns greedy
    next tokens for every slot; the engine masks idle slots."""
    @torch.inference_mode()
    def decode_step(model: Transformer, tokens, pool, block_tables, lengths,
                    token_weight=None, plan=None, store=None,
                    resched=None):
        logits, pool, stats = forward(model, cfg, tokens, rt, mode="decode",
                                      cache=pool, cache_len=lengths,
                                      block_tables=block_tables,
                                      token_weight=token_weight, plan=plan,
                                      store=store, resched=resched)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, pool, stats
    return decode_step


def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    """Batched prefill of (B, S) prompts into ``cache`` (a fresh one when
    None), an encoder-decoder's encoder over ``frames``, a VLM's
    ``prefix_embeds`` (B, P, d) before the prompts (P + S cache
    positions). Returns (logits at the last position, cache, stats)."""
    @torch.inference_mode()
    def prefill_step(model: Transformer, tokens, cache=None, plan=None,
                     predicted_idx=None, store=None, resched=None,
                     frames=None, prefix_embeds=None):
        return forward(model, cfg, tokens, rt, mode="prefill", cache=cache,
                       plan=plan, store=store, predicted_idx=predicted_idx,
                       resched=resched, frames=frames,
                       prefix_embeds=prefix_embeds)
    return prefill_step


def make_prefill_replan_step(cfg: ModelConfig, rt: Runtime):
    """Fused predict -> plan -> dispatch serving step: the prefill under
    the CURRENT placement plan, then the NEXT batch's plan from this
    batch's expert histogram by Algorithm 1 on the device
    (``duplicate_experts_device``, every layer at once), with no host
    round-trip. Returns (logits, cache, stats, next plan: a PlacementPlan
    of (L, ...) int32 tensors on the model's device).

    It reads the home experts (no store): the replica store is filled by a
    host-orchestrated migration, which would defeat planning on the
    device."""
    moe = cfg.moe

    @torch.inference_mode()
    def step(model: Transformer, tokens, cache=None, plan=None,
             predicted_idx=None):
        logits, cache, stats = forward(model, cfg, tokens, rt,
                                       mode="prefill", cache=cache,
                                       plan=plan,
                                       predicted_idx=predicted_idx)
        next_plan = duplicate_experts_device(
            stats["expert_counts"], rt.ep_ranks, moe.duplication_slots,
            moe.max_copies)
        return logits, cache, stats, next_plan
    return step


def make_decode_step(cfg: ModelConfig, rt: Runtime):
    """One decode step for the whole batch at position ``cache_len`` (an
    int: the length before this token) over the prefill's cache. Returns
    (greedy next tokens (B, 1) int32, logits, cache, stats)."""
    @torch.inference_mode()
    def decode_step(model: Transformer, tokens, cache, cache_len: int,
                    plan=None, store=None, resched=None):
        logits, cache, stats = forward(model, cfg, tokens, rt, mode="decode",
                                       cache=cache, cache_len=cache_len,
                                       plan=plan, store=store,
                                       resched=resched)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, cache, stats
    return decode_step
