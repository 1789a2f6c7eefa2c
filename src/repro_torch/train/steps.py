"""Serving step functions.

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
dispatch picks replicas through."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.duplication import duplicate_experts_device
from repro_torch.models.transformer import Runtime, Transformer, forward


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
    None). Returns (logits at the last position, cache, stats)."""
    @torch.inference_mode()
    def prefill_step(model: Transformer, tokens, cache=None, plan=None,
                     predicted_idx=None, store=None, resched=None):
        return forward(model, cfg, tokens, rt, mode="prefill", cache=cache,
                       plan=plan, store=store, predicted_idx=predicted_idx,
                       resched=resched)
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
