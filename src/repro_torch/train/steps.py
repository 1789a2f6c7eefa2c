"""Serving step functions for the continuous engine: one-request slot
prefill and the paged decode step, each with greedy next tokens."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Runtime, Transformer, forward


def make_slot_prefill_step(cfg: ModelConfig, rt: Runtime):
    """Continuous-batching prefill: one request padded to a fixed bucket.
    Logits are taken at the request's REAL last prompt token (``last_pos``),
    and ``token_weight`` masks padding out of the MoE expert histograms."""
    @torch.inference_mode()
    def prefill_step(model: Transformer, tokens, cache=None, last_pos=None,
                     token_weight=None):
        logits, cache, stats = forward(model, cfg, tokens, rt, mode="prefill",
                                       cache=cache, last_pos=last_pos,
                                       token_weight=token_weight)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, cache, stats
    return prefill_step


def make_paged_decode_step(cfg: ModelConfig, rt: Runtime):
    """Continuous-batching decode over the paged KV block pool: every slot
    advances one token at its OWN position (``lengths``). Returns greedy
    next tokens for every slot; the engine masks idle slots."""
    @torch.inference_mode()
    def decode_step(model: Transformer, tokens, pool, block_tables, lengths,
                    token_weight=None):
        logits, pool, stats = forward(model, cfg, tokens, rt, mode="decode",
                                      cache=pool, cache_len=lengths,
                                      block_tables=block_tables,
                                      token_weight=token_weight)
        next_tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, pool, stats
    return decode_step
