"""Top-k MoE router with load-balance auxiliary loss and router z-loss
(the dense path of the JAX package's ``moe/router.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig


class RouterOutput(NamedTuple):
    expert_idx: torch.Tensor    # (T, K) int32
    gates: torch.Tensor         # (T, K) float32 (normalised over K)
    probs: torch.Tensor         # (T, E) full softmax (for aux losses / stats)
    aux_loss: torch.Tensor      # scalar
    z_loss: torch.Tensor        # scalar


def top_k_lowest_index(probs, k: int):
    """(values, indices) of the k largest entries per row, ties going to
    the LOWEST index as ``lax.top_k`` does: k rounds of argmax (which
    returns the first maximum), masking each winner before the next."""
    work = probs.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmax(work, dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idxs.append(i)
        work.scatter_(-1, i, float("-inf"))
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def route(w_router, moe: MoEConfig, x) -> RouterOutput:
    """x: (T, d) token-major. Returns the top-k assignment and losses.
    Logits are fp32: both x and the router weight are upcast."""
    logits = torch.matmul(x.float(), w_router.float())
    E = moe.num_experts
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = top_k_lowest_index(probs, moe.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.full((expert_idx.numel(),), 1.0 / expert_idx.numel(),
                   dtype=torch.float32, device=x.device))
    p_mean = probs.mean(dim=0)
    aux = E * torch.sum(f * p_mean) * moe.router_aux_loss
    z = torch.mean(torch.logsumexp(logits, dim=-1).square()) * moe.router_z_loss
    return RouterOutput(expert_idx.to(torch.int32), gates, probs, aux, z)


def expert_histogram(expert_idx, num_experts: int, weight=None):
    """Token counts per expert. expert_idx: (..., K) -> (E,) float32.
    ``weight``: optional per-(token, k) weight of the same shape."""
    idx = expert_idx.reshape(-1).long()
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weight is None else weight.reshape(-1).float())
    return torch.zeros((num_experts,), dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, w)
