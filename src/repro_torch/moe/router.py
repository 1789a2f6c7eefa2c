"""Top-k MoE router with load-balance auxiliary loss and router z-loss
(the JAX package's ``moe/router.py``), on the ``fused_topk_route``
kernel and its backward."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import ops as kernel_ops


class RouterOutput(NamedTuple):
    expert_idx: torch.Tensor    # (T, K) int32
    gates: torch.Tensor         # (T, K) float32 (normalised over K)
    probs: torch.Tensor         # (T, E) full softmax (for aux losses / stats)
    aux_loss: torch.Tensor      # scalar
    z_loss: torch.Tensor        # scalar


def route(w_router, moe: MoEConfig, x) -> RouterOutput:
    """x: (T, d) token-major, or (R, T, d): R independent batches (the EP
    ranks) routed in one call, each with its own losses, so every field
    gains the leading R and the losses have shape (R,). Logits are fp32:
    both x and the router weight are upcast.

    The fused softmax / top-k / histogram kernel
    (``kernels.ops.fused_topk_route``, ties to the lowest index as
    ``lax.top_k``) routes every row, and the losses come from its counts
    and logsumexp, as in the JAX package's ``route(impl="fused")``.
    Gradients reach ``x`` and the router weight through the gates, the
    aux loss (through ``probs``) and the z loss (through the logsumexp),
    as ``jax.grad`` takes them through the JAX package's dense ``route``:
    ``kernels.ops.FusedTopkRoute`` runs the backward kernel."""
    logits = torch.matmul(x.float(), w_router.float())
    batched = logits.dim() == 3
    lg = logits if batched else logits[None]
    # without a graph to record (serving), the wrapper alone: a Function's
    # apply adds microseconds of host work to every call of a host-bound
    # decode step
    fn = (kernel_ops.FusedTopkRoute.apply if torch.is_grad_enabled()
          else kernel_ops.fused_topk_route)
    expert_idx, gates, probs, lse, counts = fn(lg.contiguous(), moe.top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = counts.float() / (expert_idx.shape[-2] * expert_idx.shape[-1])
    aux = (moe.num_experts * torch.sum(f * probs.mean(dim=-2), dim=-1)
           * moe.router_aux_loss)
    z = torch.mean(lse.square(), dim=-1) * moe.router_z_loss
    out = RouterOutput(expert_idx, gates, probs, aux, z)
    return out if batched else RouterOutput(*(t[0] for t in out))


def expert_histogram(expert_idx, num_experts: int, weight=None):
    """Token counts per expert. expert_idx: (..., K) -> (E,) float32.
    ``weight``: optional per-(token, k) weight of the same shape."""
    idx = expert_idx.reshape(-1).long()
    w = (torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
         if weight is None else weight.reshape(-1).float())
    return torch.zeros((num_experts,), dtype=torch.float32,
                       device=idx.device).index_add_(0, idx, w)
